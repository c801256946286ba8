"""The first float32 detection step of ``Latin.py``'s architecture
(deformable encoder and decoder cross-attention, FrozenBN ResNet-50) at
the tiny geometry against JAX's, as test_torch_detection_step.py holds
the flagship's. The gradients reach the sampling locations through the
bilinear weights: ``grid_sample``'s here, JAX's differentiation of its
own ``floor`` and ``take_along_axis`` formulation there. The weights
and architectures are test_torch_deform_model.py's.
"""

import jax
import numpy as np

import test_torch_detection_step as D
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.train.checkpoints import params_to_flax
from dtlr_tpu_torch.train.train_step import make_detection_train_step
from dtlr_tpu_torch.weights import load_into
from test_torch_deform_model import jax_model, port_cfg, seeded_params
from test_torch_grad_stops import BACKBONE_TOL, CHAOTIC, TOL as GRAD_TOL, flat
from test_torch_model import NUM_CLASSES, TINY
def test_first_detection_step_of_latin_matches_jax():
    """Latin.py's architecture at TINY with contrastive denoising (zero
    noise, scipy matcher, test_torch_detection_step.py's set-up): the
    loss and every term at 1e-5 relative; the global gradient norm and
    each leaf's gradient norm at test_torch_grad_stops.py's tolerances
    (2e-3 relative, 5e-2 for the backbone and the input projections'
    convolutions, whose gradients through a random backbone are float
    noise amplified); the gradients of the sampling offsets and attention
    weights (through the bilinear weights into the locations) and of the
    frozen statistics non-zero on both sides."""
    dn = dict(use_dn=True, dn_number=D.DN_NUMBER, dn_box_noise_scale=0.0,
              dn_label_noise_ratio=0.0)
    params = seeded_params("latin")
    b = D.batches(1)[0]
    jmodel = jax_model("latin", max_targets=D.N_TARGETS, **dn)
    with D.jax_matcher_without_gradient():
        (jtotal, jterms), jgrads = jax.jit(jax.value_and_grad(D.jax_loss_fn(jmodel),
                                                              has_aux=True))(params, b)
    model = build_dino(port_cfg("latin", **dn), NUM_CLASSES, device="cpu")
    load_into(model, params)
    model.train()
    step = make_detection_train_step(NUM_CLASSES, D.WEIGHTS, matcher_impl="scipy")
    total, terms = step.loss_fn(model, D.to_torch(b))
    total.backward()
    grads = params_to_flax({n: p.grad for n, p in model.named_parameters()}, TINY.nheads)
    want = flat(jgrads)

    assert set(terms) == set(jterms) and "loss_ce_dn" in terms
    for k, w in jterms.items():
        assert abs(float(terms[k].detach()) - float(w)) <= D.LOSS_REL * max(abs(float(w)), 1e-6), k
    assert abs(float(total.detach()) - float(jtotal)) <= D.LOSS_REL * abs(float(jtotal))
    assert set(grads) == set(want)
    norm = lambda tree: float(np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                                          for x in tree.values())))
    assert abs(norm(grads) - norm(want)) <= GRAD_TOL * norm(want)
    bad = []
    for k, w in want.items():
        tol = BACKBONE_TOL if k.startswith(CHAOTIC) else GRAD_TOL
        g, w = float(np.linalg.norm(grads[k])), float(np.linalg.norm(w))
        if not abs(g - w) <= tol * max(w, 1e-6 * norm(want)):
            bad.append((k, g, w))
    assert not bad, bad[:10]
    for k in want:
        if "sampling_offsets" in k or "attention_weights" in k or "FrozenBatchNorm" in k:
            assert np.abs(want[k]).max() > 0 and np.abs(grads[k]).max() > 0, k
