"""The port's CTC train step (dtlr_tpu_torch/train/train_step.py) against
dtlr_tpu's ``make_ctc_train_step`` at the tiny geometry (``TINY``).

Both sides start from the same weights (``trained_backbone_params`` of
test_torch_grad_stops.py: the flagship's trained ResNet-50, the flax
init with seeded noise elsewhere), take the same two batches of 128x256
crops of the fixture lines with seeded labels, and use the recipe's
full-model optimizer (lr 1e-5, backbone 1e-10, clip 0.01, weight decay
1e-4) with EMA on (decay 0.9997, warmed). Tolerances, float32: the loss
of each step within 1e-5 relative (measured 3.7e-7), every parameter and
every EMA parameter after two steps within 1e-6 absolute (measured
1.5e-7 and 4.8e-7; the steps move parameters by up to 2.0e-5). Adam
moves a parameter by about lr whatever its gradient's size, so where a
gradient is float noise (random weights at 64x128 make the backbone's
so, see test_torch_grad_stops.py) the two packages step in different
directions; the trained backbone and real lines keep every gradient
clear of that.

The NaN-skip: after a NaN loss the parameters stay bit for bit, the
count advances, and the moments decay by b1 and b2 as optax's do on
zeroed gradients (relative 1e-6), as JAX's skip branch replayed on JAX's
state shows them to.

bfloat16: one port step at ``TINY`` in the recipe's bf16 against JAX's
bf16 loss on the same weights and lines. bf16 scores tie in the
two-stage top-k, the two packages round a few values differently, and
the selected proposals and with them the loss move: relative 5e-2
(measured 1.1e-2; the float32 losses of the two packages agree to 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtlr_tpu.train import optim as jax_optim
from dtlr_tpu.train.train_step import _warmed_decay as jax_warmed_decay
from dtlr_tpu.train.train_step import init_train_state as jax_init_train_state
from dtlr_tpu.train.train_step import make_ctc_train_step as jax_make_ctc_train_step
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.ops.pixels import prep_images
from dtlr_tpu_torch.train import optim
from dtlr_tpu_torch.train.checkpoints import params_to_flax
from dtlr_tpu_torch.train.config import RECIPE
from dtlr_tpu_torch.train.train_step import (_warmed_decay, init_train_state,
                                             make_ctc_train_step)
from dtlr_tpu_torch.eval.evaluate import load_lines
from dtlr_tpu_torch.weights import load_into
from test_torch_smoke_fixture import FIXTURE
from test_torch_dtype import BF16, jax_recipe
from test_torch_grad_stops import flat, trained_backbone_params
from test_torch_model import NUM_CLASSES, TINY, jax_tiny
from test_torch_optim import JaxCfg

LOSS_REL, PARAM_TOL, BF16_LOSS_REL = 1e-5, 1e-6, 5e-2
CFG = dataclasses.replace(RECIPE, use_ema=True)
N_LABELS = 6


def batches(n=2, seed=10):
    """128x256 crops of the committed fixture lines (ragged valid sizes),
    normalized on the host so that every batch has one dtype (one JAX
    compile serves them all), and seeded padded labels."""
    lines = load_lines(FIXTURE)
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        pick = rng.choice(len(lines["texts"]), 2, replace=False)
        x0 = int(rng.integers(0, 256))
        images = np.ascontiguousarray(lines["images"][pick, :, x0:x0 + 256])
        valid_hw = np.asarray([[128, 256], [100, 186]], np.int32)
        labels = rng.integers(0, NUM_CLASSES, (2, N_LABELS)).astype(np.int32)
        valid = np.zeros((2, N_LABELS), bool)
        valid[0, :4] = True
        valid[1, :6] = True
        out.append({"images": prep_images(torch.from_numpy(images),
                                          torch.from_numpy(valid_hw)).numpy(),
                    "valid_hw": valid_hw, "labels": labels, "valid": valid})
    return out


def jax_state_flat(tree):
    """A nested flax tree -> flat ``params/...`` keys (MaskedNode leaves
    dropped)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif not isinstance(node, optax.MaskedNode):
            out[prefix] = np.asarray(node, np.float32)

    walk(tree, "")
    return out


def jax_moments(opt_state):
    """mu and nu of every trained leaf, from all groups' Adam states."""
    from test_torch_optim import adam_states

    mu, nu = {}, {}
    for adam in adam_states(opt_state).values():
        mu.update(jax_state_flat(adam.mu))
        nu.update(jax_state_flat(adam.nu))
    return mu, nu


def run_jax(params, steps, jax_step):
    tx, step = jax_step
    state = jax_init_train_state(params, tx, use_ema=True)
    metrics = []
    for b in steps:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def port_state(params, dtype_cfg=TINY):
    model = build_dino(dtype_cfg, NUM_CLASSES, device="cpu")
    load_into(model, params)
    named = dict(model.named_parameters())
    return init_train_state(model, optim.build_optimizer(CFG, named), use_ema=True)


def run_port(params, steps, dtype_cfg=TINY):
    state = port_state(params, dtype_cfg)
    step = make_ctc_train_step(ctc_eps=CFG.ctc_eps, ema_decay=CFG.ema_decay)
    metrics = []
    for b in steps:
        state, m = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def port_params_flax(state):
    return params_to_flax(dict(state.model.named_parameters()))


@pytest.fixture(scope="module")
def setup():
    return trained_backbone_params()


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX step, jitted once for the module: the recipe's optimizer,
    EMA on."""
    tx = jax_optim.build_optimizer(JaxCfg(CFG), setup)
    return tx, jax_make_ctc_train_step(jax_tiny(False).apply, tx, ctc_eps=CFG.ctc_eps,
                                       ema_decay=CFG.ema_decay)


@pytest.fixture(scope="module")
def two_steps(setup, jax_step):
    steps = batches()
    return run_jax(setup, steps, jax_step), run_port(setup, steps)


def test_two_steps_match_jax(setup, two_steps):
    (jstate, jmetrics), (pstate, pmetrics) = two_steps
    for jm, pm in zip(jmetrics, pmetrics):
        assert pm["skipped"] == jm["skipped"] == 0.0
        for k in ("loss", "loss_CTC"):
            assert abs(pm[k] - jm[k]) <= LOSS_REL * abs(jm[k]), (k, pm[k], jm[k])
    want = flat(jstate.params)
    got = port_params_flax(pstate)
    start = flat(setup)
    assert set(got) == set(want)
    moved = [k for k in want if np.abs(want[k] - start[k]).max() > 10 * PARAM_TOL]
    assert len(moved) > len(want) // 3, len(moved)  # the steps move most leaves
    bad = [(k, float(np.abs(got[k] - want[k]).max())) for k in want
           if not np.abs(got[k] - want[k]).max() <= PARAM_TOL]
    assert not bad, bad[:10]
    ema_want = flat(jstate.ema_params)
    ema_got = params_to_flax(pstate.ema)
    bad = [(k, float(np.abs(ema_got[k] - ema_want[k]).max())) for k in ema_want
           if not np.abs(ema_got[k] - ema_want[k]).max() <= PARAM_TOL]
    assert not bad, bad[:10]
    assert pstate.step == int(jstate.step) == 2
    assert pstate.optimizer.state["count"] == 2


def jax_skipped_step(jstate, tx):
    """What JAX's step does after a non-finite loss
    (dtlr_tpu/train/train_step.py:135-147): zeroed gradients through
    ``tx.update``, the updates zeroed, EMA with the step's decay."""
    zeros = jax.tree.map(jnp.zeros_like, jstate.params)
    _, opt_state = tx.update(zeros, jstate.opt_state, jstate.params)
    d = jax_warmed_decay(CFG.ema_decay, jstate.step)
    ema = jax.tree.map(lambda e, p: e * d + (1 - d) * p, jstate.ema_params, jstate.params)
    return jstate._replace(opt_state=opt_state, step=jstate.step + 1, ema_params=ema)


def test_nan_step_is_skipped_like_jax(setup, jax_step):
    """A NaN loss (``ctc_coef`` NaN makes the loss NaN in both packages;
    JAX's CTC zeroes a line whose own loss is NaN, see
    test_torch_ctc.py) skips the update: the port's parameters stay bit
    for bit, its moments, count and EMA move as JAX's skip branch moves
    them."""
    first = batches(1)
    jstate1, _ = run_jax(setup, first, jax_step)
    jstate = jax_skipped_step(jstate1, jax_step[0])
    pstate, _ = run_port(setup, first)
    kept = port_params_flax(pstate)
    before = {k: {n: t.clone() for n, t in pstate.optimizer.state[k].items()}
              for k in ("mu", "nu")}
    nan_step = make_ctc_train_step(ctc_eps=CFG.ctc_eps, ctc_coef=float("nan"),
                                   ema_decay=CFG.ema_decay)
    pstate, m = nan_step(pstate, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in batches(1, seed=20)[0].items()})
    assert np.isnan(float(m["loss"])) and np.isfinite(float(m["loss_CTC"]))
    assert float(m["skipped"]) == 1.0
    got = port_params_flax(pstate)
    for k in got:
        np.testing.assert_array_equal(got[k], kept[k], err_msg=k)
    assert pstate.optimizer.state["count"] == int(jstate.step) == 2 and pstate.step == 2
    # optax on zeroed gradients decays the moments, mu by b1 and nu by b2:
    # JAX's skip branch does so, and the port's step too
    for key, decay, (j1, j2) in (("mu", 0.9, (jax_moments(jstate1.opt_state)[0],
                                              jax_moments(jstate.opt_state)[0])),
                                 ("nu", 0.999, (jax_moments(jstate1.opt_state)[1],
                                                jax_moments(jstate.opt_state)[1]))):
        assert set(params_to_flax(pstate.optimizer.state[key])) == set(j2)
        for k in j2:
            np.testing.assert_allclose(j2[k], np.float32(decay) * j1[k], rtol=1e-6, atol=0)
        for n, t in pstate.optimizer.state[key].items():
            np.testing.assert_allclose(t.numpy(), np.float32(decay) * before[key][n].numpy(),
                                       rtol=1e-6, atol=0, err_msg=f"{key} {n}")
    ema_want = flat(jstate.ema_params)
    ema_got = params_to_flax(pstate.ema)
    for k in ema_want:
        assert float(np.abs(ema_got[k] - ema_want[k]).max()) <= PARAM_TOL, k


@pytest.mark.parametrize("step", [0, 1, 5, 100, 3329, 10 ** 6])
def test_warmed_decay_matches_jax(step):
    want = float(jax_warmed_decay(0.9997, jnp.asarray(step, jnp.int32)))
    assert _warmed_decay(0.9997, step) == want


def test_bf16_step_loss_within_tolerance(setup):
    """One port step in bf16 against JAX's bf16 loss (forward and
    ``ctc_loss`` as in make_ctc_train_step) on the same lines."""
    from dtlr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
    from dtlr_tpu.ops.pixels import prep_images as jax_prep_images

    b = batches(1)[0]
    model = jax_recipe(False)
    jloss = float(jax.jit(lambda p: jax_ctc_loss(
        *(lambda o: (o["pred_logits"], o["pred_boxes"]))(model.apply(
            p, jax_prep_images(b["images"], b["valid_hw"]), b["valid_hw"], None, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)})),
        b["labels"], b["valid"], eps=CFG.ctc_eps)[0])(setup))
    pstate, pmetrics = run_port(setup, [b], dtype_cfg=BF16)
    assert pmetrics[0]["skipped"] == 0.0
    assert abs(pmetrics[0]["loss"] - jloss) <= BF16_LOSS_REL * abs(jloss), (pmetrics, jloss)
    # gradients reached the fp32 masters through the bf16 casts
    p = dict(pstate.model.named_parameters())
    assert all(t.dtype == torch.float32 for t in p.values())
    assert p["class_embed.fc.weight"].grad.dtype == torch.float32
    assert float(p["transformer.decoder_layer_0.ca_box_gamma"].grad.abs().max()) > 0
