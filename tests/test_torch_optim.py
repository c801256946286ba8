"""The port's optimizer (dtlr_tpu_torch/train/optim.py) against optax as
dtlr_tpu/train/optim.py builds it, on the same parameters and the same
sequence of gradients.

Five steps of the full-model optimizer (``main`` and ``backbone`` groups)
and of the head-only optimizer, with a linear warmup, a StepLR drop
inside the five steps, a global-norm clip that triggers on some steps and
not on others, and a parameter that gets no gradient (the CDN label
encoder, whose weight decay optax still applies). The learning rates are
large (1e-2) so that every step moves the parameters far more than the
tolerance: parameters and moments within 1e-6 (float32; optax and the
port round the same operations in other orders). The schedules alone:
every variant against optax's over 40 steps, relative 1e-6. A step
whose loss is not finite: the parameters stay, and the moments and the
count advance as optax's do on zeroed gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtlr_tpu.train import optim as jax_optim
from dtlr_tpu_torch.train import optim
from dtlr_tpu_torch.train.config import TrainConfig

TOL = 1e-6
SHAPES = {"backbone_net.conv1.weight": (8, 3, 3, 3), "backbone_net.layer1_0.GroupNorm_0.bias": (8,),
          "transformer.decoder_layer_0.ca_box_gamma": (4,),
          "transformer.decoder_layer_0.linear1.weight": (16, 8),
          "transformer.decoder_layer_0.linear1.bias": (16,),
          "class_embed.fc.weight": (12, 8), "class_embed.fc.bias": (12,),
          "enc_out_class_embed.fc.weight": (12, 8), "label_enc": (14, 8)}
NO_GRAD = "label_enc"


class JaxCfg:
    """The attributes and ``get_default`` that dtlr_tpu/train/optim.py reads."""

    def __init__(self, cfg: TrainConfig):
        self._cfg = cfg
        for k, v in vars(cfg).items():
            setattr(self, k, list(v) if isinstance(v, tuple) else v)

    def get_default(self, key, default):
        return getattr(self, key, default)


def config(**kw):
    base = dict(lr=1e-2, lr_backbone=3e-3, weight_decay=1e-2, clip_max_norm=1.0,
                warmup_steps=2, steps_per_epoch=1, lr_drop=2)
    base.update(kw)
    return TrainConfig(**base)


def params_and_grads(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    # global norms from about 0.3 to 3: the clip (1.0) triggers on some steps
    grads = [{k: (rng.normal(size=s) * (0.01 + 0.03 * i)).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(steps)]
    for g in grads:
        g[NO_GRAD] = np.zeros(SHAPES[NO_GRAD], np.float32)
    return params, grads


def run_optax(tx, params, grads, finite=None):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for i, g in enumerate(grads):
        g = {k: jnp.asarray(v) for k, v in g.items()}
        if finite is not None and not finite[i]:
            g = jax.tree.map(jnp.zeros_like, g)  # train_step.py:135-140
            updates, state = tx.update(g, state, p)
            updates = jax.tree.map(jnp.zeros_like, updates)
        else:
            updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
    return {k: np.asarray(v) for k, v in p.items()}, state


def run_port(build, cfg, params, grads, finite=None):
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = build(cfg, p)
    for i, g in enumerate(grads):
        tg = {k: (None if k == NO_GRAD else torch.from_numpy(v)) for k, v in g.items()}
        if finite is not None and not finite[i]:
            tg = {k: torch.full(SHAPES[k], float("nan")) for k in g}
        opt.step(tg, None if finite is None else torch.tensor(bool(finite[i])))
    return {k: v.numpy() for k, v in p.items()}, opt


def adam_states(state):
    """Every ScaleByAdamState in an optax state tree, by group."""
    found = {}

    def visit(node, path=()):
        if isinstance(node, optax.ScaleByAdamState):
            found[path] = node
            return
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (k,))
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                visit(v, path + (i,))
        elif hasattr(node, "_fields"):
            for f in node._fields:
                visit(getattr(node, f), path + (f,))

    visit(state)
    return found


def assert_moments_match(opt, state):
    """One Adam state per trained group in optax, each masked to its
    group's leaves; the port keeps the moments of every trained leaf."""
    adams = adam_states(state)
    assert adams, "no adam state found"
    trained = set()
    for adam in adams.values():
        assert int(adam.count) == opt.state["count"]
        for key in ("mu", "nu"):
            for name, v in getattr(adam, key).items():
                if isinstance(v, optax.MaskedNode):
                    continue
                trained.add(name)
                np.testing.assert_allclose(opt.state[key][name].numpy(), np.asarray(v),
                                           rtol=0, atol=TOL, err_msg=f"{key} {name}")
    assert trained == set(opt.state["mu"]) == set(opt.state["nu"])


BUILDERS = {"full_model": (optim.build_optimizer, jax_optim.build_optimizer),
            "head_only": (optim.build_head_only_optimizer, jax_optim.build_head_only_optimizer)}


@pytest.mark.parametrize("which", list(BUILDERS))
def test_five_steps_match_optax(which):
    port_build, jax_build = BUILDERS[which]
    cfg = config()
    params, grads = params_and_grads()
    norms = [np.sqrt(sum(float((v ** 2).sum()) for v in g.values())) for g in grads]
    assert min(norms) < cfg.clip_max_norm < max(norms)  # the clip triggers on some steps
    want, state = run_optax(jax_build(JaxCfg(cfg), {k: jnp.asarray(v) for k, v in params.items()}),
                            params, grads)
    got, opt = run_port(port_build, cfg, params, grads)
    for k in SHAPES:
        assert np.abs(got[k] - params[k]).max() > 100 * TOL or (
            which == "head_only" and not any(s in k for s in optim.HEAD_SCOPES)), k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
    assert_moments_match(opt, state)


@pytest.mark.parametrize("which", list(BUILDERS))
def test_nan_step_keeps_params_and_advances_state(which):
    """Step 2 of 5 has a non-finite loss (NaN gradients): the parameters
    after it are those before it, and moments, count and later steps
    follow optax on zeroed gradients."""
    port_build, jax_build = BUILDERS[which]
    cfg = config()
    params, grads = params_and_grads(seed=1)
    finite = [True, True, False, True, True]
    want, state = run_optax(jax_build(JaxCfg(cfg), {k: jnp.asarray(v) for k, v in params.items()}),
                            params, grads, finite)
    got, opt = run_port(port_build, cfg, params, grads, finite)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
    assert_moments_match(opt, state)
    # the skipped step alone leaves every parameter as it was
    before, _ = run_port(port_build, cfg, params, grads[:2])
    after, _ = run_port(port_build, cfg, params, grads[:3], finite[:3])
    for k in SHAPES:
        np.testing.assert_array_equal(after[k], before[k])


SCHEDULES = {
    "step_lr": dict(warmup_steps=0, steps_per_epoch=4, lr_drop=3),
    "step_lr_warmup": dict(warmup_steps=5, steps_per_epoch=4, lr_drop=3),
    "multistep": dict(multi_step_lr=True, steps_per_epoch=3, lr_drop_list=(4, 9)),
    "multistep_warmup": dict(multi_step_lr=True, steps_per_epoch=3, lr_drop_list=(4, 9),
                             warmup_steps=7),
    "onecycle": dict(onecyclelr=True, epochs=4, steps_per_epoch=9),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_optax(name):
    cfg = config(**SCHEDULES[name])
    want = jax_optim.make_lr_schedule(cfg.lr, JaxCfg(cfg))
    got = optim.make_lr_schedule(cfg.lr, cfg)
    for count in range(40):
        w = float(want(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(got(count), w, rtol=1e-6, atol=1e-12, err_msg=str(count))


def test_labels_match_jax():
    names = list(SHAPES) + ["backbone_net.FrozenBatchNorm_0.scale"]
    want = jax_optim.label_params({n: 0 for n in names}, 1.0)
    assert optim.label_params(names) == want


def test_frozen_norm_leaves_stay_through_steps_ema_and_resume():
    """FrozenBN statistics (``frozen``, optax's ``set_to_zero``) get
    gradients, which count in the clip's norm, and never move: after five
    steps, after the EMA of those steps, and after a resume of the
    optimizer's state and two more steps, every frozen leaf is its start
    bit for bit; the other leaves follow optax at TOL."""
    from dtlr_tpu_torch.train.train_step import _warmed_decay, update_ema

    frozen = {f"backbone_net.layer1_0.FrozenBatchNorm_1.{leaf}": (8,)
              for leaf in ("weight", "bias", "mean", "var")}
    shapes = {**SHAPES, **frozen}
    rng = np.random.default_rng(3)
    params = {k: rng.uniform(0.5, 1.5, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 0.05).astype(np.float32) for k, s in shapes.items()}
             for _ in range(7)]
    cfg = config()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want, _ = run_optax(jax_optim.build_optimizer(JaxCfg(cfg), jparams), params, grads)

    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = optim.build_optimizer(cfg, p)
    ema = {k: v.clone() for k, v in p.items()}
    for i, g in enumerate(grads[:5]):
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        update_ema(ema, p, _warmed_decay(0.9997, i))
    resumed = optim.build_optimizer(cfg, p)
    resumed.load_state_dict(opt.state_dict())
    for g in grads[5:]:
        resumed.step({k: torch.from_numpy(v) for k, v in g.items()})
    assert set(optim.label_params(list(shapes)).values()) == {"main", "backbone", "frozen"}
    for k in frozen:
        assert np.array_equal(p[k].numpy(), params[k]), k
        assert np.array_equal(ema[k].numpy(), params[k]), k
        assert k not in opt.state["mu"]
    for k in SHAPES:
        np.testing.assert_allclose(p[k].numpy(), want[k], rtol=0, atol=TOL, err_msg=k)
