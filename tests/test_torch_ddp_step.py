"""Both train steps over two data-parallel ranks (gloo, on the CPU)
against dtlr_tpu's steps over a 2-device mesh, at the tiny geometry.

The ranks are ``python -m torch.distributed.run --standalone
--nproc_per_node 2 -m dtlr_tpu_torch.scripts.ddp_check``; each takes 2
lines of every global batch of 4 (``batch_size`` is the global batch,
as JAX's mesh shards it). JAX runs its own ``make_detection_train_step``
and ``make_ctc_train_step`` over ``create_mesh("data",
jax.devices()[:2])`` on ``shard_batch``'s global arrays, as its
``Trainer`` does, on the conftest's virtual CPU devices. The weights,
lines and optimizers are test_torch_detection_step.py's and
test_torch_train_step.py's (the trained ResNet-50, seeded heads, 128x256
crops of the fixture lines; lr 1e-5, backbone 1e-10, EMA on). The
detection step runs with the recipe's CDN noise (label flips at 0.5,
box noise 0.4): JAX's four draws from one fixed key (JAX's
``prepare_cdn`` is handed that key in place of its module rng), drawn
for the global batch; the port's ranks get the same global draws and
cut their rows (``models/cdn.py``'s ``rows``). Both sides use the exact
Hungarian matcher (``matcher_impl="scipy"``).

Held, float32 (the port's references run in this process at the ranks'
threads, so that the CPU's kernels sum as the ranks' do):
- the ranks' parameters, optimizer moments and count, and EMA after
  every run: equal bit for bit (sha256 per rank);
- the first step: the global gradient (the ranks' sum), loss and terms
  within 1e-5 (of the gradient's norm) of one port process's steps on
  each rank's rows combined; against one process on the whole batch,
  within that and what one process itself moves between the two;
  against ``jax.grad`` of JAX's loss on the sharded batch per leaf at
  test_torch_grad_stops.py's tolerances;
- each step's loss and terms against JAX's: 1e-5 beyond one port
  process's own distance from them (see
  ``test_loss_and_terms_match_jax_mesh``);
- the parameters and EMA after two steps: 1e-6 against one port process
  (4 lr where a near tie flips between the rows and the whole batch),
  and against JAX's mesh steps (see ``test_two_steps_match_jax_mesh``);
- a NaN in one rank's rows (a padded target's box): every rank skips the
  step, the parameters stay as they were, the count advances.
Each launch has a time limit, and each rank ``cores / (xdist workers x
ranks)`` threads; the runs' files are removed after their tests.
"""

import dataclasses
import json
import os
import shutil
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtlr_tpu.models.dino as jax_dino_module
from dtlr_tpu.losses import criterion as jax_criterion
from dtlr_tpu.models.dino import DINO as JaxDINO
from dtlr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu.parallel.mesh import create_mesh
from dtlr_tpu.parallel.mesh import shard_batch as jax_shard_batch
from dtlr_tpu.train import optim as jax_optim
from dtlr_tpu.train.train_step import init_train_state as jax_init_train_state
from dtlr_tpu.train.train_step import make_ctc_train_step as jax_make_ctc_step
from dtlr_tpu.train.train_step import make_detection_train_step as jax_make_detection_step
from dtlr_tpu_torch.parallel import launch
from dtlr_tpu_torch.scripts import ddp_check
from dtlr_tpu_torch.train.checkpoints import params_to_flax
from dtlr_tpu_torch.train.config import RECIPE, RECIPE_DETECTION
from dtlr_tpu_torch.weights import params_from_npz
from test_torch_cdn import jax_draws
from test_torch_detection_step import DN, N_TARGETS, WEIGHTS, jax_matcher_without_gradient
from test_torch_detection_step import batches as detection_batches
from test_torch_grad_stops import BACKBONE_TOL, CHAOTIC, TOL, flat, relative_errors
from test_torch_model import NUM_CLASSES, TINY, jax_tiny, make_lines
from test_torch_smoke_fixture import PARAMS
from test_torch_optim import JaxCfg
from test_torch_train_step import PARAM_TOL
from test_torch_train_step import batches as ctc_batches

RANKS, LOSS_REL, STEP2_REL, GRAD_OF_NORM = 2, 1e-5, 1e-3, 1e-5
#: both optimizers' learning rate outside the backbone
LR = 1e-5
#: seconds a launch of the two ranks may take
LAUNCH_TIMEOUT = 300
#: the recipe's CDN noise (DinoConfig's defaults, dtlr_tpu/configs/Latin.py:77-80)
LABEL_NOISE, BOX_NOISE = 0.5, 0.4
DETECTION_CFG = JaxCfg(dataclasses.replace(
    RECIPE_DETECTION, lr=1e-5, lr_backbone=1e-10, warmup_steps=0, matcher_impl="scipy",
    max_targets=N_TARGETS))
CTC_CFG = JaxCfg(dataclasses.replace(RECIPE, use_ema=True))
#: TINY and the optimizers above in the port's options
TINY_OPTIONS = [f"{k}={getattr(TINY, k)}" for k in (
    "num_queries", "hidden_dim", "nheads", "enc_layers", "dec_layers", "dim_feedforward",
    "encoder_win")]
OPTIONS = {"detection": TINY_OPTIONS + [
               "use_dn=True", f"dn_number={DN.dn_number}", "lr=1e-05", "lr_backbone=1e-10",
               "warmup_steps=0", "matcher_impl=scipy", f"max_targets={N_TARGETS}"],
           "ctc": TINY_OPTIONS + ["use_ema=True"]}
CDN_KEY = jax.random.PRNGKey(5)


def rank_threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // (workers * RANKS))


def jax_noisy_model() -> JaxDINO:
    return JaxDINO(
        num_classes=NUM_CLASSES, num_queries=DN.num_queries, hidden_dim=DN.hidden_dim,
        n_heads=DN.nheads, num_encoder_layers=DN.enc_layers, num_decoder_layers=DN.dec_layers,
        d_ffn=DN.dim_feedforward, num_feature_levels=4, use_dn=True, dn_number=DN.dn_number,
        dn_box_noise_scale=BOX_NOISE, dn_label_noise_ratio=LABEL_NOISE,
        dn_labelbook_size=NUM_CLASSES + 1, max_targets=N_TARGETS, norm_kind="group",
        encoder_type="windowed", encoder_win=DN.encoder_win, decoder_ca="dense",
        dense_box_bias=True, flash_attn=False, dtype=jnp.float32)


@contextmanager
def fixed_cdn_key():
    """JAX's ``prepare_cdn`` draws from ``CDN_KEY`` in place of the model's
    rng, so that the port can be handed the same draws."""
    prepare = jax_dino_module.prepare_cdn
    jax_dino_module.prepare_cdn = lambda rng, *args: prepare(CDN_KEY, *args)
    try:
        yield
    finally:
        jax_dino_module.prepare_cdn = prepare


def global_batches(make, n_steps=2):
    """Global batches of 4 lines: the helper's 2-line batches in pairs."""
    small = make(2 * n_steps)
    return [{k: np.concatenate([small[2 * i][k], small[2 * i + 1][k]]) for k in small[0]}
            for i in range(n_steps)]


def save_batches(path, steps):
    np.savez(path, **{k: np.stack([b[k] for b in steps]) for k in steps[0]})


def run_ranks(files, mode, out, *extra):
    args = ["--mode", mode, "--params", str(files / "params.npz"), "--batches",
            str(files / f"{mode}.npz"), "--out", str(out), "--device", "cpu",
            "--compute_dtype", "float32", "--save_state", "--options", *OPTIONS[mode], *extra]
    done = launch.launch(RANKS, "dtlr_tpu_torch.scripts.ddp_check", args,
                         timeout=LAUNCH_TIMEOUT, threads=rank_threads())
    assert done.returncode == 0, done.stderr[-4000:]
    return [json.load(open(out / f"rank{r}.json")) for r in range(RANKS)]


def load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def port_flax(tree, prefix):
    """``params/<name>`` or ``ema/<name>`` leaves of a state npz in flax's
    names and layouts."""
    return params_to_flax({k[len(prefix) + 1:]: torch.from_numpy(v) for k, v in tree.items()
                           if k.startswith(prefix + "/")})


def tiny_weights():
    """test_torch_grad_stops.py's ``trained_backbone_params`` (the
    flagship's trained ResNet-50, the flax init with N(0, 0.05) noise from
    numpy seed 1 elsewhere) with the flax init jitted: the same values,
    in a quarter of the time."""
    images, valid_hw = make_lines()
    init = jax.jit(lambda im, vh: jax_tiny(False).init(
        {"params": jax.random.PRNGKey(0)}, jax_prep_images(im, vh), vh, None, train=False))
    params = init(images, valid_hw)
    rng = np.random.default_rng(1)
    trained = params_from_npz(PARAMS)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if any(getattr(k, "key", None) == "backbone_net" for k in path):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            return trained[key].astype(np.float32)
        return x + rng.normal(0.0, 0.05, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp")
    params = tiny_weights()
    np.savez(d / "params.npz", **flat(params))
    det = global_batches(detection_batches)
    save_batches(d / "detection.npz", det)
    save_batches(d / "ctc.npz", global_batches(ctc_batches))
    B = len(det[0]["labels"])
    draws = jax_draws(CDN_KEY, B, N_TARGETS, DN.dn_number, NUM_CLASSES)
    np.savez(d / "draws.npz", **{k: np.stack([getattr(draws, k).numpy()] * len(det))
                                 for k in ("flip", "label", "sign", "mag")})
    yield d, params
    shutil.rmtree(d, ignore_errors=True)


def jax_mesh_steps(params, steps, mode):
    """JAX's step over a 2-device mesh, two steps: the state, each step's
    metrics and the first step's gradient."""
    mesh = create_mesh("data", jax.devices()[:RANKS])
    cfg = DETECTION_CFG if mode == "detection" else CTC_CFG
    tx = jax_optim.build_optimizer(cfg, params)
    if mode == "detection":
        model = jax_noisy_model()
        step = jax_make_detection_step(model.apply, tx, NUM_CLASSES, WEIGHTS,
                                       matcher_impl="scipy", ema_decay=cfg.ema_decay)
    else:
        model = jax_tiny(False)
        step = jax_make_ctc_step(model.apply, tx, ctc_eps=cfg.ctc_eps, ema_decay=cfg.ema_decay)
    grad_fn = jax.jit(jax.grad(lambda p, b: jax_loss(model, mode, p, b)))

    state = jax_init_train_state(params, tx, use_ema=True)
    metrics = []
    with mesh, fixed_cdn_key(), jax_matcher_without_gradient():
        grads = flat(grad_fn(params, jax_shard_batch(mesh, steps[0])))
        for b in steps:
            state, m = step(state, jax_shard_batch(mesh, b), jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, grads


def jax_loss(model, mode, params, batch):
    """The step's loss (dtlr_tpu/train/train_step.py:65-81, :120-130)."""
    if mode == "ctc":
        out = model.apply(params, batch["images"], batch["valid_hw"], None, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return CTC_CFG.CTC_loss_coef * jax_ctc_loss(out["pred_logits"], out["pred_boxes"],
                                                    batch["labels"], batch["valid"],
                                                    eps=CTC_CFG.ctc_eps)[0]
    targets = {k: batch[k] for k in ("labels", "boxes", "valid")}
    key = jax.random.PRNGKey(0)
    out = model.apply(params, batch["images"], batch["valid_hw"], targets, train=True,
                      rngs={"dn": key, "dropout": jax.random.fold_in(key, 1)})
    return jax_criterion.detection_loss(out, targets, NUM_CLASSES,
                                        WEIGHTS,
                                        matcher_impl="scipy")[0]


@contextmanager
def torch_threads(n):
    """This process's intra-op threads at ``n`` (the ranks'), so that its
    CPU kernels sum as theirs do."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def halves(d, mode, tmp):
    """The first global batch's halves (each rank's rows) as one-step
    batch files, with their rows of the CDN draws; the weight of each half
    in the global loss: its share of the global normalizer (its valid
    targets for the detection losses, its lines for CTC)."""
    batch = load_npz(d / f"{mode}.npz")
    draws = load_npz(d / "draws.npz") if mode == "detection" else None
    files, weights = [], []
    for r in range(RANKS):
        rows = slice(2 * r, 2 * r + 2)
        np.savez(tmp / f"half{r}.npz", **{k: v[:1, rows] for k, v in batch.items()})
        extra = []
        if draws is not None:
            np.savez(tmp / f"draws{r}.npz", **{k: v[:1, rows] for k, v in draws.items()})
            extra = ["--cdn_draws", str(tmp / f"draws{r}.npz")]
        files.append((tmp / f"half{r}.npz", extra))
        weights.append(float(batch["valid"][0, rows].sum()) if mode == "detection" else 2.0)
    return files, [w / sum(weights) for w in weights]


def one_process(d, mode, batches, out, *extra):
    """ddp_check in this process (no group), at the ranks' threads."""
    with torch_threads(rank_threads()):
        ddp_check.main(["--mode", mode, "--params", str(d / "params.npz"), "--batches",
                        str(batches), "--out", str(out), "--device", "cpu", "--save_state",
                        "--options", *OPTIONS[mode], *extra])
    return json.load(open(out / "rank0.json"))["steps"]


@pytest.fixture(scope="module", params=["detection", "ctc"])
def runs(request, files, tmp_path_factory):
    """One mode's runs: two ranks; one port process on the whole batches
    and, for the first step, on each rank's rows (their gradients and
    terms combined with the halves' weights, as the ranks' sum combines
    them); JAX's mesh steps."""
    mode = request.param
    d, params = files
    out = tmp_path_factory.mktemp(f"{mode}_ranks")
    extra = ["--cdn_draws", str(d / "draws.npz")] if mode == "detection" else []
    ranks = run_ranks(d, mode, out, *extra)
    one = tmp_path_factory.mktemp(f"{mode}_one")
    one_process(d, mode, d / f"{mode}.npz", one, *extra)
    tmp = tmp_path_factory.mktemp(f"{mode}_halves")
    half_files, weights = halves(d, mode, tmp)
    half_steps, half_grads = [], []
    for r, (batches, half_extra) in enumerate(half_files):
        half_steps.append(one_process(d, mode, batches, tmp / f"run{r}", *half_extra)[0])
        half_grads.append(load_npz(tmp / f"run{r}" / "grads.npz"))
        shutil.rmtree(tmp / f"run{r}")
    combined = {
        "terms": {k: sum((0.5 if k == "cardinality_error" else w) * h[k]
                         for w, h in zip(weights, half_steps))
                  for k in half_steps[0] if k not in ("ms", "launches", "skipped", "grad_norm")},
        "grads": {k: sum(w * g[k] for w, g in zip(weights, half_grads)) for k in half_grads[0]}}
    steps = [{k: v[i] for k, v in load_npz(d / f"{mode}.npz").items()} for i in range(2)]
    yield mode, params, ranks, out, one, combined, jax_mesh_steps(params, steps, mode)
    # the runs' weights, gradients and states take hundreds of MB
    for path in (out, one, tmp):
        shutil.rmtree(path, ignore_errors=True)


def grad_distance(got, want):
    """max |got - want| over every leaf, and want's global norm."""
    assert set(got) == set(want)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    return max(float(np.abs(got[k] - want[k]).max()) for k in want), norm


def test_ranks_agree_bit_for_bit(runs):
    _, _, ranks, *_ = runs
    assert [r["rank"] for r in ranks] == [0, 1] and ranks[0]["world_size"] == RANKS
    assert ranks[0]["backend"] == "gloo" and ranks[0]["lines_per_rank"] == 2
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert ranks[0]["digests"]["count"] == ranks[0]["digests"]["step"] == 2
    assert ranks[0]["steps"] == [{**s, "ms": r["ms"]} for s, r in
                                 zip(ranks[1]["steps"], ranks[0]["steps"])]


def test_first_step_is_one_process_on_each_rank_rows(runs):
    """The global gradient (the ranks' sum) within 1e-5 of its norm, and
    the loss and every term within 1e-5, of one process's first steps on
    each rank's rows combined (measured 1.3e-7 of the norm): the ranks add
    nothing but the sum."""
    _, _, ranks, out, _, combined, _ = runs
    worst, norm = grad_distance(load_npz(out / "grads.npz"), combined["grads"])
    assert worst <= GRAD_OF_NORM * norm, (worst, norm)
    first = ranks[0]["steps"][0]
    for k, want in combined["terms"].items():
        assert abs(first[k] - want) <= LOSS_REL * max(abs(want), 1e-6), (k, first[k], want)


def test_first_step_against_one_process_on_the_whole_batch(runs):
    """Against one process on all four lines, the global gradient and loss
    may differ by what one process itself moves between each rank's rows
    and the whole batch, and 1e-5 more: the CPU's convolutions sum a
    batch of 2 and one of 4 in other orders, and a near-tied proposal or
    matching can then flip (measured 0 to 2.3e-5 of the norm, by the
    threads)."""
    _, _, ranks, out, one, combined, _ = runs
    whole = load_npz(one / "grads.npz")
    shape, norm = grad_distance(combined["grads"], whole)
    worst, _ = grad_distance(load_npz(out / "grads.npz"), whole)
    assert worst <= shape + GRAD_OF_NORM * norm, (worst, shape, norm)
    single = json.load(open(one / "rank0.json"))["steps"][0]["loss"]
    shape_loss = abs(combined["terms"]["loss"] - single)
    assert abs(ranks[0]["steps"][0]["loss"] - single) <= shape_loss + LOSS_REL * abs(single)


def test_loss_and_terms_match_jax_mesh(runs):
    """Each step's terms against JAX's: within 1e-5 beyond what one port
    process on the same rows carries them from JAX's (the first step: the
    halves combined, measured within 4.6e-7 of JAX's; the second: one
    process on the whole batches, after one update with the CDN noise on
    up to 1.2e-4 from JAX's (loss_xy, loss_ce), as the first update of the
    input projections, whose gradients are float noise amplified, moves
    the second step's boxes); that distance stays under ``STEP2_REL``."""
    mode, _, ranks, _, one, combined, (_, jmetrics, _) = runs
    single = json.load(open(one / "rank0.json"))["steps"]
    owns = [combined["terms"], single[1]]
    for i, (got, own, want) in enumerate(zip(ranks[0]["steps"], owns, jmetrics)):
        assert got["skipped"] == want["skipped"] == 0.0
        keys = set(want) - {"skipped"}
        assert keys <= set(got)
        if mode == "detection":
            assert {"loss_ce_dn", "loss_bbox_dn_0", "loss_giou_interm"} <= keys
        for k in keys:
            scale = max(abs(want[k]), 1e-6)
            own_err = abs(own[k] - want[k])
            assert own_err <= STEP2_REL * scale, (i, k, own[k], want[k])
            assert abs(got[k] - want[k]) <= own_err + LOSS_REL * scale, \
                (i, k, got[k], own[k], want[k])


def test_global_gradient_matches_jax_mesh(runs):
    _, _, _, out, _, _, (_, _, jgrads) = runs
    got = params_to_flax({k: torch.from_numpy(v) for k, v in load_npz(out / "grads.npz").items()})
    assert set(got) == set(jgrads)
    rel = relative_errors(got, jgrads)
    bad = [(k, r) for k, r in rel.items()
           if not r <= (BACKBONE_TOL if k.startswith(CHAOTIC) else TOL)]
    assert not bad, f"{len(bad)} leaves differ (key, relative error): {bad[:10]}"


def test_two_steps_match_one_process(runs):
    """Parameters and EMA after two steps over two ranks against one port
    process on the whole batches: within 1e-6 (measured 8.2e-8) where one
    process takes the same first step on the whole batch as on each rank's
    rows; where a near tie flips between the two (see
    ``test_first_step_against_one_process_on_the_whole_batch``), within
    what two AdamW steps can move a parameter, 4 lr."""
    _, _, _, out, one, combined, _ = runs
    ranks, single = load_npz(out / "state.npz"), load_npz(one / "state.npz")
    shape, norm = grad_distance(combined["grads"], load_npz(one / "grads.npz"))
    tol = PARAM_TOL if shape <= GRAD_OF_NORM * norm else 4 * LR
    assert set(ranks) == set(single)
    bad = [(k, float(np.abs(ranks[k] - single[k]).max())) for k in single
           if not np.abs(ranks[k] - single[k]).max() <= tol]
    assert not bad, (bad[:10], tol)


def test_two_steps_match_jax_mesh(runs):
    """Parameters and EMA after two steps over two ranks against JAX's two
    mesh steps: within 1e-6, or, on a leaf that one port process itself
    carries further from JAX's in these steps, within that distance and
    1e-6 more. Such leaves (measured: the input projections' convolutions
    up to 3.1e-5, a few encoder kernels up to 1.9e-6 in the detection
    step; the first two input projections 2.2e-6 in the CTC step) have
    first-step gradients near float noise, and AdamW's first update is
    about lr times their sign; two steps never move a parameter by more
    than about 4 lr (4e-5), which bounds the one-process distance."""
    mode, params, _, out, one, _, (jstate, _, _) = runs
    state, single = load_npz(out / "state.npz"), load_npz(one / "state.npz")
    start = flat(params)
    for prefix, want in (("params", flat(jstate.params)), ("ema", flat(jstate.ema_params))):
        got, own = port_flax(state, prefix), port_flax(single, prefix)
        assert set(got) == set(want)
        moved = [k for k in want if np.abs(want[k] - start[k]).max() > 10 * PARAM_TOL]
        assert len(moved) > len(want) // 3, len(moved)
        own_err = {k: float(np.abs(own[k] - want[k]).max()) for k in want}
        assert max(own_err.values()) <= 4 * LR, max(own_err.items(), key=lambda kv: kv[1])
        bad = [(k, float(np.abs(got[k] - want[k]).max()), own_err[k]) for k in want
               if not np.abs(got[k] - want[k]).max() <= own_err[k] + PARAM_TOL]
        assert not bad, bad[:10]


def test_a_nan_in_one_rank_skips_every_rank(files, tmp_path):
    """A NaN box in a padded target slot of rank 1's rows: the slot's box
    loss is 0 * NaN, so rank 1's loss is NaN, and with it the global
    loss; both ranks skip."""
    d, params = files
    steps = load_npz(d / "detection.npz")
    boxes = steps["boxes"][:1].copy()
    valid = steps["valid"][:1].copy()
    valid[0, 3, -1] = False
    boxes[0, 3, -1] = np.nan
    np.savez(tmp_path / "nan.npz", **{**{k: v[:1] for k, v in steps.items()},
                                      "boxes": boxes, "valid": valid})
    args = ["--mode", "detection", "--params", str(d / "params.npz"), "--batches",
            str(tmp_path / "nan.npz"), "--out", str(tmp_path / "out"), "--device", "cpu",
            "--save_state", "--options", *OPTIONS["detection"]]
    done = launch.launch(RANKS, "dtlr_tpu_torch.scripts.ddp_check", args,
                         timeout=LAUNCH_TIMEOUT, threads=rank_threads())
    assert done.returncode == 0, done.stderr[-4000:]
    ranks = [json.load(open(tmp_path / "out" / f"rank{r}.json")) for r in range(RANKS)]
    assert [r["steps"][0]["skipped"] for r in ranks] == [1.0, 1.0]
    assert all(np.isnan(r["steps"][0]["loss"]) for r in ranks)
    assert ranks[0]["digests"] == ranks[1]["digests"] and ranks[0]["digests"]["count"] == 1
    state = port_flax(load_npz(tmp_path / "out" / "state.npz"), "params")
    start = flat(params)
    assert all(np.array_equal(state[k], start[k]) for k in start)
    shutil.rmtree(tmp_path / "out")
