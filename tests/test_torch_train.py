"""Training on the CPU: codd_torch's training step for the stereo and the
fusion stage against codd_tpu's, on the same numpy weights and batches.

* kernel 1's backward: ``tile_warp_cost_backward_plain``, autograd through
  ``tile_warp_cost_plain`` and ``jax.vjp(tile_warping)`` at B=2, H=16,
  W=64, C=16, with slants that send taps out of the image on both sides;
* the losses on seeded inputs, values and input gradients;
* HITNet's train-mode outputs, every pyramid, at 64x128;
* the stereo stage (``configs/models/stereo.py``, max_disp 32, T=2):
  loss and every parameter's gradient against ``jax.value_and_grad`` of
  ``codd_train_loss`` over ``model.apply``, the gradient tree mapped by
  ``torch_state_dict_from_jax``;
* the fusion stage (``configs/models/codd.py``, stereo and motion frozen,
  ``iters=1``): only fusion parameters get gradients.  codd_tpu's splat
  composites equal z-keys in arbitrary order (ROADMAP Queue 3, "Splat tie
  order"), so the stage is held twice: teacher-forced (the port's frozen
  RAFT-3D returns codd_tpu's own warped memory), to f32 rounding; and
  free-running, to a stated bound;
* the optimizer against optax over three steps, the schedules, the
  freeze mask; one training step against codd_tpu's ``make_train_step``;
  accumulation; non-finite gradients; the raises (the "pallas" variant).

Weights are numpy draws over codd_tpu's parameter shapes (``eval_shape``,
no ``model.init`` compile).  One JAX compile per module-scoped fixture.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from codd_tpu.losses import assembly as jassembly
from codd_tpu.losses import hitnet as jhit
from codd_tpu.losses import temporal as jtemporal
from codd_tpu.models.builder import build_estimator as jbuild
from codd_tpu.models.builder import build_loss_config as jbuild_loss
from codd_tpu.models.motion.motion import Motion as JMotion
from codd_tpu.models.stereo.hitnet import tile_warping
from codd_tpu.train import optim as joptim
from codd_tpu.train import trainer as jtrainer
from codd_torch.config import load_config
from codd_torch.losses import assembly, hitnet as thit, temporal
from codd_torch.models.builder import build_estimator, build_loss_config
from codd_torch.ops import tile_warp
from codd_torch.train import optim, trainer
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

B, T, H, W = 2, 2, 64, 128
MAXD = 32
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def _cfg(name, *options):
    opts = [f"model.stereo.initialization.max_disp={MAXD}",
            f"model.stereo.loss.max_disp={MAXD}"] + list(options)
    return dict(load_config(str(ROOT / "configs" / "models" / name),
                            opts)["model"])


def _numpy_params(shapes, seed=1):
    """lecun-normal kernels, unit scales and variances, zero elsewhere."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if "scale" in name or "var" in name:
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(seed=0, b=B):
    """Seeded clip; ground truth in (1, 25) with some pixels invalid (0 and
    past max_disp)."""
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1.0, 25.0, (b, T, H, W, 1)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.05] = 0.0
    gt[rng.rand(*gt.shape) < 0.02] = 40.0
    return {
        "l_img": rng.rand(b, T, H, W, 3).astype(np.float32),
        "r_img": rng.rand(b, T, H, W, 3).astype(np.float32),
        "gt_disp": gt,
        "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]] * b,
                               np.float32),
    }


def _port(cfg, variables):
    m = build_estimator(cfg, device="cpu", seed=None)
    m.load_state_dict(torch_state_dict_from_jax(variables), strict=True)
    return m


def _port_grads(model):
    return {k: (None if p.grad is None else p.grad.numpy().copy())
            for k, p in model.named_parameters()}


def _check_grads(tg, jg, bound, trainable=lambda k: True):
    """Per tensor: |g_port - g_jax| / |g_jax| <= bound; a tensor whose
    codd_tpu gradient is zero (a frozen stage) has none in the port.
    Returns the worst relative error."""
    worst = 0.0
    for k, g in tg.items():
        ref = jg[k].numpy()
        if not trainable(k):
            assert not np.any(ref), k
            assert g is None or not np.any(g), k
            continue
        assert g is not None, k
        if not np.any(ref):
            assert np.abs(g).max() <= 1e-6, k
            continue
        err = rel_norm(g, ref)
        worst = max(worst, err)
        assert err <= bound, (k, err)
    return worst


def _jax_loss_fn(jm, lc, batch, capture=None):
    def f(v):
        kw = {}
        if capture is not None:
            kw = dict(capture_intermediates=capture, mutable=["intermediates"])
        res = jm.apply(v, batch["l_img"], batch["r_img"], batch["intrinsics"],
                       train=True, **kw)
        outs, inter = (res if capture is not None else (res, None))
        loss, logs = jassembly.codd_train_loss(lc, outs, batch)
        return loss, (logs, outs, inter)
    return f


# ---------------------------------------------------------------------------
# kernel 1's backward
# ---------------------------------------------------------------------------

def test_tile_warp_backward_matches_jax_vjp():
    """The plain backward (the kernel's math), autograd through the plain
    forward and jax.vjp(tile_warping) agree.  Tolerances: the forward
    differs from tile_warping by f32 rounding (jnp.linspace's -0.49999994
    against -0.5 moves local_d by < 1e-7 px); the hyp3 gradient sums 16
    pixels x 16 channels x 3 offsets in another order: 1e-5 relative;
    fea_l / fea_r: sums of at most 12 terms, 1e-5."""
    rng = np.random.RandomState(0)
    b, h, w, c = 2, 16, 64, 16
    fl, fr = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    d = rng.uniform(-10.0, 70.0, (b, h // 4, w // 4))
    d[:, 0, -1], d[:, 1, 0] = -8.0, 40.0  # an edge tile of each kind
    sl = rng.uniform(-3.0, 3.0, (2, b, h // 4, w // 4))
    hyp3 = np.stack([d, sl[0], sl[1]], -1).astype(np.float32)
    g = rng.randn(b, h // 4, w // 4, 48).astype(np.float32)
    # taps leave the image on both sides
    x = np.arange(w)[None, None, :] - np.repeat(np.repeat(d, 4, 1), 4, 2)
    assert (x < 1).any() and (x > w - 3).any()

    out, vjp = jax.vjp(tile_warping, *map(jnp.asarray, (hyp3, fl, fr)))
    ref = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    ins = [_t(a).requires_grad_() for a in (hyp3, fl, fr)]
    got = tile_warp.tile_warp_cost_plain(*ins)
    assert rel(got.detach().numpy(), out) < 1e-5
    got.backward(_t(g))
    auto = [t.grad.numpy() for t in ins]
    plain = [t.numpy() for t in tile_warp.tile_warp_cost_backward_plain(
        _t(g), *map(_t, (hyp3, fl, fr)))]
    for name, r, a, p in zip(("hyp3", "fea_l", "fea_r"), ref, auto, plain):
        assert rel(p, r) < 1e-5, name
        assert rel(a, r) < 1e-5, name
        assert rel(p, a) < 1e-5, name
    # the Function takes the plain backward on the CPU
    ins = [_t(a).requires_grad_() for a in (hyp3, fl, fr)]
    tile_warp.tile_warp_cost(*ins).backward(_t(g))
    for t, p in zip(ins, plain):
        np.testing.assert_array_equal(t.grad.numpy(), p)


def test_tile_warp_backward_at_ties_matches_jax_vjp():
    """Where a left feature equals its warped value, |x|'s cotangent is
    JAX's select(x >= 0, g, -g), +g at 0: the plain backward and jax.vjp
    (tile_warping) agree (tolerances as above) on a field of whole-pixel
    disparities over equal rows, where every warped value ties."""
    rng = np.random.RandomState(1)
    b, h, w, c = 1, 8, 64, 16
    fr = rng.randn(b, h, w, c).astype(np.float32)
    fl = np.roll(fr, 3, axis=2)
    hyp3 = np.zeros((b, h // 4, w // 4, 3), np.float32)
    hyp3[..., 0] = 3.0
    g = rng.randn(b, h // 4, w // 4, 48).astype(np.float32)
    ref = [np.asarray(a) for a in jax.vjp(tile_warping, *map(
        jnp.asarray, (hyp3, fl, fr)))[1](jnp.asarray(g))]
    got = [t.numpy() for t in tile_warp.tile_warp_cost_backward_plain(
        _t(g), *map(_t, (hyp3, fl, fr)))]
    for name, r, p in zip(("hyp3", "fea_l", "fea_r"), ref, got):
        assert rel(p, r) < 1e-5, name


def test_tile_warp_backward_raises_below_f32():
    """Below f32 the backward takes bf16 (the exact form's VJP, held to
    jax.vjp in tests/test_torch_train_bf16.py): its gradients flow, in
    bf16, as the plain backward gives them; float16 features raise."""
    fl = torch.randn(1, 8, 16, 4, dtype=torch.bfloat16, requires_grad=True)
    hyp3 = torch.zeros(1, 2, 4, 3, dtype=torch.bfloat16)
    hyp3[..., 0] = 2.5
    out = tile_warp.tile_warp_cost(hyp3, fl, fl.detach())
    g = torch.randn(out.shape).to(torch.bfloat16)
    out.backward(g)
    want = tile_warp.tile_warp_cost_backward_plain(g, hyp3, fl.detach(),
                                                   fl.detach())[1]
    assert fl.grad.dtype == torch.bfloat16 and torch.equal(fl.grad, want)
    assert fl.grad.abs().sum() > 0
    with pytest.raises(TypeError):
        tile_warp.tile_warp_cost(hyp3.half(), fl.detach().half()
                                 .requires_grad_(), fl.detach().half())
    with torch.no_grad():  # inference in bf16 stays as it was
        assert tile_warp.tile_warp_cost(hyp3, fl, fl).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def _pyramids(rng, b=1, h=H, w=W, maxd=MAXD):
    cvs = [rng.rand(b, h // s, w // s, maxd // (s // 4)).astype(np.float32)
           * 3 for s in (64, 32, 16, 8, 4)]
    planes = [rng.uniform(0, 30, (b, h, w, 1)).astype(np.float32)
              for _ in range(12)]
    dxs = [rng.randn(b, h, w, 1).astype(np.float32) for _ in range(12)]
    dys = [rng.randn(b, h, w, 1).astype(np.float32) for _ in range(12)]
    ws = [rng.randn(b, h, w, 1).astype(np.float32) for _ in range(8)]
    return cvs, planes, dxs, dys, ws


@pytest.mark.parametrize("with_depth", [False, True])
def test_hit_loss_matches(with_depth):
    """Value and the gradients to every pyramid: f32 sums of up to 8k
    terms in another order, 1e-5 relative."""
    rng = np.random.RandomState(1)
    pyr = _pyramids(rng)
    d_gt = rng.uniform(0.5, 35.0, (1, H, W, 1)).astype(np.float32)
    # near-ground-truth planes so that the slant and w terms have pixels
    pyr[1][3] = d_gt + rng.uniform(-0.8, 0.8, d_gt.shape).astype(np.float32)
    seg = (rng.rand(1, H, W, 1) > 0.1).astype(np.float32)
    jfn, tfn = ((jhit.hit_loss_with_depth, thit.hit_loss_with_depth)
                if with_depth else (jhit.hit_loss, thit.hit_loss))
    jcfg, tcfg = jhit.HITLossConfig(max_disp=MAXD), thit.HITLossConfig(
        max_disp=MAXD)

    def jloss(p):
        return jfn(jcfg, *p, jnp.asarray(d_gt), jnp.asarray(seg))

    (jl, jlogs), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, pyr))
    tp = [[_t(a).requires_grad_() for a in lvl] for lvl in pyr]
    tl, tlogs = tfn(tcfg, *tp, _t(d_gt), _t(seg))
    tl.backward()
    assert rel(tl.item(), jl) < 1e-5
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert rel(tlogs[k].item(), jlogs[k]) < 1e-5, k
    for tlvl, jlvl in zip(tp, jg):
        for t, j in zip(tlvl, jlvl):
            j = np.asarray(j)
            got = np.zeros_like(j) if t.grad is None else t.grad.numpy()
            assert np.abs(got - j).max() <= 1e-5 * (np.abs(j).max() + 1e-12)


def test_motion_and_fusion_losses_match():
    rng = np.random.RandomState(2)
    est = [rng.randn(1, H, W, 3).astype(np.float32) for _ in range(3)]
    rev = [rng.randn(1, H, W, 2).astype(np.float32) for _ in range(3)]
    gt = rng.randn(1, H, W, 3).astype(np.float32)
    mask = rng.rand(1, H, W, 1) > 0.3
    jl, jlogs = jtemporal.motion_loss(est, rev, gt, mask, loss_weight=0.5)
    tl, tlogs = temporal.motion_loss([_t(a) for a in est],
                                     [_t(a) for a in rev], _t(gt),
                                     torch.from_numpy(mask), loss_weight=0.5)
    assert rel(tl.item(), jl) < 1e-5
    for k in jlogs:
        assert rel(tlogs[k].item(), jlogs[k]) < 1e-5, k
    args = [rng.uniform(0, 40, (1, H, W, 1)).astype(np.float32)
            for _ in range(2)] + [rng.rand(1, H, W, 1).astype(np.float32)
                                  for _ in range(2)]
    curr = args[1] + rng.uniform(-8, 8, args[1].shape).astype(np.float32)
    warp = args[1] + rng.uniform(-8, 8, args[1].shape).astype(np.float32)
    warp[:, :8] = 0.0
    kw = dict(loss_weight=1.0, wr_weight=0.7, wf_weight=1.3,
              max_disp=float(MAXD))
    jf = jtemporal.fusion_loss(*args, curr, warp, **kw)
    tf = temporal.fusion_loss(*map(_t, args), _t(curr), _t(warp), **kw)
    assert rel(tf.item(), jf) < 1e-5


@pytest.mark.parametrize("disp_change", ["gt_disp_change", "gt_flow_occ",
                                         "gt_disp2"])
def test_codd_train_loss_matches(disp_change):
    """Every log of a 3-frame clip with all three loss kinds, with each
    source of the disparity-change supervision."""
    rng = np.random.RandomState(3)
    Tn = 3
    batch = {"gt_disp": rng.uniform(0, 40, (1, Tn, H, W, 1)),
             "gt_flow": rng.uniform(-3, 3, (1, Tn, H, W, 2)),
             "gt_semantic_seg": (rng.rand(1, Tn, H, W, 1) > 0.1) * 1.0}
    batch[disp_change] = {"gt_disp_change": rng.uniform(-1, 1, (
        1, Tn, H, W, 1)), "gt_flow_occ": (rng.rand(1, Tn, H, W, 1) > 0.8)
        * 1.0, "gt_disp2": rng.uniform(-1, 30, (1, Tn, H, W, 1))}[disp_change]
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    outs = []
    for t in range(Tn):
        cvs, planes, dxs, dys, ws = _pyramids(rng)
        o = {"init_cv_pyramid": cvs, "prop_disp_pyramid": planes,
             "dx_pyramid": dxs, "dy_pyramid": dys, "w_pyramid": ws,
             "pred_disp": planes[-1]}
        if t:
            o.update(flow2d_est=[rng.randn(1, H, W, 3).astype(np.float32)
                                 for _ in range(2)],
                     flow2d_rev=[rng.randn(1, H, W, 2).astype(np.float32)
                                 for _ in range(2)],
                     fusion_weights=rng.rand(1, H, W, 1).astype(np.float32),
                     reset_weights=rng.rand(1, H, W, 1).astype(np.float32),
                     pred_curr=planes[-2], pred_warp=planes[-3])
        outs.append(o)
    jl, jlogs = jassembly.codd_train_loss(
        jassembly.LossConfig(max_disp=MAXD, motion_loss_weight=0.5), outs,
        batch)
    to_t = lambda x: [to_t(a) for a in x] if isinstance(x, list) else _t(x)
    tl, tlogs = assembly.codd_train_loss(
        assembly.LossConfig(max_disp=MAXD, motion_loss_weight=0.5),
        [{k: to_t(v) for k, v in o.items()} for o in outs],
        {k: _t(v) for k, v in batch.items()})
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert rel(tlogs[k].item(), jlogs[k]) < 1e-5, k


def test_build_loss_config_matches():
    for name, opts in (("stereo.py", ()), ("codd.py", (
            "model.train_cfg.freeze_stereo=True",
            "model.train_cfg.freeze_motion=True")),
            ("stereo_motion.py", ())):
        cfg = _cfg(name, *opts)
        j, t = jbuild_loss(cfg), build_loss_config(cfg)
        for k in ("max_disp", "disp_range", "stereo", "motion", "fusion",
                  "motion_loss_weight", "fusion_loss_weight", "wr_weight",
                  "wf_weight"):
            assert getattr(j, k) == getattr(t, k), (name, k)
        assert (j.hit.alpha, j.hit.c) == (t.hit.alpha, t.hit.c)


# ---------------------------------------------------------------------------
# the stereo stage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stereo_stage():
    cfg = _cfg("stereo.py")
    batch = _batch()
    jm, lc = jbuild(cfg), jbuild_loss(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes)
    (loss, (logs, outs, _)), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jm, lc, batch), has_aux=True))(variables)
    # codd_tpu's own training step on the same weights and batch
    tx = joptim.make_optimizer(lambda s: 1e-3, 1.0)
    jstep = jtrainer.make_train_step(jm, tx, lc)
    state, step_logs = jstep(jtrainer.create_train_state(variables, tx),
                             batch)
    return dict(cfg=cfg, batch=batch, variables=variables, loss=float(loss),
                logs=_np(logs), outs=_np(outs),
                grads=torch_state_dict_from_jax(_np(grads)),
                step_params=torch_state_dict_from_jax(_np(state.params)),
                step_logs=_np(step_logs))


def _port_loss(model, cfg, batch):
    tb = {k: _t(v) for k, v in batch.items()}
    outs = model(tb["l_img"], tb["r_img"], tb["intrinsics"], train=True)
    loss, logs = assembly.codd_train_loss(build_loss_config(cfg), outs, tb)
    return loss, logs, outs


@pytest.fixture(scope="module")
def stereo_port(stereo_stage):
    s = stereo_stage
    model = _port(s["cfg"], s["variables"])
    loss, logs, outs = _port_loss(model, s["cfg"], s["batch"])
    loss.backward()
    return dict(loss=loss.item(), logs={k: v.item() for k, v in logs.items()},
                outs=outs, grads=_port_grads(model))


def test_hitnet_train_outputs_match(stereo_stage, stereo_port):
    """Every supervision pyramid of both frames: 12 planes and 5 cost
    volumes, 8 confidences; f32 rounding through the cascade, 1e-4 of each
    output's largest value."""
    keys = ("init_cv_pyramid", "prop_disp_pyramid", "dx_pyramid",
            "dy_pyramid", "w_pyramid")
    for jo, to in zip(stereo_stage["outs"], stereo_port["outs"]):
        assert len(to["prop_disp_pyramid"]) == 12
        assert len(to["w_pyramid"]) == 8 and len(to["init_cv_pyramid"]) == 5
        for k in keys:
            for j, t in zip(jo[k], to[k]):
                assert t.shape == j.shape, k
                assert rel(t.detach().numpy(), j) < 1e-4, k
        assert rel(to["pred_disp"].detach().numpy(), jo["pred_disp"]) < 1e-4


def test_stereo_stage_loss_and_gradients(stereo_stage, stereo_port):
    """The loss to 1e-5 relative; every parameter's gradient to 1e-3 of its
    norm (f32 sums in other orders through a cascade of 20 tile updates
    and the backward of kernel 1's plain form)."""
    assert rel(stereo_port["loss"], stereo_stage["loss"]) < 1e-5
    for k, v in stereo_stage["logs"].items():
        assert rel(stereo_port["logs"][k], v) < 1e-4, k
    assert not any(k.startswith(("motion", "fusion"))
                   for k in stereo_port["grads"])
    _check_grads(stereo_port["grads"], stereo_stage["grads"], 1e-3)


# ---------------------------------------------------------------------------
# the fusion stage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fusion_stage():
    cfg = _cfg("codd.py", "model.motion.iters=1",
               "model.train_cfg.freeze_stereo=True",
               "model.train_cfg.freeze_motion=True")
    batch = _batch(seed=4, b=1)
    jm, lc = jbuild(cfg), jbuild_loss(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes, seed=2)
    capture = lambda mdl, name: isinstance(mdl, JMotion) and \
        name == "__call__"
    (loss, (logs, _, inter)), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jm, lc, batch, capture), has_aux=True))(variables)
    motion_out = inter["intermediates"]["motion"]["__call__"][0]
    return dict(cfg=cfg, batch=batch, variables=variables, loss=float(loss),
                logs=_np(logs), grads=torch_state_dict_from_jax(_np(grads)),
                motion_out=_np(motion_out))


def _fusion_port_run(stage, teacher_forced):
    model = _port(stage["cfg"], stage["variables"])
    if teacher_forced:
        # the frozen RAFT-3D returns codd_tpu's warped memory and features
        ref = jax.tree_util.tree_map(_t, stage["motion_out"])
        model.motion.forward = lambda *a, **k: ref
    loss, logs, _ = _port_loss(model, stage["cfg"], stage["batch"])
    loss.backward()
    return loss.item(), {k: v.item() for k, v in logs.items()}, \
        _port_grads(model)


def test_fusion_stage_teacher_forced(fusion_stage):
    """With codd_tpu's motion output: loss to 1e-5, logs to 1e-4, fusion
    gradients to 1e-3 of their norms; stereo and motion get none."""
    loss, logs, grads = _fusion_port_run(fusion_stage, True)
    assert rel(loss, fusion_stage["loss"]) < 1e-5
    assert set(logs) == set(fusion_stage["logs"])
    for k, v in fusion_stage["logs"].items():
        assert rel(logs[k], v) < 1e-4, k
    _check_grads(grads, fusion_stage["grads"], 1e-3,
                 trainable=lambda k: k.startswith("fusion."))


def test_fusion_stage_free_running(fusion_stage):
    """The port's own frozen RAFT-3D: the splat's tie order moves the
    warped disparity on a share of pixels, so the loss is held to 1e-3
    and each fusion gradient to 5e-2 of its norm; only fusion parameters
    have gradients."""
    loss, _, grads = _fusion_port_run(fusion_stage, False)
    assert rel(loss, fusion_stage["loss"]) < 1e-3
    _check_grads(grads, fusion_stage["grads"], 5e-2,
                 trainable=lambda k: k.startswith("fusion."))


# ---------------------------------------------------------------------------
# optimizer and trainer
# ---------------------------------------------------------------------------

def test_schedules_match_optax():
    mg_j = joptim.multi_gamma_schedule(4e-4, [3, 7, 9], [0.25, 0.4, 0.25])
    mg_t = optim.multi_gamma_schedule(4e-4, [3, 7, 9], [0.25, 0.4, 0.25])
    for s in range(12):
        assert mg_t(s) == float(mg_j(s)), s
    oc_j = joptim.one_cycle_schedule(2e-4, 100)
    oc_t = optim.one_cycle_schedule(2e-4, 100)
    # optax computes in f32: 1e-6 relative, 1e-7 of the peak near the end
    for s in (0, 1, 15, 29, 30, 31, 60, 99, 100, 150):
        assert abs(oc_t(s) - float(oc_j(s))) <= 1e-6 * abs(float(oc_j(s))) \
            + 1e-7 * 2e-4, s


def _opt_trees(rng):
    shapes = {"stereo": {"a": (3, 4), "b": (5,)}, "fusion": {"c": (2, 2)},
              "motion": {"d": (6,)}}
    params = {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    flat = lambda tree: {f"{m}.{k}": v for m, d in tree.items()
                         for k, v in d.items()}
    return params, flat


def test_freeze_mask_matches():
    params, flat = _opt_trees(np.random.RandomState(0))
    jm = joptim.freeze_mask({"params": params}, ["stereo", "motion"])
    tm = optim.freeze_mask(flat(params), ["stereo", "motion"])
    assert tm == flat(jm["params"])


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["clipped",
                                                     "unclipped"])
def test_optimizer_three_steps_match_optax(scale):
    """Three Adam steps on seeded gradients (global norm ~30 or ~0.03
    against the clip 1.0), motion frozen: parameters to 1e-6 relative, the
    frozen ones equal in bits."""
    rng = np.random.RandomState(5)
    params, flat = _opt_trees(rng)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * scale).astype(np.float32), params)
        for _ in range(3)]
    sched = optim.one_cycle_schedule(2e-2, 10)
    jtx = joptim.make_optimizer(joptim.one_cycle_schedule(2e-2, 10), 1.0,
                                params={"params": params},
                                frozen_prefixes=["motion"])
    jp = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    js = jtx.init(jp)
    tp = {k: _t(v) for k, v in flat(params).items()}
    tx = optim.make_optimizer(sched, 1.0, params=tp,
                              frozen_prefixes=["motion"])
    ts = tx.init(tp)
    assert set(ts.mu) == {k for k in tp if not k.startswith("motion")}
    for g in grads:
        upd, js = jtx.update({"params": g}, js, jp)
        jp = optax.apply_updates(jp, upd)
        u, ts = tx.update({k: _t(v) for k, v in flat(g).items()}, ts, tp)
        optim.apply_updates(tp, u)
    ref = flat(_np(jp["params"]))
    for k, v in tp.items():
        if k.startswith("motion"):
            np.testing.assert_array_equal(v.numpy(), flat(params)[k])
        else:
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-6,
                                       atol=1e-7)


def test_train_step_matches_codd_tpu(stereo_stage):
    """One step of the stereo stage (Adam 1e-3, clip 1.0) against
    codd_tpu's make_train_step: loss to 1e-5, grad_norm to 1e-4.  Adam's
    first update is lr * g / (|g| + 1e-8): about lr * sign(g), so it
    amplifies the f32 error of a near-zero gradient up to a flipped sign.
    The updates agree to 1e-6 where |g| > 2e-2 of the tensor's largest
    gradient (codd_tpu's), and within 2 lr + 1e-6 elsewhere."""
    s = stereo_stage
    model = _port(s["cfg"], s["variables"])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tx = optim.make_optimizer(lambda step: 1e-3, 1.0)
    step = trainer.make_train_step(model, tx, build_loss_config(s["cfg"]))
    state, logs = step(trainer.create_train_state(model, tx),
                       {k: _t(v) for k, v in s["batch"].items()})
    assert state.opt_state.count == 1
    assert rel(logs["loss"].item(), s["step_logs"]["loss"]) < 1e-5
    assert rel(logs["grad_norm"].item(), s["step_logs"]["grad_norm"]) < 1e-4
    assert logs["step_skipped"].item() == s["step_logs"]["step_skipped"] == 0
    for k, p in model.named_parameters():
        err = np.abs((p.detach() - before[k]).numpy()
                     - (s["step_params"][k].numpy() - before[k].numpy()))
        g = np.abs(s["grads"][k].numpy())
        assert err.max() <= 2e-3 + 1e-6, k
        assert err[g > 2e-2 * g.max()].max(initial=0.0) <= 1e-6, k


def test_train_step_all_frozen_keeps_grad_norm(stereo_stage):
    """Every top-level module frozen in the optimizer: grad_norm is still
    the norm of every gradient, as codd_tpu logs optax.global_norm of the
    whole tree (to 1e-4, as above); the optimizer keeps no state and no
    parameter changes a bit."""
    s = stereo_stage
    model = _port(s["cfg"], s["variables"])
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    tx = optim.make_optimizer(lambda step: 1e-3, 1.0, params,
                              sorted({k.split(".")[0] for k in params}))
    step = trainer.make_train_step(model, tx, build_loss_config(s["cfg"]))
    state, logs = step(trainer.create_train_state(model, tx),
                       {k: _t(v) for k, v in s["batch"].items()})
    assert rel(logs["grad_norm"].item(), s["step_logs"]["grad_norm"]) < 1e-4
    assert state.opt_state.mu == {} and state.opt_state.nu == {}
    for k, p in params.items():
        assert torch.equal(p.detach(), before[k]), k


class _Sgd:
    """SGD(1.0) in the optimizer's interface: the update is -grad."""

    def init(self, params):
        return optim.AdamState(0, {}, {})

    def trained_names(self, tree):
        return list(tree)

    def update(self, grads, state, params=None):
        return {k: -g for k, g in grads.items()}, state


def test_accumulation_matches_full_batch(stereo_stage):
    """accum_steps=2 against 1 under SGD(1.0), so the parameter change is
    the averaged gradient: the losses are batch means, so the two agree to
    f32 reduction order (5e-4 on the loss, 5e-3 on the norm, 1e-2 of each
    tensor's largest change, as tests/test_trainer_accum.py)."""
    s = stereo_stage
    batch = {k: _t(v) for k, v in s["batch"].items()}
    res = []
    for accum in (1, 2):
        model = _port(s["cfg"], s["variables"])
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        step = trainer.make_train_step(model, _Sgd(),
                                       build_loss_config(s["cfg"]), accum)
        _, logs = step(trainer.create_train_state(model, _Sgd()), batch)
        res.append((logs, {k: (p.detach() - before[k]).numpy()
                           for k, p in model.named_parameters()}))
    (l1, d1), (l2, d2) = res
    assert rel(l2["loss"].item(), l1["loss"].item()) < 5e-4
    assert rel(l2["grad_norm"].item(), l1["grad_norm"].item()) < 5e-3
    for k in d1:
        assert np.abs(d1[k] - d2[k]).max() <= 1e-2 * (np.abs(d1[k]).max()
                                                      + 1e-12), k
    model = _port(s["cfg"], s["variables"])
    step = trainer.make_train_step(model, _Sgd(), build_loss_config(s["cfg"]),
                                   accum_steps=3)
    with pytest.raises(ValueError):
        step(trainer.create_train_state(model, _Sgd()), batch)


def test_non_finite_gradients_are_zeroed(stereo_stage):
    """A NaN in one image pixel: the loss is NaN and the gradient elements
    it reaches are NaN.  Those are zeroed element by element, so Adam
    leaves their parameters' bits as they were and its moments finite;
    step_skipped is 1."""
    s = stereo_stage
    batch = dict(s["batch"], l_img=s["batch"]["l_img"].copy())
    batch["l_img"][0, 0, 5, 7, 1] = np.nan
    probe = _port(s["cfg"], s["variables"])
    loss, _, _ = _port_loss(probe, s["cfg"], batch)
    loss.backward()
    bad = {k: ~torch.isfinite(p.grad) for k, p in probe.named_parameters()}
    assert not torch.isfinite(loss) and any(b.any() for b in bad.values())
    model = _port(s["cfg"], s["variables"])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tx = optim.make_optimizer(lambda step: 1e-3, 1.0)
    step = trainer.make_train_step(model, tx, build_loss_config(s["cfg"]))
    state, logs = step(trainer.create_train_state(model, tx),
                       {k: _t(v) for k, v in batch.items()})
    assert logs["step_skipped"].item() == 1.0
    assert not np.isfinite(logs["grad_norm"].item())
    for k, p in model.named_parameters():
        assert torch.equal(p.detach()[bad[k]], before[k][bad[k]]), k
        assert torch.isfinite(p).all(), k
    assert all(torch.isfinite(v).all() for v in state.opt_state.mu.values())
    assert all(torch.isfinite(v).all() for v in state.opt_state.nu.values())


# ---------------------------------------------------------------------------
# what this slice does not train
# ---------------------------------------------------------------------------

def test_unported_training_raises():
    """The "pallas" tile-warp variant has no VJP (codd_tpu's Pallas
    tile_warp_cost has none; tilewin and grouped train,
    tests/test_torch_tile_warp_variants.py): training raises in f32 and in
    bf16 compute; bf16 compute itself trains
    (tests/test_torch_train_bf16.py)."""
    batch = {k: _t(v[:1]) for k, v in _batch().items()}
    args = (batch["l_img"], batch["r_img"], batch["intrinsics"])
    pallas = _cfg("stereo.py", "model.runtime.tile_warp_variant=pallas")
    with pytest.raises(NotImplementedError):
        build_estimator(pallas, device="cpu")(*args, train=True)
    model = build_estimator(pallas, device="cpu")
    step = trainer.make_train_step(model, optim.make_optimizer(
        lambda s: 1e-3), build_loss_config(pallas), bf16_compute=True)
    with pytest.raises(NotImplementedError):
        step(trainer.create_train_state(model, optim.make_optimizer(
            lambda s: 1e-3)), {k: _t(v[:1]) for k, v in _batch().items()})
