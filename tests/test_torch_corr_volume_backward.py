"""The volume lookup's backward (kernel 2b's plain version) and training
through the volumes, against codd_tpu on the CPU.

* ``corr_lookup_backward_plain`` against ``jax.vjp`` of codd_tpu's
  ``corr_lookup`` on its volume pyramid, for ``select="xla"``
  (``corr_impl="volume"``) and ``"reduce"`` (``volume_reduce``), four
  levels, on a coordinate field whose windows pass every edge of every
  level: the volumes' cotangents equal in bits, the coordinates' within
  1e-5 of the largest; through the pyramid's matmul, the f32 products
  within 1e-5 of the largest and the feature maps' gradients within the
  one bf16 rounding that follows them;
* ``volume_pallas`` raises under autograd in both packages;
* the motion stage (``configs/models/stereo_motion.py``) with
  ``corr_impl="volume"`` at 64x128, 2 GN iterations: the loss, every
  trainable gradient and one step's update against codd_tpu's, at
  ``tests/test_torch_train_motion.py``'s tolerances.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as nn
import optax
import torch

from codd_tpu.losses import assembly as jassembly
from codd_tpu.models.builder import build_estimator as jbuild
from codd_tpu.models.builder import build_loss_config as jbuild_loss
from codd_tpu.ops import corr as jcorr
from codd_tpu.train import optim as joptim
from codd_torch.config import load_config
from codd_torch.losses import assembly
from codd_torch.models.builder import build_estimator, build_loss_config
from codd_torch.ops import corr as tcorr
from codd_torch.train import optim, trainer
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
B, T, H, W = 1, 2, 64, 128
MAXD = 32
ITERS = 2
SELECTS = ("xla", "reduce")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


# ---------------------------------------------------------------------------
# the lookup's VJP
# ---------------------------------------------------------------------------

def _lookup_case(seed=0, Bc=2, h=6, w=10, C=32):
    """Feature maps, a coordinate field that throws windows up to 14 px
    past every edge (level 0 is 6x10, level 3 is 0x1 and all padding), and
    a cotangent."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(Bc, h, w, C).astype(np.float32)
    f2 = rng.randn(Bc, h, w, C).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
    coords = (grid + rng.uniform(-14.0, 14.0, (Bc, h, w, 2))
              ).astype(np.float32)
    g = rng.randn(Bc, h, w, 4 * 49).astype(np.float32)
    return f1, f2, coords, g


def _jax_vjp(f1, f2, coords, g, select, through_pyramid=False):
    """codd_tpu's pyramid and lookup, op by op: the volumes and the
    cotangents of the volumes and the coordinates; with
    ``through_pyramid`` also the feature maps'."""
    pyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4,
                                   impl="volume")
    _, vjp = jax.vjp(
        lambda vols, c: jcorr.corr_lookup({"vols": vols}, c, 3,
                                          select=select),
        pyr["vols"], jnp.asarray(coords))
    dvols, dc = vjp(jnp.asarray(g))
    out = ([np.asarray(v.astype(jnp.float32)) for v in pyr["vols"]],
           [np.asarray(d) for d in dvols], np.asarray(dc))
    if not through_pyramid:
        return out

    def whole(a, b):
        p = jcorr.build_corr_pyramid(a, b, 4, impl="volume")
        return jcorr.corr_lookup(p, jnp.asarray(coords), 3, select=select)

    _, vjp = jax.vjp(whole, jnp.asarray(f1), jnp.asarray(f2))
    return out + tuple(np.asarray(d) for d in vjp(jnp.asarray(g)))


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("select", SELECTS)
def test_volume_backward_matches_jax_vjp(select):
    """The volumes' cotangents equal in bits (zero outside each query's
    window; inside, the select's roundings); the coordinates' within 1e-5
    of the largest (f32 sums in another order: the port sums each level's
    49 products, codd_tpu each corner's)."""
    f1, f2, coords, g = _lookup_case()
    jvols, jdv, jdc = _jax_vjp(f1, f2, coords, g, select)
    vols = [_t(v).to(torch.bfloat16) for v in jvols]
    dv, dc = tcorr.corr_lookup_backward_plain(_t(g), vols, _t(coords), 3,
                                              None, select)
    assert len(dv) == 4
    for got, want, vol in zip(dv, jdv, vols):
        assert got.dtype == torch.bfloat16 and got.shape == vol.shape
        np.testing.assert_array_equal(
            _bits(got), _bits(_t(want).to(torch.bfloat16)))
        assert np.count_nonzero(want)
    assert dc.shape == coords.shape
    assert _rel(dc.numpy(), jdc) < 1e-5


def test_volume_backward_selects_round_differently():
    """The two selects' volume cotangents differ (the test above holds
    each to its own reference), by the bf16 roundings of the corners and
    their sums: within 2^-6 of each tap's sum of |corner terms| (the
    volume cotangent of |g|); their coordinates' cotangents are the
    same."""
    f1, f2, coords, g = _lookup_case(seed=1, h=12, w=16)
    vols = tcorr.build_corr_pyramid(_t(f1), _t(f2), 4, 3, impl="volume")
    (dx, cx), (dr, cr) = (tcorr.corr_lookup_backward_plain(
        _t(g), vols, _t(coords), 3, None, s) for s in SELECTS)
    assert torch.equal(cx, cr)
    differ = sum(int((a != b).sum()) for a, b in zip(dx, dr))
    assert differ > 0
    terms, _ = tcorr.corr_lookup_backward_plain(_t(np.abs(g)), vols,
                                                _t(coords), 3, None, "xla")
    for a, b, s in zip(dx, dr, terms):
        assert ((a.float() - b.float()).abs() <= 2.0 ** -6 * s.float()).all()


@pytest.mark.parametrize("select", SELECTS)
def test_volume_backward_through_the_pyramid(select):
    """``corr_lookup`` on the port's pyramid under autograd runs as
    ``CorrVolumeLookup``; the volumes' cotangent, as the pyramid's
    ``VolumeCarry`` hands it to the matmul, equals codd_tpu's in bits.
    The f32 products after the pyramid's matmul
    (each volume's cotangent against the bf16 operands) within 1e-5 of
    the largest of their f64 values from codd_tpu's cotangents.  Each
    level's gradient of f1 is rounded to bf16 before the levels add, as
    codd_tpu's einsum transposes round it, so the feature maps' gradients
    are within one bf16 ulp of codd_tpu's each (measured: equal in bits;
    a flip needs the two f32 sums of 64 products to straddle a bf16
    rounding edge); the coordinates' within 1e-5 of the largest."""
    f1, f2, coords, g = _lookup_case(seed=2)
    _, jdv, jdc, jd1, jd2 = _jax_vjp(f1, f2, coords, g, select, True)
    a, b, c = (_t(x).requires_grad_() for x in (f1, f2, coords))
    vols = tcorr.build_corr_pyramid(a, b, 4, 3, impl="volume")
    out = tcorr.corr_lookup(vols, c, 3, select=select)
    assert type(out.grad_fn).__name__ == "CorrVolumeLookupBackward"
    seen, prods, real = {}, [], torch.matmul
    # where the volumes' (running) cotangent reaches the matmul
    vols[0].grad_fn.register_hook(lambda gi, go: seen.update(enumerate(gi)))

    def matmul(x, y):   # each level's f32 product's gradient of f1
        i = len(prods)
        prods.append(None)
        x.register_hook(lambda d: prods.__setitem__(i, d.clone()))
        return real(x, y)

    out.backward(_t(g))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "matmul", matmul)
        a2 = _t(f1).requires_grad_()
        vols2 = tcorr.build_corr_pyramid(a2, _t(f2), 4, 3, impl="volume")
    tcorr.corr_lookup(vols2, _t(coords), 3, select=select).backward(_t(g))
    for i, want in enumerate(jdv):
        np.testing.assert_array_equal(_bits(seen[i]),
                                      _bits(_t(want).to(torch.bfloat16)))
    # the f32 d(f1/4) against f64 products of codd_tpu's (bit-equal)
    # cotangents and the bf16 levels
    lv = tcorr.build_corr_pyramid(_t(f1), _t(f2), 4, 3, impl="patch")
    assert len(prods) == 4
    for d, dv, f2p in zip(prods, jdv, lv["levels"]):
        ref = np.einsum("bnm,bmc->bnc", dv.reshape(dv.shape[0], dv.shape[1],
                                                   -1).astype(np.float64),
                        f2p.float().numpy().reshape(f2p.shape[0], -1,
                                                    f2p.shape[-1]))
        assert _rel(d.numpy(), ref) < 1e-5
    for got, want in ((a.grad, jd1), (b.grad, jd2)):
        assert (np.abs(got.numpy() - want) <= 2.0 ** -7 * np.abs(want)).all()
    assert _rel(c.grad.numpy(), jdc) < 1e-5


def test_volume_pallas_has_no_backward_in_either_package():
    """codd_tpu cannot differentiate ``select="pallas"`` (its
    ``window_select`` has no VJP); the port raises under autograd for it
    and runs it without autograd, as kernel 2."""
    f1, f2, coords, _ = _lookup_case(seed=3, Bc=1, h=4, w=8)
    pyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4,
                                   impl="volume")
    with pytest.raises(ValueError, match="Linearization"):
        jax.grad(lambda v: jcorr.corr_lookup({"vols": v}, jnp.asarray(
            coords), 3, select="pallas").sum())(pyr["vols"])
    vols = [_t(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
            for v in pyr["vols"]]
    need = [v.clone().requires_grad_() for v in vols]
    with pytest.raises(NotImplementedError, match="window_select"):
        tcorr.corr_lookup(need, _t(coords), 3, select="pallas")
    with torch.no_grad():
        out = tcorr.corr_lookup(need, _t(coords), 3, select="pallas")
    assert torch.equal(out, tcorr.corr_lookup(vols, _t(coords), 3))


# ---------------------------------------------------------------------------
# the motion stage through the volumes
# ---------------------------------------------------------------------------

def _cfg(*options):
    opts = [f"model.stereo.initialization.max_disp={MAXD}",
            f"model.stereo.loss.max_disp={MAXD}",
            f"model.motion.iters={ITERS}",
            "model.runtime.corr_impl=volume"] + list(options)
    return dict(load_config(str(ROOT / "configs" / "models"
                                / "stereo_motion.py"), opts)["model"])


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


def _batch(seed=0):
    """Seeded clip with motion supervision: images, disparity in (1, 25),
    flow in (-3, 3) px, disparity change in (-1, 1)."""
    rng = np.random.RandomState(seed)
    return {
        "l_img": rng.rand(B, T, H, W, 3).astype(np.float32),
        "r_img": rng.rand(B, T, H, W, 3).astype(np.float32),
        "gt_disp": rng.uniform(1.0, 25.0, (B, T, H, W, 1)).astype(np.float32),
        "gt_flow": rng.uniform(-3.0, 3.0, (B, T, H, W, 2)).astype(np.float32),
        "gt_disp_change": rng.uniform(-1.0, 1.0, (B, T, H, W, 1)
                                      ).astype(np.float32),
        "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]] * B,
                               np.float32),
    }


@pytest.fixture(scope="module")
def volume_stage():
    """codd_tpu's loss and gradients of the motion stage with
    ``corr_impl="volume"`` (one jitted ``value_and_grad``), and its
    optimizer's first update on them as its ``make_train_step`` applies it
    (the global norm, the non-finite zeroing, Adam with the clip).  The
    frozen stereo stage's outputs are the port's, fed to codd_tpu's
    ``_stereo_forward`` by ``nn.intercept_methods``: both runs take the
    same depth, and codd_tpu's compile leaves out HITNet (~20 s)."""
    cfg = _cfg()
    batch = _batch()
    model = build_estimator(cfg, device="cpu", seed=None)
    jm, lc = jbuild(cfg), jbuild_loss(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes, seed=3)
    model.load_state_dict(torch_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        stereo = [{k: v.numpy() for k, v in model._stereo_forward(
            _t(batch["l_img"][:, t]), _t(batch["r_img"][:, t]), True).items()}
            for t in range(T)]

    def loss_fn(v):
        frames = iter(stereo)

        def fed(next_fun, args, kwargs, ctx):
            if ctx.method_name == "_stereo_forward":
                return {k: jnp.asarray(a) for k, a in next(frames).items()}
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(fed):
            outs = jm.apply(v, batch["l_img"], batch["r_img"],
                            batch["intrinsics"], train=True)
        return jassembly.codd_train_loss(lc, outs, batch)

    (loss, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables)
    jtx = joptim.make_optimizer(joptim.one_cycle_schedule(2e-4, 25000), 1.0,
                                params=variables, frozen_prefixes=["stereo"])

    def update(v, g):
        gnorm = optax.global_norm(g)
        g = jax.tree_util.tree_map(
            lambda x: jnp.where(jnp.isfinite(x), x, jnp.zeros_like(x)), g)
        upd, _ = jtx.update(g, jtx.init(v), v)
        return gnorm, optax.apply_updates(v, upd)

    gnorm, after = jax.jit(update)(variables, grads)
    return dict(cfg=cfg, batch=batch, variables=variables, model=model,
                loss=float(loss), logs=_np(logs), gnorm=float(gnorm),
                grads=torch_state_dict_from_jax(_np(grads)),
                after=torch_state_dict_from_jax(_np(after)))


def _noise(grads):
    """Parameters whose gradient vanishes by invariance (the biases in
    front of fnet's instance norms; the ae head's bias): f32 noise below
    1e-6 of the largest gradient norm."""
    norms = {k: float(np.linalg.norm(g.numpy())) for k, g in grads.items()}
    top = max(norms.values())
    return {k for k, n in norms.items() if 0 < n <= 1e-6 * top}, top


def test_motion_stage_trains_through_the_volumes(volume_stage):
    """One step of the port's ``make_train_step`` with
    ``corr_impl="volume"`` (OneCycle 2e-4, clip 1.0, stereo frozen) against
    codd_tpu's: the lookup runs as ``CorrVolumeLookup`` (no patch layout),
    the loss to 1e-5, each log to 1e-4, grad_norm to 1e-3; every motion
    gradient to 5e-3 of its norm and fnet's to 2e-2 (the tolerances of
    ``tests/test_torch_train_motion.py``: f32 sums in other orders through
    two GN solves; fnet's gradient arrives through the volumes' bf16
    cotangents, which add over the iterations in bf16 in both, and XLA may
    keep more precision inside its fusions), except the embedding head's
    first conv (``ae0``), also to 2e-2 (measured 8.1e-3 for its weight,
    1.4e-2 for its bias): its gradient does not pass through the lookup's
    VJP but is the most sensitive to the forward, and the forward differs
    more than on the patch path (the supervision flows measured 5e-5 of
    their largest, against 9e-6) because the volumes are rounded to bf16
    after their f32 sums, and ~2e-5 of the entries land on the other side
    of a rounding edge in XLA's and the port's sums; the updates where
    |g| > 2e-2 of the tensor's largest gradient to 1e-6 + 1e-3 of lr,
    elsewhere within 2 lr (Adam's first step is about lr * sign(g));
    stereo unchanged."""
    s = volume_stage
    model = s["model"]
    assert model.motion.raft3d.gn_iter.corr_select == "xla"
    seen = []
    real = tcorr.CorrVolumeLookup.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcorr.CorrVolumeLookup, "apply",
                   lambda *a: seen.append(a[3]) or real(*a))
        mp.setattr(tcorr, "corr_patch_lookup_levels", None)
        sched = optim.one_cycle_schedule(2e-4, 25000)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        tx = optim.make_optimizer(sched, 1.0, dict(model.named_parameters()),
                                  ["stereo"])
        grads = {}
        real_update = tx.update

        def update(g, state, params):
            grads.update({k: v.clone() for k, v in g.items()})
            return real_update(g, state, params)

        mp.setattr(tx, "update", update)
        step = trainer.make_train_step(model, tx, build_loss_config(s["cfg"]))
        state, logs = step(trainer.create_train_state(model, tx),
                           {k: _t(v) for k, v in s["batch"].items()})
    # forward and the checkpoint's recompute, per iteration
    assert seen == ["xla"] * (2 * ITERS)
    assert abs(logs["loss"].item() - s["loss"]) <= 1e-5 * abs(s["loss"])
    for k, v in s["logs"].items():
        if k in logs:
            assert _rel(logs[k].item(), v) < 1e-4, k
    assert _rel(logs["grad_norm"].item(), s["gnorm"]) < 1e-3
    ref = s["grads"]
    noise, top = _noise(ref)
    checked = 0
    lr = sched(0)
    for k, p in model.named_parameters():
        r = ref[k].numpy()
        d = (p.detach() - before[k]).numpy()
        dj = s["after"][k].numpy() - before[k].numpy()
        if k.startswith("stereo."):
            assert not np.any(d) and not np.any(dj), k
            continue
        err = np.abs(d - dj)
        assert err.max() <= 2 * lr + 1e-6, k
        if k not in noise:
            assert err[np.abs(r) > 2e-2 * np.abs(r).max()].max(
                initial=0.0) <= 1e-3 * lr + 1e-6, k
        if not np.any(r):
            continue
        diff = float(np.linalg.norm(grads[k].numpy().astype(np.float64) - r))
        if k in noise:
            assert diff <= 1e-6 * top, k
            continue
        bound = 2e-2 if k.startswith(("motion.raft3d.fnet.",
                                      "motion.raft3d.gn_iter.update_block"
                                      ".ae0.")) else 5e-3
        assert diff <= bound * float(np.linalg.norm(r)), (k, diff)
        checked += 1
    assert checked > 400


def test_volume_cotangents_add_as_the_scan_carry(volume_stage, monkeypatch):
    """Each GN iteration runs under ``torch.utils.checkpoint(use_reentrant=
    False)``; the volumes' gradient reaches them through it, one 2b call
    an iteration, last iteration first (its coordinates are those of the
    forward's calls in reverse).  Every call adds into the pyramid's one
    running cotangent, in bf16 in that order, one rounding an iteration,
    as codd_tpu's scan carry adds them: what reaches the volumes' matmul
    (the ``VolumeCarry``'s gradient) is the in-order bf16 sum of the
    calls' dense cotangents, in bits."""
    s = volume_stage
    model = build_estimator(s["cfg"], device="cpu", seed=None)
    model.load_state_dict(torch_state_dict_from_jax(s["variables"]),
                          strict=True)
    fwd, bwd, seen = [], [], {}
    real_apply = tcorr.CorrVolumeLookup.apply
    real_bwd = tcorr.corr_lookup_backward
    real_build = tcorr.build_corr_pyramid

    def build(*args, **kwargs):
        vols = real_build(*args, **kwargs)
        if isinstance(vols, list) and vols[0].requires_grad:
            vols[0].grad_fn.register_hook(
                lambda gi, go: seen.update(enumerate(gi)))
        return vols

    def backward(*args):
        # the call's dense cotangent, from the plain backward
        dense = tcorr.corr_lookup_backward_plain(*args[:6])[0]
        out = real_bwd(*args)
        bwd.append((args[2], dense, args[6]))
        return out

    monkeypatch.setattr(tcorr.CorrVolumeLookup, "apply",
                        lambda *a: fwd.append(a[0]) or real_apply(*a))
    monkeypatch.setattr(tcorr, "corr_lookup_backward", backward)
    monkeypatch.setattr(tcorr, "build_corr_pyramid", build)
    tb = {k: _t(v) for k, v in s["batch"].items()}
    outs = model(tb["l_img"], tb["r_img"], tb["intrinsics"], train=True)
    loss, _ = assembly.codd_train_loss(build_loss_config(s["cfg"]), outs, tb)
    loss.backward()
    # the forward's calls, then the checkpoint's recompute of each
    assert len(fwd) == 2 * ITERS and len(bwd) == ITERS
    for k, (coords, _, running) in enumerate(bwd):
        assert torch.equal(coords, fwd[ITERS - 1 - k])
        assert running is bwd[0][2]
    assert sorted(seen) == [0, 1, 2, 3]
    for i, got in seen.items():
        acc = bwd[0][1][i]
        for _, d, _ in bwd[1:]:
            acc = acc + d[i]
        assert got.dtype == torch.bfloat16 and torch.equal(got, acc)


def test_volume_backward_dtypes_under_bf16_compute(volume_stage,
                                                   monkeypatch):
    """Under bf16 compute (``make_train_step(bf16_compute=True)``) the
    volume lookup's backward takes what f32 training gives it: an f32
    cotangent and coordinates, bf16 volumes (codd_tpu's bf16 step looks
    up f32 dots at f32 coordinates too), so 2b has no bf16 form."""
    s = volume_stage
    seen = {}
    real = tcorr.corr_lookup_backward

    def backward(g, vols, coords, *rest):
        seen.setdefault(bf16, set()).add(
            (g.dtype, coords.dtype) + tuple(v.dtype for v in vols))
        return real(g, vols, coords, *rest)

    monkeypatch.setattr(tcorr, "corr_lookup_backward", backward)
    batch = {k: _t(v) for k, v in s["batch"].items()}
    for bf16 in (False, True):
        model = build_estimator(s["cfg"], device="cpu", seed=None)
        model.load_state_dict(torch_state_dict_from_jax(s["variables"]),
                              strict=True)
        tx = optim.make_optimizer(lambda step: 1e-4, 1.0,
                                  dict(model.named_parameters()), ["stereo"])
        step = trainer.make_train_step(model, tx, build_loss_config(s["cfg"]),
                                       bf16_compute=bf16)
        _, logs = step(trainer.create_train_state(model, tx), batch)
        assert torch.isfinite(logs["loss"])
    assert seen[True] == seen[False] == {
        (torch.float32, torch.float32) + (torch.bfloat16,) * 4}
