"""Training on the CPU, the motion stage: codd_torch's RAFT-3D train branch
and the backward of kernels 5 and 6 against codd_tpu, on the same numpy
weights and batches.

* ``grad_clip``: its backward against ``jax.vjp``, and the fusion net's
  VJP through it (``Fusion``'s heads clip their cotangents in codd_tpu);
* kernel 6's plain backward against ``jax.vjp`` of ``_lookup_level``, and
  through the pyramid's pooling and bf16 casts;
* kernel 5's plain backward against ``jax.vjp`` of ``_windowed_aggregate``
  (8x128, where codd_tpu takes the windowed form) and of ``build_system``
  in its dense form (8x16, where training runs it: w/8 <= 96);
* the motion stage (``configs/models/stereo_motion.py``: stereo frozen,
  fusion none, RAFT-3D trained by ``motion_loss``) at 64x128, 2 GN
  iterations, B=1, T=2: ``flow2d_est`` / ``flow2d_rev`` of every
  iteration, the loss and every trainable gradient against
  ``jax.value_and_grad``, stereo without gradients; one step of the
  port's ``make_train_step`` against codd_tpu's optimizer on codd_tpu's
  gradients;
* the raises: ``gn_impl="fused"``, a volume ``corr_impl`` and
  ``gn_bf16_scores`` where codd_tpu scores in bf16 (its windowed form;
  at the other widths they train as f32 scores, as in codd_tpu) (joint
  training, with the coordinates' gradient, is
  ``tests/test_torch_train_joint.py``'s).

One JAX compile of the stage (``value_and_grad``, ~65 s on an 8-core
CPU); codd_tpu's own ``make_train_step`` compiles the same graph again
with its optimizer (~130 s), which this file's time does not allow, so
its update is applied to the reference gradients here with codd_tpu's
optimizer (``make_optimizer``, optax) as that step applies it
(``_jax_update``), and ``_jax_update`` is held to codd_tpu's own
``make_train_step`` on a stand-in model that compiles in seconds.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from codd_tpu.losses import assembly as jassembly
from codd_tpu.models.builder import build_estimator as jbuild
from codd_tpu.models.builder import build_loss_config as jbuild_loss
from codd_tpu.models.fusion.fusion import Fusion as JFusion
from codd_tpu.ops import corr as jcorr
from codd_tpu.ops import gn as jgn
from codd_tpu.ops import se3 as jse3
from codd_tpu.ops import upsample as jup
from codd_tpu.train import optim as joptim
from codd_tpu.train import trainer as jtrainer
from codd_torch.config import load_config
from codd_torch.losses import assembly
from codd_torch.models.builder import build_estimator, build_loss_config
from codd_torch.models.fusion.fusion import Fusion as TFusion
from codd_torch.models.motion import raft3d as traft
from codd_torch.ops import corr as tcorr
from codd_torch.ops import gn as tgn
from codd_torch.ops import upsample as tup
from codd_torch.train import optim, trainer
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

B, T, H, W = 1, 2, 64, 128
MAXD = 32
ITERS = 2
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _bf16_np(t):
    return t.detach().float().numpy()


def _to_bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


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
    """Seeded clip with motion supervision: images, disparity in (1, 25),
    flow in (-3, 3) px, disparity change in (-1, 1)."""
    rng = np.random.RandomState(seed)
    return {
        "l_img": rng.rand(b, T, H, W, 3).astype(np.float32),
        "r_img": rng.rand(b, T, H, W, 3).astype(np.float32),
        "gt_disp": rng.uniform(1.0, 25.0, (b, T, H, W, 1)).astype(np.float32),
        "gt_flow": rng.uniform(-3.0, 3.0, (b, T, H, W, 2)).astype(np.float32),
        "gt_disp_change": rng.uniform(-1.0, 1.0, (b, T, H, W, 1)
                                      ).astype(np.float32),
        "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]] * b,
                               np.float32),
    }


# ---------------------------------------------------------------------------
# grad_clip
# ---------------------------------------------------------------------------

def test_grad_clip_matches_jax_vjp():
    """Equal bits: the identity forward, and the backward's zeroing of
    |g| > 0.01, then of NaN (inf is past the clip)."""
    x = np.linspace(-1, 1, 10).astype(np.float32)
    g = np.array([0.5, -0.02, 0.0099, -0.005, np.nan, np.inf, 0.01, -0.01,
                  0.010000001, -np.inf], np.float32)
    y, vjp = jax.vjp(jgn.grad_clip, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    out = tgn.grad_clip(xt)
    out.backward(_t(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    assert tgn.grad_clip(_t(x)) is not None  # no graph: the input itself


def _fusion_setup(rng):
    Bf, Hf, Wf = 1, 32, 64
    pred_curr = rng.uniform(0, 40, (Bf, Hf, Wf, 1)).astype(np.float32)
    pred_warp = rng.uniform(0, 40, (Bf, Hf, Wf, 1)).astype(np.float32)
    pred_warp[:, ::5] = 0.0  # holes the splat leaves
    args = (pred_curr, pred_warp,
            rng.randn(Bf, Hf // 4, Wf // 4, 32).astype(np.float32),
            rng.randn(Bf, Hf // 4, Wf // 4, 32).astype(np.float32),
            rng.randn(Bf, Hf, Wf, 3).astype(np.float32),
            rng.rand(Bf, Hf, Wf, 3).astype(np.float32),
            rng.randn(Bf, Hf // 4, Wf // 4, 24).astype(np.float32),
            rng.randn(Bf, Hf // 4, Wf // 4, 24).astype(np.float32))
    return (Bf, Hf, Wf), args


def test_fusion_vjp_clips_head_cotangents():
    """The fusion net's VJP for a cotangent whose elements on
    ``fusion_weights`` and ``reset_weights`` reach far past 0.01 at the
    heads and hold a NaN: codd_tpu clips both heads' cotangents
    (``fusion.py:145,150``), so every gradient is finite and the port's
    agree with ``jax.vjp``'s, parameters and inputs, to 2e-3 of each
    tensor's norm.  Why that much: of the 128 cotangents at the 1/4-res
    weight head, 3 survive the clip, and they are exactly the sums of 16
    terms of ~1e2 (``interpolate_nearest``'s backward) that cancel to below
    0.04, whose f32 rounding in another order is ~3e-4 of them; the reset
    head's branch agrees to 2e-5, and without the clip, NaN aside, every
    gradient agrees to 2e-6 (measured).  No cotangent lies within 0.5 % of
    the 0.01 edge, so no element flips.  Without the clip the port's
    parameter gradients are NaN."""
    rng = np.random.RandomState(6)
    (Bf, Hf, Wf), args = _fusion_setup(rng)
    jm, tm = JFusion(), TFusion()
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args)))
    tm.load_state_dict(torch_state_dict_from_jax(v), strict=False)
    cot = [rng.randn(Bf, Hf, Wf, 1).astype(np.float32) * s
           for s in (1.0, 5.0, 5.0)]
    cot[1][0, 3, 7, 0] = np.nan
    cot[2][0, 9, 2, 0] = np.nan
    jg = jax.jit(lambda p, a, c: jax.vjp(
        lambda p, *a: jm.apply({"params": p}, *a), p, *a)[1](c))(
        v["params"], tuple(jnp.asarray(a) for a in args),
        tuple(jnp.asarray(c) for c in cot))
    jparams = torch_state_dict_from_jax(_np(jg[0]))
    tins = [_t(a).requires_grad_() for a in args]
    outs = tm(*tins)
    torch.autograd.backward(outs, [_t(c) for c in cot])
    grads = {k: p.grad for k, p in tm.named_parameters()
             if p.grad is not None}
    assert set(grads) == set(jparams)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
        assert rel_norm(g.numpy(), jparams[k].numpy()) < 2e-3, k
    for i, (t, j) in enumerate(zip(tins, jg[1:])):
        j = np.asarray(j)
        finite = np.isfinite(j)
        # a NaN cotangent reaches the inputs outside the heads in both
        np.testing.assert_array_equal(np.isfinite(t.grad.numpy()), finite)
        assert rel_norm(t.grad.numpy()[finite], j[finite]) < 2e-3, i


# ---------------------------------------------------------------------------
# kernel 6's backward: the patch lookup
# ---------------------------------------------------------------------------

def _corr_setup(Bc=2, h=8, w=16, C=128, seed=0):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(Bc, h, w, C).astype(np.float32)
    f2 = rng.randn(Bc, h, w, C).astype(np.float32)
    coords = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
              + rng.uniform(-6, 6, (Bc, h, w, 2))).astype(np.float32)
    coords[:, 0, 0] = (-9.0, 3.0)            # a query the lookup masks
    coords[:, 1, 1] = (w + 8.5, h + 8.5)
    g = rng.randn(Bc, h, w, 4 * 49).astype(np.float32)
    return f1, f2, coords, g


@pytest.mark.parametrize("level", [0, 2])
def test_patch_backward_matches_jax_vjp(level):
    """One level on the same bf16 inputs, against ``jax.vjp`` of
    ``_lookup_level`` and against the same backward in f64.  df1: both
    round the same f32 sums once to bf16 and agree to 1e-5 of the norm
    (measured 3e-6).  dlevel: codd_tpu's gather transpose scatter-adds the
    taps' cotangents in bf16, rounding at every add: it lies 0.7 % (level 0)
    and 1.3 % (level 2) of the norm from the f64 sums, the port (f32 sums,
    one rounding) 0.17 % (half a bf16 ulp on average).  Held: the port to
    2.5e-3 of the f64 norm, codd_tpu to 2e-2, the two to 2e-2."""
    f1, f2, coords, g = _corr_setup()
    Bc, h, w, C = f1.shape
    f1b = np.asarray(jnp.asarray(f1).astype(jnp.bfloat16))
    lvl = np.asarray(jcorr.build_corr_pyramid(
        jnp.asarray(f1), jnp.asarray(f2), 4, impl="patch")["levels"][level])
    sc = 0.5 ** level
    gl = g[..., :49]
    _, vjp = jax.vjp(lambda a, b: jcorr._lookup_level(a, b, jnp.asarray(
        coords * sc), 3), jnp.asarray(f1b), jnp.asarray(lvl))
    jd1, jd2 = (np.asarray(x).astype(np.float64) for x in vjp(jnp.asarray(gl)))
    P = 7
    f1t = _to_bf16(np.asarray(f1b, np.float32)).reshape(Bc, h * w, C)
    f2p = torch.nn.functional.pad(_to_bf16(np.asarray(lvl, np.float32)),
                                  (0, 0, P, P, P, P))
    args = (f1t, f2p, _t(coords * sc))
    d1, d2 = tcorr.corr_patch_lookup_level_backward_plain(_t(gl), *args, 3)
    x1, x2 = tcorr.corr_patch_lookup_level_backward_plain(
        _t(gl).double(), *(a.double() for a in args), 3)
    port = [d.to(torch.bfloat16).double().numpy() for d in (d1, d2)]
    truth = [x1.numpy(), x2.numpy()]
    port[1], truth[1] = port[1][:, P:-P, P:-P], truth[1][:, P:-P, P:-P]
    port[0], truth[0] = (a.reshape(jd1.shape) for a in (port[0], truth[0]))
    assert rel_norm(port[0], jd1) < 1e-5
    assert rel_norm(port[0], truth[0]) < 2.5e-3
    assert rel_norm(port[1], truth[1]) < 2.5e-3
    assert rel_norm(jd2, truth[1]) < 2e-2
    assert rel_norm(port[1], jd2) < 2e-2


def test_patch_backward_through_the_pyramid():
    """fmap1 / fmap2 (f32) -> patch pyramid -> the four-level lookup, the
    port's ``CorrPatchLookup`` (its plain backward on the CPU) against
    ``jax.vjp`` of codd_tpu's ``build_corr_pyramid`` + ``corr_lookup``:
    the bf16 cotangents of f1 and each level reach the f32 features
    through the casts, the pooling and the padding.  Held to 1e-2 of each
    gradient's norm: codd_tpu accumulates its level cotangents in bf16
    (see above), the port in f32 with one rounding."""
    f1, f2, coords, g = _corr_setup(seed=3)

    def jfn(a, b):
        pyr = jcorr.build_corr_pyramid(a, b, 4, impl="patch")
        return jcorr.corr_lookup(pyr, jnp.asarray(coords), 3)

    _, vjp = jax.vjp(jfn, jnp.asarray(f1), jnp.asarray(f2))
    jd1, jd2 = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    a, b = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    pyr = tcorr.build_corr_pyramid(a, b, 4, 3, impl="patch")
    out = tcorr.corr_lookup(pyr, _t(coords), 3)
    assert out.grad_fn is not None and "CorrPatchLookup" in type(
        out.grad_fn).__name__
    out.backward(_t(g))
    assert rel_norm(a.grad.numpy(), jd1) < 1e-2
    assert rel_norm(b.grad.numpy(), jd2) < 1e-2
    # the Function's backward is the plain one on the CPU, bit for bit
    leaves = [pyr["f1"].detach().requires_grad_()] + [
        l.detach().requires_grad_() for l in pyr["levels"]]
    tcorr.corr_patch_lookup_levels(leaves[0], leaves[1:], _t(coords),
                                   3).backward(_t(g))
    d1, dl = tcorr.corr_patch_lookup_backward_plain(
        _t(g), leaves[0].detach(), [l.detach() for l in leaves[1:]],
        _t(coords), 3)
    assert torch.equal(leaves[0].grad, d1)
    for l, d in zip(leaves[1:], dl):
        assert l.grad.dtype == torch.bfloat16 and torch.equal(l.grad, d)


# ---------------------------------------------------------------------------
# kernel 5's backward: the GN sums
# ---------------------------------------------------------------------------

def _gn_field(h, w, seed=0, Bg=1):
    rng = np.random.RandomState(seed)
    intr = np.tile(np.array([[90.0, 90.0, w / 2, h / 2]], np.float32),
                   (Bg, 1))
    depth = rng.uniform(2.0, 40.0, (Bg, h, w)).astype(np.float32)
    Ts = np.asarray(jse3.exp(jnp.asarray(rng.randn(Bg, h, w, 6) * 0.01,
                                         jnp.float32)))
    target = (rng.randn(Bg, h, w, 3) * 0.5).astype(np.float32)
    target[..., 0] += np.arange(w)
    target[..., 1] += np.arange(h)[:, None]
    target[..., 2] = 1.0 / depth
    weight = rng.rand(Bg, h, w, 3).astype(np.float32)
    ae = (rng.randn(Bg, h, w, 32) * 0.5).astype(np.float32)
    return Ts, ae, target, weight, depth, intr


def test_gn_backward_matches_windowed_vjp():
    """8x128, where codd_tpu takes its windowed form: the plain backward
    (dense (n, n) scores) against ``jax.vjp(_windowed_aggregate)``, each
    element to 1e-5 of its sum of |terms| (f32 sums of up to 65 x 8 terms
    in another order); the Function's backward is the plain one."""
    rng = np.random.RandomState(2)
    ae = (rng.randn(1, 8, 128, 32) * 0.4).astype(np.float32)
    vals = rng.randn(1, 8, 128, 27).astype(np.float32)
    g = rng.randn(1, 8, 128, 27).astype(np.float32)
    jda, jdv = (np.asarray(x) for x in jax.jit(lambda a, v, c: jax.vjp(
        lambda a, v: jgn._windowed_aggregate(a, v, 32), a, v)[1](c))(
        jnp.asarray(ae), jnp.asarray(vals), jnp.asarray(g)))
    da, dv = tgn.gn_window_aggregate_backward_plain(_t(g), _t(ae), _t(vals))
    # the sums of |terms|: |s G| for dvals, 2 |u| (|a_i| + |a_j|) for dae
    sa, sv = (x.numpy() for x in tgn.gn_window_aggregate_backward_terms(
        _t(g), _t(ae), _t(vals)))
    assert (np.abs(dv.numpy() - jdv) <= 1e-5 * sv + 1e-7).all()
    assert (np.abs(da.numpy() - jda) <= 1e-5 * sa + 1e-7).all()
    ta, tv = _t(ae).requires_grad_(), _t(vals).requires_grad_()
    tgn.gn_window_aggregate(ta, tv).backward(_t(g))
    assert torch.equal(ta.grad, da) and torch.equal(tv.grad, dv)


def test_gn_backward_matches_dense_build_system_vjp():
    """8x16, where codd_tpu's training runs its dense form: the gradient of
    the normal equations with respect to ae, target and weight, the port's
    ``build_system`` (kernel 5's route, the Function with its plain
    backward) against ``jax.vjp`` of codd_tpu's ``build_system``.  target
    and weight: 1e-5 of the largest value (measured 1.1e-6).  ae: each
    element to 1e-5 of its sum of |terms| (measured below 1e-6): the value
    field's entries reach ~1e3, so the 27-wide dots and the two sums of
    dae = -2 (rowsum(U) a - U a) cancel (both sides: 2.2e-5 and 6.6e-5 of
    the largest value from an f64 evaluation of codd_tpu's form)."""
    arrs = _gn_field(8, 16, seed=4)
    Ts, ae, target, weight, depth, intr = arrs
    rng = np.random.RandomState(5)
    gH = rng.randn(1, 8, 16, 6, 6).astype(np.float32)
    gH = gH + gH.transpose(0, 1, 2, 4, 3)   # a symmetric cotangent
    gb = rng.randn(1, 8, 16, 6).astype(np.float32)
    assert jgn.resolve_impl("auto", 32, 16) == "dense"
    ref = [np.asarray(x) for x in jax.jit(lambda a, t, wt, c: jax.vjp(
        lambda a, t, wt: jgn.build_system(
            jnp.asarray(Ts), a, t, wt, jnp.asarray(depth), jnp.asarray(intr)),
        a, t, wt)[1](c))(jnp.asarray(ae), jnp.asarray(target),
                         jnp.asarray(weight),
                         (jnp.asarray(gH), jnp.asarray(gb)))]
    ins = [_t(a).requires_grad_() for a in (ae, target, weight)]
    calls = []
    real = tgn.gn_window_aggregate_backward
    tgn.gn_window_aggregate_backward = lambda *a: calls.append(1) or real(*a)
    try:
        Hm, bv = tgn.build_system(_t(Ts), ins[0], ins[1], ins[2], _t(depth),
                                  _t(intr), impl="auto")
        torch.autograd.backward([Hm, bv], [_t(gH), _t(gb)])
    finally:
        tgn.gn_window_aggregate_backward = real
    assert calls == [1]   # kernel 5's route, not autograd of the dense form
    agg = torch.zeros(1, 8, 16, 27, requires_grad=True)
    torch.autograd.backward([tgn.sym_unpack(agg[..., :21]), agg[..., 21:]],
                            [_t(gH), _t(gb)])
    vals = tgn.build_vals(*(_t(a) for a in (Ts, target, weight, depth, intr)))
    terms, _ = tgn.gn_window_aggregate_backward_terms(agg.grad, _t(ae),
                                                      vals)
    assert (np.abs(ins[0].grad.numpy() - ref[0]) <= 1e-5 * terms.numpy()
            ).all()
    for name, t, r in zip(("target", "weight"), ins[1:], ref[1:]):
        assert rel(t.grad.numpy(), r) < 1e-5, name


def test_se3_log_where_codd_tpu_overflows():
    """Rotations of 1e-4 to 3.4e-4 rad lie above codd_tpu's Taylor
    threshold (theta^2 < 1e-8); below ~2.2e-4 rad 1 - cos t still rounds
    to 0 in f32, and there codd_tpu's log returns inf, which turned a
    training loss on the card NaN (ROADMAP Queue 3).  The port takes the
    series there: finite, to 1e-6 of the f64 log, with a finite gradient.
    Elsewhere it is codd_tpu's expression, which stays finite but
    inaccurate up to ~1e-2 rad (D's cancellation; Queue 3)."""
    rng = np.random.RandomState(9)
    ax = rng.randn(40, 3)
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    ang = np.concatenate([np.linspace(1.2e-4, 3.3e-4, 20),
                          np.linspace(1e-3, 0.5, 20)])[:, None]
    q = np.concatenate([np.sin(ang / 2) * ax, np.cos(ang / 2)], -1)
    g = np.concatenate([rng.randn(40, 3), q], -1).astype(np.float32)
    ref = np.asarray(jse3.log(jnp.asarray(g)))
    gt = _t(g).requires_grad_()
    got = tgn.se3.log(gt)
    got.sum().backward()
    bad = ~np.isfinite(ref).all(-1)                # codd_tpu overflows
    assert bad[:20].sum() >= 5 and not bad[20:].any()
    assert torch.isfinite(got).all()
    # 1e-3 rad and above: the same expression (libm's sin, cos and atan2
    # differ by an ulp or two between the frameworks)
    np.testing.assert_allclose(got.detach().numpy()[20:], ref[20:],
                               rtol=1e-5, atol=1e-6)
    assert torch.isfinite(gt.grad).all()
    # f64: V^-1 t with the exact D = (1 - A / (2B)) / theta^2
    w = 2 * np.arctan2(np.linalg.norm(q[:, :3], axis=-1), q[:, 3])[:, None] \
        * q[:, :3] / np.linalg.norm(q[:, :3], axis=-1, keepdims=True)
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    D = (1 - (np.sin(th) / th) / (2 * (1 - np.cos(th)) / th ** 2)) / th ** 2
    t = g[:, :3].astype(np.float64)
    wxt = np.cross(w, t)
    v = t - 0.5 * wxt + D * np.cross(w, wxt)
    assert np.abs(got.detach().numpy()[bad, :3] - v[bad]).max() < 1e-6


def test_upsample_se3_finite_where_codd_tpu_overflows():
    """The eval branch through such a rotation: ``upsample_se3`` (log,
    convex upsampling, exp; every GN iteration's output and RAFT-3D's
    result) on a 4x6 field whose pixel (1, 2) turns by 1.6e-4 rad.
    codd_tpu's log is inf there, and the 3x3 convex upsampling carries it
    into the 9 coarse pixels around it; the port's field is finite
    everywhere and, on every fine pixel that codd_tpu gives finite, equal
    to codd_tpu's to 1e-5 (the same expression; libm's sin, cos and
    atan2 differ by an ulp or two between the frameworks)."""
    rng = np.random.RandomState(10)
    ax = rng.randn(1, 4, 6, 3)
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    ang = rng.uniform(1e-2, 0.3, (1, 4, 6, 1))
    ang[0, 1, 2] = 1.6e-4
    q = np.concatenate([np.sin(ang / 2) * ax, np.cos(ang / 2)], -1)
    Ts = np.concatenate([rng.randn(1, 4, 6, 3), q], -1).astype(np.float32)
    mask = rng.randn(1, 4, 6, 9 * 64).astype(np.float32)
    assert not np.isfinite(np.asarray(jse3.log(jnp.asarray(Ts)))[0, 1, 2]
                           ).all()
    ref = np.asarray(jup.upsample_se3(jnp.asarray(Ts), jnp.asarray(mask)))
    got = tup.upsample_se3(_t(Ts), _t(mask)).numpy()
    bad = ~np.isfinite(ref).all(-1)
    coarse = bad.reshape(1, 4, 8, 6, 8).any((2, 4))
    assert coarse[0, :3, 1:4].all() and coarse.sum() == 9
    assert bad.reshape(1, 4, 8, 6, 8)[0, :3, :, 1:4].all()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[~bad], ref[~bad], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the motion stage
# ---------------------------------------------------------------------------

def _jax_loss_fn(jm, lc, batch):
    def f(v):
        outs = jm.apply(v, batch["l_img"], batch["r_img"],
                        batch["intrinsics"], train=True)
        loss, logs = jassembly.codd_train_loss(lc, outs, batch)
        return loss, (logs, outs[1])
    return f


@pytest.fixture(scope="module")
def motion_stage():
    cfg = _cfg("stereo_motion.py", f"model.motion.iters={ITERS}")
    batch = _batch()
    jm, lc = jbuild(cfg), jbuild_loss(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes, seed=3)
    (loss, (logs, out1)), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jm, lc, batch), has_aux=True))(variables)
    return dict(cfg=cfg, batch=batch, variables=variables, loss=float(loss),
                logs=_np(logs), out1=_np({k: out1[k] for k in (
                    "flow2d_est", "flow2d_rev")}),
                jgrads=_np(grads),
                grads=torch_state_dict_from_jax(_np(grads)))


def _port(cfg, variables):
    m = build_estimator(cfg, device="cpu", seed=None)
    m.load_state_dict(torch_state_dict_from_jax(variables), strict=True)
    return m


@pytest.fixture(scope="module")
def motion_port(motion_stage):
    """The port's loss and gradients; the cotangents at RAFT-3D's clipped
    heads are recorded to show how far each lies from the 0.01 edge."""
    s = motion_stage
    model = _port(s["cfg"], s["variables"])
    margins, real = [], traft.grad_clip

    def clip(x, c=0.01):
        y = real(x, c)
        if y.requires_grad:
            y.register_hook(lambda g: margins.append(
                float((g.abs() / c - 1).abs().min())))
        return y

    traft.grad_clip = clip
    try:
        tb = {k: _t(v) for k, v in s["batch"].items()}
        outs = model(tb["l_img"], tb["r_img"], tb["intrinsics"], train=True)
        loss, logs = assembly.codd_train_loss(build_loss_config(s["cfg"]),
                                              outs, tb)
        loss.backward()
    finally:
        traft.grad_clip = real
    return dict(loss=loss.item(), logs={k: v.item() for k, v in logs.items()},
                out1=outs[1], margins=margins,
                grads={k: (None if p.grad is None else p.grad.numpy().copy())
                       for k, p in model.named_parameters()})


def test_raft3d_supervision_matches(motion_stage, motion_port):
    """Every iteration's full-res ``flow2d_est`` and ``flow2d_rev``: f32
    rounding through the encoders, the bf16 correlations and two GN
    solves, 1e-4 of each output's largest value (as the eval branch)."""
    for k in ("flow2d_est", "flow2d_rev"):
        got, ref = motion_port["out1"][k], motion_stage["out1"][k]
        assert len(got) == len(ref) == ITERS
        for g, r in zip(got, ref):
            assert tuple(g.shape) == r.shape
            assert rel(g.detach().numpy(), r) < 1e-4, k


def _noise(grads):
    """Parameters whose gradient vanishes by invariance (the biases in
    front of fnet's instance norms; the ae head's bias, which every logit
    difference cancels): codd_tpu's is f32 noise below 1e-6 of the largest
    gradient norm (measured ~1e-10 of it)."""
    norms = {k: float(np.linalg.norm(g.numpy())) for k, g in grads.items()}
    top = max(norms.values())
    return {k for k, n in norms.items() if 0 < n <= 1e-6 * top}, top


def test_motion_stage_loss_and_gradients(motion_stage, motion_port):
    """The loss to 1e-5 relative, each log to 1e-4.  Every motion
    parameter's gradient to 5e-3 of its norm (measured 2.8e-3, in the
    update block's and HRNet's small tensors: f32 sums in other orders
    through two GN solves and their backward), fnet's to 2e-2 (measured
    7.5e-3 to 1.0e-2): fnet's gradient arrives through the correlation
    pyramid's bf16 cotangents, which codd_tpu scatter-adds in bf16 (0.7-1.3
    % of the norm from f64 sums, test_patch_backward_matches_jax_vjp) and
    the port sums in f32 with one rounding.  Gradients that vanish by
    invariance (``_noise``) are held to 1e-6 of the largest norm.  No
    head cotangent lies within 1e-4 of the clip's 0.01 edge (the closest
    measured: 3.1e-4 of it), so no element flips between the runs.  Stereo
    has no gradient (codd_tpu's are zero)."""
    s, p = motion_stage, motion_port
    assert rel(p["loss"], s["loss"]) < 1e-5
    assert set(p["logs"]) == set(s["logs"]) and "loss_warp1" in p["logs"]
    for k, v in s["logs"].items():
        assert rel(p["logs"][k], v) < 1e-4, k
    assert min(p["margins"]) > 1e-4
    noise, top = _noise(s["grads"])
    assert noise and all(k.endswith("bias") for k in noise)
    checked = 0
    for k, g in p["grads"].items():
        ref = s["grads"][k].numpy()
        if k.startswith("stereo."):
            assert g is None and not np.any(ref), k
            continue
        if not np.any(ref):
            assert g is None or not np.any(g), k
            continue
        assert g is not None, k
        diff = float(np.linalg.norm(g.astype(np.float64) - ref))
        if k in noise:
            assert diff <= 1e-6 * top, k
            continue
        bound = 2e-2 if k.startswith("motion.raft3d.fnet.") else 5e-3
        assert diff <= bound * float(np.linalg.norm(ref)), (k, diff)
        checked += 1
    assert checked > 400


def _jax_update(jtx, jp, jg):
    """codd_tpu's ``make_train_step`` after its ``value_and_grad``, on
    given gradients and a fresh optimizer state: the global norm, the
    per-element non-finite zeroing, the update, ``apply_updates``.
    Returns (grad_norm, params)."""
    gnorm = optax.global_norm(jg)
    jg = jax.tree_util.tree_map(
        lambda g: jnp.where(jnp.isfinite(g), g, jnp.zeros_like(g)), jg)
    upd, _ = jtx.update(jg, jtx.init(jp), jp)
    return gnorm, optax.apply_updates(jp, upd)


class _StandIn:
    """A model with codd_tpu's ``apply`` signature whose outputs are the
    motion stage's (``pred_disp``; ``flow2d_est`` and ``flow2d_rev`` of two
    iterations), a few products of its parameters and the images.  The
    square root of ``z``, whose first element is 0, gives that element an
    infinite gradient, so the step's non-finite zeroing does work."""

    def apply(self, variables, l_img, r_img, intrinsics, train=False,
              gt_seq=None):
        p = variables["params"]
        outs = []
        for t in range(l_img.shape[1]):
            x = l_img[:, t]
            out = {"pred_disp": x[..., :1] * p["stereo"]["w"]}
            if t:
                est = x @ p["motion"]["a"] + jnp.sqrt(p["motion"]["z"])
                rev = r_img[:, t, ..., :2] * p["motion"]["b"]
                out["flow2d_est"] = [0.5 * est, est]
                out["flow2d_rev"] = [0.5 * rev, rev]
            outs.append(out)
        return outs


def test_jax_update_is_codd_tpu_train_step():
    """``_jax_update`` against codd_tpu's own ``make_train_step`` (the
    motion stage's loss config and optimizer: OneCycle 2e-4, clip 1.0,
    stereo frozen) on ``_StandIn`` at 8x16: the same grad_norm (inf, from
    the non-finite element) and the same parameters to 1e-7 of lr (one
    Adam step of about lr a parameter; XLA may fuse the two graphs
    differently)."""
    rng = np.random.RandomState(11)
    variables = {"params": {
        "stereo": {"w": rng.rand(1).astype(np.float32)},
        "motion": {"a": rng.randn(3, 3).astype(np.float32),
                   "b": rng.randn(2).astype(np.float32),
                   "z": np.array([0.0, 0.5, 2.0], np.float32)}}}
    full = _batch(seed=12)
    batch = {k: jnp.asarray(v[:, :, :8, :16] if v.ndim == 5 else v)
             for k, v in full.items()}
    lc = jbuild_loss(_cfg("stereo_motion.py"))
    assert lc.motion and not lc.stereo and not lc.fusion
    sched = joptim.one_cycle_schedule(2e-4, 25000)
    jp = jax.tree_util.tree_map(jnp.asarray, variables)
    jtx = joptim.make_optimizer(sched, 1.0, params=jp,
                                frozen_prefixes=["stereo"])
    model = _StandIn()
    state, logs = jtrainer.make_train_step(model, jtx, lc)(
        jtrainer.create_train_state(jp, jtx), batch)

    def loss(v):
        outs = model.apply(v, batch["l_img"], batch["r_img"],
                           batch["intrinsics"], train=True)
        return jassembly.codd_train_loss(lc, outs, batch)[0]

    jg = jax.grad(loss)(jp)
    assert not np.isfinite(np.asarray(jg["params"]["motion"]["z"][0]))
    gnorm, after = jax.jit(lambda p, g: _jax_update(jtx, p, g))(jp, jg)
    assert float(gnorm) == float(logs["grad_norm"]) == np.inf
    lr = float(sched(0))
    for a, b, p0 in zip(jax.tree_util.tree_leaves(after),
                        jax.tree_util.tree_leaves(state.params),
                        jax.tree_util.tree_leaves(jp)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7 * lr)
    assert np.asarray(after["params"]["stereo"]["w"]) == variables[
        "params"]["stereo"]["w"]
    moved = np.abs(np.asarray(after["params"]["motion"]["a"])
                   - variables["params"]["motion"]["a"])
    assert (moved > 0.5 * lr).all()


def test_motion_train_step_matches(motion_stage):
    """One step of the port's ``make_train_step`` (OneCycle 2e-4 peak as
    schedule_motion.py, at step 0; clip 1.0; stereo frozen) against
    codd_tpu's optimizer applied to codd_tpu's gradients: the loss to
    1e-5, grad_norm to 1e-3 (the gradients' 2e-3 above, mostly fnet's),
    and the updates where |g| > 2e-2 of the tensor's largest gradient to
    1e-6 + 1e-3 of lr (Adam's first step is about lr * sign(g): it
    amplifies the f32 error of a near-zero gradient up to a flipped sign,
    so elsewhere, and in the tensors whose gradient is noise, within
    2 lr)."""
    s = motion_stage
    sched_t = optim.one_cycle_schedule(2e-4, 25000)
    sched_j = joptim.one_cycle_schedule(2e-4, 25000)
    jp = jax.tree_util.tree_map(jnp.asarray, s["variables"])
    jg = jax.tree_util.tree_map(jnp.asarray, s["jgrads"])
    jtx = joptim.make_optimizer(sched_j, 1.0, params=jp,
                                frozen_prefixes=["stereo"])
    gnorm, after = jax.jit(lambda p, g: _jax_update(jtx, p, g))(jp, jg)
    gnorm, after = float(gnorm), torch_state_dict_from_jax(_np(after))
    ref = s["grads"]

    model = _port(s["cfg"], s["variables"])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tx = optim.make_optimizer(sched_t, 1.0, dict(model.named_parameters()),
                              ["stereo"])
    step = trainer.make_train_step(model, tx, build_loss_config(s["cfg"]))
    state, logs = step(trainer.create_train_state(model, tx),
                       {k: _t(v) for k, v in s["batch"].items()})
    assert state.opt_state.count == 1
    assert rel(logs["loss"].item(), s["loss"]) < 1e-5
    assert rel(logs["grad_norm"].item(), gnorm) < 1e-3
    lr = sched_t(0)
    noise, _ = _noise(ref)
    for k, p in model.named_parameters():
        d = (p.detach() - before[k]).numpy()
        dj = after[k].numpy() - before[k].numpy()
        if k.startswith("stereo."):
            assert not np.any(d) and not np.any(dj), k
            continue
        err = np.abs(d - dj)
        g = np.abs(ref[k].numpy())
        assert err.max() <= 2 * lr + 1e-6, k
        if k not in noise:   # below Adam's eps a noise gradient is the update
            assert err[g > 2e-2 * g.max()].max(initial=0.0) <= 1e-3 * lr \
                + 1e-6, k


# ---------------------------------------------------------------------------
# what the motion stage does not train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["fused", "volume", "bf16_scores"])
def test_motion_training_raises(case):
    """bf16 scores and the fused GN solve raise only where codd_tpu would
    run them, on its windowed form: at a 1/8-res width of 128 (a 64x1024
    frame); at the other widths both train as auto trains, with f32 scores
    (the tests below)."""
    width = 1024 if case in ("bf16_scores", "fused") else W
    rng = np.random.RandomState(0)
    args = (_t(rng.rand(1, T, H, width, 3)), _t(rng.rand(1, T, H, width, 3)),
            _t([[100.0, 100.0, width / 2, H / 2]]))
    opts = {"fused": ["model.runtime.gn_impl=fused"],
            "volume": ["model.runtime.corr_impl=volume_reduce"],
            "bf16_scores": ["model.runtime.gn_bf16_scores=True"]}
    model = build_estimator(_cfg("stereo_motion.py", "model.motion.iters=1",
                                 *opts[case]), device="cpu")
    with pytest.raises(NotImplementedError):
        model(*args, train=True)
    with torch.no_grad():  # the same configuration still runs in eval
        assert model(*args)[1]["flow2d_est_induced"].shape == (1, H, width,
                                                               3)


def _gn_step_grads(field, bf16_scores, impl="auto"):
    Ts, ae, target, weight, depth, intr = (_t(a) for a in field)
    ins = [x.requires_grad_() for x in (ae, target, weight)]
    out = tgn.gn_step(Ts, ins[0], ins[1], ins[2], depth, intr, impl=impl,
                      bf16_scores=bf16_scores)
    out.backward(torch.ones_like(out))
    return out.detach(), [x.grad for x in ins]


def test_gn_bf16_scores_train_with_f32_scores_where_dense():
    """A 48x96 field at 1/8 res (96 is not above 3 x 32): codd_tpu runs its
    dense form, which keeps f32 scores whatever gn_bf16_scores says, and
    trains.  Under autograd the port takes the f32 scores there too: the
    update and the gradients of ae, target and weight equal in bits to
    those with gn_bf16_scores=False."""
    field = _gn_field(48, 96, seed=4)
    assert tgn.resolve_impl("auto", 32, 96) == "dense"
    out_bf, g_bf = _gn_step_grads(field, True)
    out_f, g_f = _gn_step_grads(field, False)
    assert torch.equal(out_bf, out_f)
    for a, b in zip(g_bf, g_f):
        assert torch.equal(a, b)


def test_gn_fused_trains_as_auto_where_dense():
    """A 48x96 field at 1/8 res: codd_tpu resolves gn_impl="fused" to its
    dense form there and trains it.  Under autograd the port trains
    "fused" as "auto": the update and the gradients of ae, target and
    weight equal in bits to those with gn_impl="auto"."""
    field = _gn_field(48, 96, seed=6)
    assert jgn.resolve_impl("fused", 32, 96) == "dense"
    out_fu, g_fu = _gn_step_grads(field, False, "fused")
    out_au, g_au = _gn_step_grads(field, False, "auto")
    assert torch.equal(out_fu, out_au)
    for a, b in zip(g_fu, g_au):
        assert torch.equal(a, b)


def test_gn_bf16_scores_raise_where_windowed():
    """A 1/8-res width of 128: codd_tpu scores in bf16 on its windowed form,
    which has no VJP; the port raises under autograd and runs without it."""
    field = _gn_field(8, 128, seed=5)
    assert tgn.resolve_impl("auto", 32, 128) == "windowed"
    with pytest.raises(NotImplementedError):
        _gn_step_grads(field, True)
    with torch.no_grad():
        assert torch.isfinite(tgn.gn_step(*(_t(a) for a in field),
                                          bf16_scores=True)).all()
