"""The whole slice: CODD(max_disp=64, iters=2) streaming at 64x128 through
``first_step`` and two ``step`` calls, codd_torch (plain versions of the
four kernels, on the CPU) against codd_tpu on the weights of its own
``model.init``, carried over by ``torch_state_dict_from_jax``.

Two comparisons:

* teacher-forced: the port runs each step on codd_tpu's carry of the
  step before, so every step starts from the same state.  Everything not
  downstream of the splat agrees to f32 rounding (rel 1e-4 after two GN
  iterations through bf16 correlations).  The splat outputs
  (Motion's warped memory) are held on the pixels where codd_tpu's result
  is defined: it sorts fragments with an unstable sort on a key holding
  only the top bits of z (18 at 64x128), so fragments of one pixel with
  equal keys composite in arbitrary order ("tie" pixels, counted and
  excluded); and it takes each pixel's sums as differences of a global f32
  cumsum, whose rounding grows with the running sum (that bound is the
  tolerance).  Pixels whose fragment set differs between the two sides'
  points (a fragment on the rim of the splat radius) are excluded too.
  The fusion outputs depend on the splat over a wide receptive field, so
  for them the share of pixels off by more than 1e-3 relative is
  reported and bounded.
* free-running: the port streams on its own carry; the shares of pixels
  that moved are reported and bounded.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.models.codd import CODD as JCODD
from codd_tpu.models.motion.motion import Motion as JMotion
from codd_torch.models.codd import CODD as TCODD, CoddCarry
from codd_torch.models.motion.motion import disp_to_depth
from codd_torch.ops import se3, splat
from codd_torch.ops.projective import inv_project
from codd_torch.utils.params import torch_state_dict_from_jax

B, T_FRAMES, H, W = 1, 3, 64, 128
CARRY = ("memory_img", "memory_feat", "memory_disp", "fmap", "netinp")
EPS = np.finfo(np.float32).eps


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture(scope="module")
def slice_run():
    rng = np.random.RandomState(0)
    left = rng.rand(B, T_FRAMES, H, W, 3).astype(np.float32)
    right = rng.rand(B, T_FRAMES, H, W, 3).astype(np.float32)
    intr = np.array([[100.0, 100.0, W / 2, H / 2]], np.float32)
    jm = JCODD(max_disp=64, iters=2)
    variables = jax.jit(lambda k: jm.init(k, left[:, :2], right[:, :2],
                                          intr))(jax.random.PRNGKey(0))
    first = jax.jit(lambda v, l, r, i: jm.apply(v, l, r, i,
                                                method=JCODD.first_step))
    motion_only = lambda mdl, name: isinstance(mdl, JMotion) and \
        name == "__call__"
    step = jax.jit(lambda v, c, l, r, i: jm.apply(
        v, c, l, r, i, method=JCODD.step, capture_intermediates=motion_only,
        mutable=["intermediates"]))
    carry, out = first(variables, left[:, 0], right[:, 0], intr)
    j_out, j_carry, j_motion = [out], [carry], [None]
    for t in range(1, T_FRAMES):
        (carry, out), inter = step(variables, carry, left[:, t],
                                   right[:, t], intr)
        j_out.append(out)
        j_carry.append(carry)
        j_motion.append(inter["intermediates"]["motion"]["__call__"][0])
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray,
                                              jax.device_get(tree))
    j_out, j_motion = np_(j_out), np_(j_motion)
    j_carry = [{k: np.asarray(getattr(c, k)) for k in CARRY}
               for c in j_carry]

    tm = TCODD(max_disp=64, iters=2).eval()
    tm.load_state_dict(torch_state_dict_from_jax(np_(variables)),
                       strict=True)
    captured = []
    tm.motion.register_forward_hook(
        lambda mod, args, res: captured.append(res[0]))
    L = [_t(left[:, t]) for t in range(T_FRAMES)]
    R = [_t(right[:, t]) for t in range(T_FRAMES)]
    I = _t(intr)

    def carry_from(d):
        return CoddCarry(**{k: _t(d[k]) for k in CARRY})

    carry, out = tm.first_step(L[0], R[0], I)
    forced_out, forced_carry, forced_motion = [out], [carry], [None]
    for t in range(1, T_FRAMES):
        carry, out = tm.step(carry_from(j_carry[t - 1]), L[t], R[t], I)
        forced_out.append(out)
        forced_carry.append(carry)
        forced_motion.append(captured[-1])
    carry, out = tm.first_step(L[0], R[0], I)
    free_out = [out]
    for t in range(1, T_FRAMES):
        carry, out = tm.step(carry, L[t], R[t], I)
        free_out.append(out)
    return dict(intr=intr, j_out=j_out, j_carry=j_carry, j_motion=j_motion,
                forced_out=forced_out, forced_carry=forced_carry,
                forced_motion=forced_motion, free_out=free_out)


def test_frame0_outputs_and_carry(slice_run):
    j, t = slice_run["j_out"][0], slice_run["forced_out"][0]
    for k in ("pred_disp", "left_feat", "right_feat", "left_img"):
        assert t[k].shape == j[k].shape and rel(t[k], j[k]) < 1e-5, k
    for k in CARRY:
        got = getattr(slice_run["forced_carry"][0], k)
        assert rel(got, slice_run["j_carry"][0][k]) < 1e-5, k


@pytest.mark.parametrize("frame", [1, 2])
def test_step_outputs_not_downstream_of_the_splat(slice_run, frame):
    j, t = slice_run["j_out"][frame], slice_run["forced_out"][frame]
    for k in ("pred_curr", "left_feat", "right_feat"):
        assert rel(t[k], j[k]) < 1e-5, k
    for k in ("Ts", "flow2d_est_induced", "weight"):
        assert t[k].shape == j[k].shape and rel(t[k], j[k]) < 1e-4, k
    for k in ("memory_feat", "fmap", "netinp", "memory_img"):
        got = getattr(slice_run["forced_carry"][frame], k)
        assert rel(got, slice_run["j_carry"][frame][k]) < 1e-5, k


def _splat_reference_mask(points, feats, intr, h, w, radius, points_alt):
    """Pixels where codd_tpu's splat is defined, and its cumsum error
    bound.  points are codd_tpu's, points_alt the port's."""
    order, offsets, alpha, Z = splat.sort_fragments(points, intr, h, w,
                                                    radius)
    npix = h * w
    N = Z.shape[0]
    z_bits = 32 - (npix + 1).bit_length()
    counts = offsets[1:] - offsets[:-1]
    pid = torch.repeat_interleave(torch.arange(npix), counts)
    zq = splat._quantize_z(Z, z_bits)[order[:int(offsets[-1])] % N]
    rank = torch.arange(len(pid)) - offsets[:-1][pid]
    same = (pid[1:] == pid[:-1]) & (zq[1:] == zq[:-1]) & (rank[:-1] < 8)
    tie = torch.zeros(npix, dtype=torch.bool)
    tie[pid[1:][same]] = True
    _, offsets_alt, _, _ = splat.sort_fragments(points_alt, intr, h, w,
                                                radius)
    rim = (offsets_alt[1:] - offsets_alt[:-1]) != counts
    # running sums of |weighted payload|, |head z| and the count, in pixel
    # order: f32 cumsum rounding is within a few ulps of them
    aout, azb, cnt = splat.composite_plain(order, offsets, alpha, Z.abs(),
                                           feats.abs())
    run = torch.cumsum(torch.cat([aout, azb[:, None], cnt[:, None]], 1)
                       .double(), 0)
    bound = 8 * EPS * run
    return ((tie | rim).reshape(h, w).numpy(),
            bound[:, :-2].reshape(h, w, -1).numpy(),
            bound[:, -2].reshape(h, w).numpy())


@pytest.mark.parametrize("frame", [1, 2])
def test_motion_warped_memory(slice_run, frame):
    """Motion's splats (kernel 4's plain version) against codd_tpu's
    xla_gather splat, teacher-forced: flow/confidence/disparity warps at
    full res and the feature warp at 1/4 res."""
    intr = _t(slice_run["intr"])
    jmem = slice_run["j_motion"][frame][0]
    tmem = [m.numpy() for m in slice_run["forced_motion"][frame]]
    j, t = slice_run["j_out"][frame], slice_run["forced_out"][frame]
    depth = disp_to_depth(_t(slice_run["j_carry"][frame - 1]["memory_disp"]))
    feat_prev = _t(slice_run["j_carry"][frame - 1]["memory_feat"])

    def points(Ts, s):
        o = s // 2 - 1 if s > 1 else 0
        d = depth[:, o::s, o::s] if s > 1 else depth
        T_ = _t(Ts)[:, o::s, o::s] if s > 1 else _t(Ts)
        return se3.act(T_, inv_project(d, intr / s)).reshape(-1, 3)

    shares = {}
    # full res: [flow (3) | confidence (3)] and the disparity from z
    feats = _t(np.concatenate([j["flow2d_est_induced"], j["weight"]], -1)
               ).reshape(-1, 6)
    excl, bound, zbound = _splat_reference_mask(
        points(j["Ts"], 1), feats, intr[0], H, W, 1.0,
        points(t["Ts"].numpy(), 1))
    shares["full"] = excl.mean()
    keep = ~excl[None]
    for idx, ch in ((4, slice(0, 3)), (2, slice(3, 6))):  # flow, confidence
        d = np.abs(tmem[idx] - jmem[idx])
        tol = bound[None, ..., ch] + 1e-4 * (1 + np.abs(jmem[idx]))
        assert (d <= tol)[np.broadcast_to(keep[..., None], d.shape)].all()
    jd, td = jmem[3], tmem[3]
    zj = np.where(jd > 0, 210.0 / np.maximum(jd, 1e-30), 0.0)
    dtol = 210.0 * zbound[None] / np.maximum(zj - zbound[None], 1e-6) ** 2
    near_w = np.abs(jd - W) <= dtol  # the disp > W -> 0 cut is ill-defined
    ok = np.abs(td - jd) <= dtol + 1e-4 * (1 + np.abs(jd))
    assert ok[keep & ~near_w].all()
    # quarter res: the fusion features, C=32, r=2
    excl4, bound4, _ = _splat_reference_mask(
        points(j["Ts"], 4), feat_prev.reshape(-1, 32), intr[0] / 4,
        H // 4, W // 4, 2.0, points(t["Ts"].numpy(), 4))
    shares["quarter"] = excl4.mean()
    d = np.abs(tmem[1] - jmem[1])
    tol = bound4[None] + 1e-4 * (1 + np.abs(jmem[1]))
    assert (d <= tol)[np.broadcast_to(~excl4[None, ..., None], d.shape)].all()
    print(f"frame {frame}: excluded (tie or rim) pixel share {shares}")
    assert shares["full"] < 0.5 and shares["quarter"] < 0.5


@pytest.mark.parametrize("frame", [1, 2])
def test_fusion_outputs_teacher_forced(slice_run, frame):
    j, t = slice_run["j_out"][frame], slice_run["forced_out"][frame]
    for k in ("pred_warp", "pred_disp", "fusion_weights", "reset_weights"):
        a, b = t[k].numpy(), j[k]
        assert a.shape == b.shape and np.isfinite(a).all()
        off = np.abs(a - b) > 1e-3 * (1 + np.abs(b))
        print(f"frame {frame} {k}: share off by > 1e-3 rel {off.mean():.4f}"
              f", max |d| {np.abs(a - b).max():.3g}")
        # where splat ties change the order, values move; elsewhere equal
        assert off.mean() < 0.35, (k, off.mean())
        assert np.median(np.abs(a - b)) < 1e-3 * (1 + np.median(np.abs(b)))


def test_free_running_stream(slice_run):
    for frame in (1, 2):
        j, t = slice_run["j_out"][frame], slice_run["free_out"][frame]
        assert rel(t["pred_curr"], j["pred_curr"]) < 1e-5
        for k in ("Ts", "pred_disp", "pred_warp"):
            a, b = t[k].numpy(), j[k]
            off = np.abs(a - b) > 1e-3 * (1 + np.abs(b))
            print(f"free-running frame {frame} {k}: share off {off.mean():.4f}")
            assert np.isfinite(a).all() and off.mean() < 0.35, (k, frame)
