"""The oracle variants of the port against codd_tpu's: ``gt_motion``,
``gt_fusion``, ``kalman_fusion`` directly, and CODD with every
``motion_type`` / ``fusion_type`` over a 3-frame clip on carried weights.

The oracle functions select, gather (nearest) and blend in one or two f32
operations, the same on both sides, so they agree to an ulp (atol 1e-6 at
O(10) disparities) or exactly.  The clips run the stereo net, whose
outputs agree to rel 1e-5 (test_torch_modules.py); the oracle stages
after it keep that.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.models.codd import CODD as JCODD
from codd_tpu.models.fusion import others as jfus
from codd_tpu.models.motion import others as jmot
from codd_torch.models.codd import CODD as TCODD
from codd_torch.models.fusion import others as tfus
from codd_torch.models.motion import others as tmot
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

B, T_FRAMES, H, W = 1, 3, 64, 128


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_gt_fusion_matches():
    rng = np.random.RandomState(0)
    shape = (2, 8, 12, 1)
    curr = rng.uniform(0, 20, shape).astype(np.float32)
    # errors within 1 px of each other, far apart, invalid warp, no gt
    warp = (curr + rng.choice([-3.0, -0.4, 0.0, 0.4, 3.0], shape)
            ).astype(np.float32)
    warp[0, :2] = 0.0
    gt = (curr + rng.uniform(-2, 2, shape)).astype(np.float32)
    gt[1, :2] = 0.0
    ref = jfus.gt_fusion(*(jnp.asarray(a) for a in (curr, warp, gt)))
    got = tfus.gt_fusion(T(curr), T(warp), T(gt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() == curr).any() and (got.numpy() == warp).any()


def test_kalman_fusion_matches():
    rng = np.random.RandomState(1)
    shape = (1, 8, 12, 1)
    curr = rng.uniform(1, 20, shape).astype(np.float32)
    warp = (curr + rng.choice([-3.0, -0.5, 0.5, 3.0], shape)).astype(np.float32)
    warp[0, 0] = 0.0
    P = rng.uniform(0, 1e-4, shape).astype(np.float32)
    ref, refP = jfus.kalman_fusion(jnp.asarray(curr), jnp.asarray(warp),
                                   jnp.asarray(P))
    got, gotP = tfus.kalman_fusion(T(curr), T(warp), T(P))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(gotP.numpy(), np.asarray(refP))
    # the constant gain (P+Q)/(P+Q+R) at P = 0 is one half
    mid, _ = tfus.kalman_fusion(T(np.full(shape, 10.5)),
                                T(np.full(shape, 10.0)), T(np.zeros(shape)))
    np.testing.assert_allclose(mid.numpy(), 10.25, atol=1e-6)


def _gt(rng):
    flow = rng.uniform(-3, 3, (B, T_FRAMES, H, W, 2)).astype(np.float32)
    flow[:, :, :8] = np.round(flow[:, :, :8] * 2) / 2    # ties at .5
    return {
        "gt_disp": rng.uniform(2, 40, (B, T_FRAMES, H, W, 1)
                               ).astype(np.float32),
        "gt_flow": flow,
        "gt_disp_change": rng.uniform(-1, 1, (B, T_FRAMES, H, W, 1)
                                      ).astype(np.float32),
        "gt_flow_occ": (rng.rand(B, T_FRAMES, H, W, 1) > 0.9
                        ).astype(np.float32),
    }


def test_gt_motion_matches():
    """Nearest-mode warps: exact, including the kept quirk that the 1/4-res
    feature warp reads the full-res flow values at [2::4] unscaled."""
    rng = np.random.RandomState(2)
    gt = {k: v[:, 1] for k, v in _gt(rng).items()}
    img = rng.rand(B, H, W, 3).astype(np.float32)
    feat = rng.randn(B, H // 4, W // 4, 24).astype(np.float32)
    disp = rng.uniform(1, 40, (B, H, W)).astype(np.float32)
    args = (img, feat, disp, gt["gt_flow"], gt["gt_disp_change"],
            gt["gt_flow_occ"])
    rmem, rTs = jmot.gt_motion(*(jnp.asarray(a) for a in args))
    gmem, gTs = tmot.gt_motion(*(T(a) for a in args))
    assert len(gmem) == len(rmem) == 5
    for g, r in zip(gmem, rmem):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gTs.numpy(), np.asarray(rTs))
    # the quirk: features move by the full-res flow, not a quarter of it
    moved = gmem[1].numpy() != feat
    assert moved.mean() > 0.5


@pytest.fixture(scope="module")
def stereo_weights():
    """One stereo net's weights serve every oracle variant (none of them
    has other parameters)."""
    rng = np.random.RandomState(3)
    left = rng.rand(B, T_FRAMES, H, W, 3).astype(np.float32)
    right = rng.rand(B, T_FRAMES, H, W, 3).astype(np.float32)
    intr = np.array([[100.0, 100.0, W / 2, H / 2]], np.float32)
    jm = JCODD(max_disp=64, motion_type="none", fusion_type="none")
    variables = jax.jit(lambda k: jm.init(k, left[:, :2], right[:, :2],
                                          intr))(jax.random.PRNGKey(0))
    return left, right, intr, _gt(rng), variables


@pytest.mark.parametrize("mtype,ftype", [
    ("GTMotion", "GTFusion"), ("GTMotion", "KalmanFusion"),
    ("GTMotion", "NullFusion"), ("none", "KalmanFusion"), ("none", "none")])
def test_codd_oracle_variants(stereo_weights, mtype, ftype):
    left, right, intr, gt, variables = stereo_weights
    jm = JCODD(max_disp=64, motion_type=mtype, fusion_type=ftype)
    j_outs = _np(jax.jit(lambda v: jm.apply(
        v, left, right, intr,
        gt_seq={k: jnp.asarray(a) for k, a in gt.items()}))(variables))
    tm = TCODD(max_disp=64, motion_type=mtype, fusion_type=ftype).eval()
    tm.load_state_dict(torch_state_dict_from_jax(_np(variables)), strict=True)
    t_outs = tm(T(left), T(right), T(intr),
                gt_seq={k: T(a) for k, a in gt.items()})
    assert len(t_outs) == len(j_outs) == T_FRAMES
    for t, (to, jo) in enumerate(zip(t_outs, j_outs)):
        keys = {"pred_disp"} | ({"pred_curr", "pred_warp"} & set(jo))
        if mtype == "GTMotion" and t:
            keys.add("Ts")
        assert keys <= set(to), (t, keys - set(to))
        assert ("pred_warp" in to) == ("pred_warp" in jo)
        for k in keys:
            a, b = to[k].numpy(), jo[k]
            assert a.shape == b.shape, k
            # a stereo argmax near-tie may flip a pixel: bound their share
            off = np.abs(a - b) > 1e-4 * (1 + np.abs(b))
            assert off.mean() < 1e-3, (t, k, off.mean())


def test_step_needs_gt_and_train_raises():
    tm = TCODD(max_disp=64, motion_type="GTMotion",
               fusion_type="GTFusion").eval()
    x = torch.zeros(1, 2, 64, 128, 3)
    intr = torch.tensor([[100.0, 100.0, 64.0, 32.0]])
    # a trainable RAFT-3D under a trainable fusion: the warped memory is
    # differentiable (the training splat), no longer a raise
    outs = TCODD(max_disp=64, iters=1)(x, x, intr, train=True)
    assert outs[1]["pred_warp"].requires_grad
    with pytest.raises(TypeError):
        tm(x, x, intr)            # GTMotion without ground truth
    with pytest.raises(ValueError):
        TCODD(motion_type="Flow")
