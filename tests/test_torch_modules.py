"""codd_torch modules against their codd_tpu counterparts: weights from
the flax module's own ``init``, carried over by
``torch_state_dict_from_jax`` (strict load: every leaf maps to one
torch parameter or buffer and back), same numpy inputs.

Tolerances are relative to the output's magnitude: convolution stacks sum
in another order than XLA, so outputs agree to ~1e-5 relative; the HITNet
output goes through argmin/argmax/floor decisions, which agree here
because the inputs do not sit on a tie."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.models.fusion.fusion import Fusion as JFusion
from codd_tpu.models.motion import encoders as jenc
from codd_tpu.models.motion import hrnet as jhr
from codd_tpu.models.motion import raft3d as jraft
from codd_tpu.models.stereo import hitnet as jhit
from codd_torch.models.fusion.fusion import Fusion as TFusion
from codd_torch.models.motion import encoders as tenc
from codd_torch.models.motion import hrnet as thr
from codd_torch.models.motion import raft3d as traft
from codd_torch.models.stereo import hitnet as thit
from codd_torch.utils.params import torch_state_dict_from_jax


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def bridge(jmod, tmod, *args, method=None, batch_stats_rng=None):
    """Init jmod on args, load its variables into tmod; return variables."""
    variables = jax.jit(lambda k: jmod.init(k, *args, method=method))(
        jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if batch_stats_rng is not None and "batch_stats" in variables:
        # non-trivial frozen statistics, so the BN buffers are exercised
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (batch_stats_rng.rand(*a.shape) + 0.5).astype(
                np.float32), variables["batch_stats"])
    tmod.load_state_dict(torch_state_dict_from_jax(variables), strict=True)
    return variables


def _imgs(H=64, W=128, seed=0, B=1):
    rng = np.random.RandomState(seed)
    return rng.rand(B, H, W, 3).astype(np.float32), \
        rng.rand(B, H, W, 3).astype(np.float32)


def test_hitunet():
    left, _ = _imgs()
    jm, tm = jhit.HITUNet(), thit.HITUNet()
    v = bridge(jm, tm, jnp.asarray(left))
    ref = jm.apply(v, jnp.asarray(left))
    got = tm(T(left))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and rel_err(g.detach(), r) < 1e-5


@pytest.mark.parametrize("D", [8, 20])
def test_calc_init_cost(D):
    rng = np.random.RandomState(D)
    fl = rng.randn(1, 3, 6, 16).astype(np.float32)
    fr = rng.randn(1, 3, 24, 16).astype(np.float32)
    ref = np.asarray(jhit.calc_init_cost(jnp.asarray(fl), jnp.asarray(fr), D,
                                         "unrolled"))
    got = thit.calc_init_cost(T(fl), T(fr), D, rows=2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_hitnet_stereo_eval():
    """Backbone, tile init (full-range cost + argmin), five tile updates
    with kernel 1's plain version, and the post-updates: pred_disp and
    the 1/4 features."""
    left, right = _imgs(seed=1)
    jm, tm = jhit.HITNetStereo(max_disp=64), thit.HITNetStereo(max_disp=64)
    v = bridge(jm, tm, jnp.asarray(left), jnp.asarray(right))
    ref = jax.jit(lambda v, l, r: jm.apply(v, l, r))(v, jnp.asarray(left),
                                                     jnp.asarray(right))
    with torch.no_grad():
        got = tm(T(left), T(right))
    for k in ("pred_disp", "left_feat", "right_feat"):
        assert got[k].shape == ref[k].shape, k
        assert rel_err(got[k], ref[k]) < 1e-5, k


def test_basic_encoder_and_hrnet():
    left, _ = _imgs(seed=2)
    jm, tm = jenc.BasicEncoder(128), tenc.BasicEncoder(128)
    v = bridge(jm, tm, jnp.asarray(left))
    assert rel_err(tm(T(left)).detach(), jm.apply(v, jnp.asarray(left))) < 1e-5

    rng = np.random.RandomState(3)
    jh, th = jhr.HRNetSmall(), thr.HRNetSmall()
    v = bridge(jh, th, jnp.asarray(left), batch_stats_rng=rng)
    ref = jh.apply(v, jnp.asarray(left))
    got = th(T(left))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and rel_err(g.detach(), r) < 1e-5
    jo, to = jhr.ResizeConcatConv(512), thr.ResizeConcatConv(270, 512)
    v = bridge(jo, to, [jnp.asarray(np.asarray(r)) for r in ref])
    assert rel_err(to([T(np.asarray(r)) for r in ref]).detach(),
                   jo.apply(v, ref)) < 1e-5


def test_update_block():
    rng = np.random.RandomState(4)
    shapes = [(1, 8, 16, 128), (1, 8, 16, 384), (1, 8, 16, 196),
              (1, 8, 16, 2), (1, 8, 16, 1), (1, 8, 16, 6)]
    args = [(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]
    jm, tm = jraft.BasicUpdateBlock(128), traft.BasicUpdateBlock(128)
    v = bridge(jm, tm, *(jnp.asarray(a) for a in args))
    ref = jm.apply(v, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = tm(*(T(a) for a in args))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and rel_err(g, r) < 1e-5


def test_raft3d_eval():
    """Encoders, the volume pyramid (kernel 2's plain lookup) and two GN
    iterations (kernel 3's plain solve) against the flax RAFT3D eval
    branch; the SE(3) field and the upsampled flow/weight."""
    left, right = _imgs(seed=5)
    rng = np.random.RandomState(5)
    B, H, W = 1, 64, 128
    depth_prev = rng.uniform(2, 30, (B, H, W)).astype(np.float32)
    depth_curr = (depth_prev * rng.uniform(0.95, 1.05, (B, H, W))
                  ).astype(np.float32)
    intr = np.array([[100.0, 100.0, 64.0, 32.0]], np.float32)
    jm = jraft.RAFT3D(iters=2)
    tm = traft.RAFT3D(iters=2)
    fmap = rng.randn(B, 8, 16, 128).astype(np.float32)
    netinp = rng.randn(B, 8, 16, 512).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (right, depth_prev, depth_curr,
                                           intr, fmap, netinp))
    v = bridge(jm, tm, *jargs)
    # the previous frame's features come from the encoders, as in a stream
    fmap_p, netinp_p = jm.apply(v, jnp.asarray(left), method=jm.encode)
    jargs = jargs[:4] + (fmap_p, netinp_p)
    ref, ref_f, ref_n = jax.jit(lambda v, *a: jm.apply(v, *a))(v, *jargs)
    with torch.no_grad():
        tf, tn = tm.encode(T(left))
        assert rel_err(tf, fmap_p) < 1e-5 and rel_err(tn, netinp_p) < 1e-5
        got, got_f, got_n = tm(T(right), T(depth_prev), T(depth_curr),
                               T(intr), T(np.asarray(fmap_p)),
                               T(np.asarray(netinp_p)))
    assert rel_err(got_f, ref_f) < 1e-5 and rel_err(got_n, ref_n) < 1e-5
    for k in ("Ts", "flow2d_est_induced", "weight"):
        assert got[k].shape == ref[k].shape, k
        # two GN iterations through bf16 correlations: 1e-4 relative
        assert rel_err(got[k], ref[k]) < 1e-4, (k, rel_err(got[k], ref[k]))


def test_fusion_project_and_forward():
    """Fusion on identical inputs (the motion outputs it consumes are
    given, so the splat's tie order does not enter)."""
    rng = np.random.RandomState(6)
    B, H, W = 1, 32, 64
    pred_curr = rng.uniform(0, 40, (B, H, W, 1)).astype(np.float32)
    pred_warp = rng.uniform(0, 40, (B, H, W, 1)).astype(np.float32)
    pred_warp[:, ::5] = 0.0  # holes the splat leaves
    feat_curr = rng.randn(B, H // 4, W // 4, 32).astype(np.float32)
    feat_warp = rng.randn(B, H // 4, W // 4, 32).astype(np.float32)
    flow_warp = rng.randn(B, H, W, 3).astype(np.float32)
    conf_warp = rng.rand(B, H, W, 3).astype(np.float32)
    fea_l = rng.randn(B, H // 4, W // 4, 24).astype(np.float32)
    fea_r = rng.randn(B, H // 4, W // 4, 24).astype(np.float32)
    args = (pred_curr, pred_warp, feat_curr, feat_warp, flow_warp, conf_warp,
            fea_l, fea_r)
    jm, tm = JFusion(), TFusion()
    # flax creates a setup() submodule's params only where a method uses
    # it: the key layer comes from an init of ``project``
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args)))
    vp = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(fea_l), method=jm.project))
    v = {"params": {**v["params"], **vp["params"]}}
    tm.load_state_dict(torch_state_dict_from_jax(v), strict=True)
    ref = jm.apply(v, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = tm(*(T(a) for a in args))
        proj = tm.project(T(fea_l))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and rel_err(g, r) < 1e-5
    assert rel_err(proj, jm.apply(v, jnp.asarray(fea_l),
                                  method=jm.project)) < 1e-5
