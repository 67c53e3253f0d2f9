"""codd_torch core ops and layers against codd_tpu on the same numpy inputs.

Tolerances: these ops are elementwise f32 arithmetic written in the same
order on both sides, so they agree to a few f32 ulps (atol 1e-5 or
rtol 1e-5, 1e-6 for SE(3) at O(1)); convolutions sum in another order,
still within atol 1e-5 at O(1) magnitudes; projections divide by depths
down to 0.01, hence atol 1e-4 there.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.models import layers as jlayers
from codd_tpu.ops.grid_sample import grid_sample as jgrid
from codd_tpu.ops import projective as jproj
from codd_tpu.ops import se3 as jse3
from codd_tpu.ops import upsample as jup
from codd_tpu.ops import metrics as jmetrics
from codd_tpu.ops import warp as jwarp
from codd_tpu.utils import masks as jmasks
from codd_torch.models import layers as tlayers
from codd_torch.ops.grid_sample import grid_sample as tgrid
from codd_torch.ops import projective as tproj
from codd_torch.ops import se3 as tse3
from codd_torch.ops import upsample as tup
from codd_torch.ops import metrics as tmetrics
from codd_torch.ops import warp as twarp
from codd_torch.utils import masks as tmasks
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(t, j, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=rtol)


def _bridge(jmod, tmod, x, *args):
    """Init the flax module with its own init, carry the params over, run
    both on x."""
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), *args)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sd = torch_state_dict_from_jax(variables)
    tmod.load_state_dict(sd, strict=True)
    return jmod.apply(variables, jnp.asarray(x), *args)


@pytest.mark.parametrize("kernel,stride,padding,dilation", [
    (3, 1, 1, 1), (4, 2, 1, 1), (3, 1, 4, 4), (7, 2, 3, 1), (1, 1, 0, 1)])
def test_conv_matches_flax(kernel, stride, padding, dilation):
    x = np.random.RandomState(0).randn(2, 12, 16, 5).astype(np.float32)
    jm = jlayers.Conv(7, kernel, stride=stride, padding=padding,
                      dilation=dilation)
    tm = tlayers.Conv(5, 7, kernel, stride=stride, padding=padding,
                      dilation=dilation)
    ref = _bridge(jm, tm, x)
    close(tm(T(x)).detach(), ref, atol=1e-5)


def test_conv_transpose_matches_flax():
    """ConvTranspose bridges with the spatial flip (the only layer kind
    whose kernel is not a plain transpose)."""
    x = np.random.RandomState(1).randn(1, 5, 6, 4).astype(np.float32)

    import flax.linen as fnn

    class Up(fnn.Module):  # path backbone/upN/conv/kernel, as in HITUNet
        @fnn.compact
        def __call__(self, x):
            return jlayers.ConvTranspose(3, name="up1")(x)

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return Up(name="backbone")(x)

    tm = torch.nn.Module()
    tm.backbone = torch.nn.Module()
    tm.backbone.up1 = tlayers.ConvTranspose(4, 3)
    ref = _bridge(Wrap(), tm, x)
    close(tm.backbone.up1(T(x)).detach(), ref, atol=1e-5)


def test_shared_stride_conv_matches_flax():
    x = np.random.RandomState(2).randn(1, 8, 19, 6).astype(np.float32)
    jm = jlayers.SharedStrideConv(5, (4, 4))
    tm = tlayers.SharedStrideConv(6, 5, (4, 4))
    for strides in ((4, 4), (4, 1)):
        variables = jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                strides))
        tm.load_state_dict(torch_state_dict_from_jax(variables))
        ref = jm.apply(variables, jnp.asarray(x), strides)
        close(tm(T(x), strides).detach(), ref, atol=1e-5)


def test_activations():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    close(tlayers.lrelu(T(x)), jlayers.lrelu(jnp.asarray(x)))
    close(tlayers.mish(T(x)), jlayers.mish(jnp.asarray(x)))


@pytest.mark.parametrize("mode,padding", [("bilinear", "zeros"),
                                          ("bilinear", "border")])
def test_grid_sample(mode, padding):
    rng = np.random.RandomState(3)
    img = rng.randn(2, 7, 9, 3).astype(np.float32)
    coords = rng.uniform(-2, 10, (2, 5, 6, 2)).astype(np.float32)
    ref = jgrid(jnp.asarray(img), jnp.asarray(coords), mode, padding)
    close(tgrid(T(img), T(coords), mode, padding), ref)


def test_flow_and_disp_warp():
    rng = np.random.RandomState(4)
    img = rng.randn(1, 8, 12, 4).astype(np.float32)
    flow = rng.uniform(-3, 3, (1, 8, 12, 2)).astype(np.float32)
    disp = rng.uniform(-2, 9, (1, 8, 12)).astype(np.float32)
    jw, jv = jwarp.flow_warp(jnp.asarray(img), jnp.asarray(flow))
    tw, tv = twarp.flow_warp(T(img), T(flow))
    close(tw, jw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for pad in ("border", "zeros"):
        jw, jv = jwarp.disp_warp(jnp.asarray(img), jnp.asarray(disp), pad)
        tw, tv = twarp.disp_warp(T(img), T(disp), pad)
        close(tw, jw)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_upsample_ops():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 4, 6, 5).astype(np.float32)
    mask = rng.randn(1, 4, 6, 9 * 64).astype(np.float32)
    close(tup.unfold3x3(T(x), 2), jup.unfold3x3(jnp.asarray(x), 2))
    close(tup.cvx_upsample(T(x), T(mask)),
          jup.cvx_upsample(jnp.asarray(x), jnp.asarray(mask)), atol=1e-5)
    close(tup.pixel_unshuffle(T(np.tile(x, (1, 2, 2, 1))), 4),
          jup.pixel_unshuffle(jnp.asarray(np.tile(x, (1, 2, 2, 1))), 4))
    close(tup.interpolate_nearest(T(x), 4),
          jup.interpolate_nearest(jnp.asarray(x), 4))
    hyp = rng.randn(1, 4, 6, 16).astype(np.float32)
    for scale, size in ((2.0, 2), (1.0, 2), (4.0, 16)):
        close(tup.hyp_upsample(T(hyp), scale, size),
              jup.hyp_upsample(jnp.asarray(hyp), scale, size))
    for ac in (True, False):
        close(tup.interpolate_bilinear(T(x), (9, 11), align_corners=ac),
              jup.interpolate_bilinear(jnp.asarray(x), (9, 11),
                                       align_corners=ac), atol=1e-5)
    Ts = np.asarray(jse3.exp(jnp.asarray(rng.randn(1, 4, 6, 6) * 0.3,
                                         jnp.float32)))
    close(tup.upsample_se3(T(Ts), T(mask)),
          jup.upsample_se3(jnp.asarray(Ts), jnp.asarray(mask)), atol=2e-5)


def test_se3_exp_log_mul_act():
    rng = np.random.RandomState(6)
    tau = (rng.randn(3, 5, 6) * 0.5).astype(np.float32)
    tau[0, 0] = 0.0            # identity
    tau[0, 1, 3:] = 1e-6       # small-angle branch
    p = rng.randn(3, 5, 3).astype(np.float32)
    ja = jse3.exp(jnp.asarray(tau))
    ta = tse3.exp(T(tau))
    close(ta, ja, atol=1e-6)
    close(tse3.log(ta), jse3.log(ja), atol=1e-5)
    jb = jse3.exp(jnp.asarray(tau[::-1].copy()))
    tb = tse3.exp(T(tau[::-1].copy()))
    close(tse3.mul(ta, tb), jse3.mul(ja, jb), atol=1e-6)
    close(tse3.act(ta, T(p)), jse3.act(ja, jnp.asarray(p)), atol=1e-6)
    close(tse3.identity((2, 3)), jse3.identity((2, 3)))


def test_projective():
    rng = np.random.RandomState(7)
    depth = rng.uniform(0.01, 20, (2, 6, 8)).astype(np.float32)
    intr = np.array([[50, 52, 4, 3], [40, 41, 3.5, 2.5]], np.float32)
    Ts = np.asarray(jse3.exp(jnp.asarray(rng.randn(2, 6, 8, 6) * 0.1,
                                         jnp.float32)))
    close(tproj.inv_project(T(depth), T(intr)),
          jproj.inv_project(jnp.asarray(depth), jnp.asarray(intr)))
    pts = np.asarray(jproj.inv_project(jnp.asarray(depth), jnp.asarray(intr)))
    close(tproj.project(T(pts), T(intr)),
          jproj.project(jnp.asarray(pts), jnp.asarray(intr)), rtol=1e-5)
    for a, b in zip(tproj.projective_transform(T(Ts), T(depth), T(intr)),
                    jproj.projective_transform(jnp.asarray(Ts),
                                               jnp.asarray(depth),
                                               jnp.asarray(intr))):
        close(a, b, atol=1e-4, rtol=1e-5)
    for a, b in zip(tproj.induced_flow(T(Ts), T(depth), T(intr)),
                    jproj.induced_flow(jnp.asarray(Ts), jnp.asarray(depth),
                                       jnp.asarray(intr))):
        close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_nearest_rounds_half_to_even(padding):
    """Nearest mode gathers, so the two sides are equal exactly; ties at
    .5 coordinates round half to even on both (0.5 -> 0, 1.5 -> 2), also
    at the borders (-0.5 -> -0 inside, W - 0.5 -> W outside or W - 1)."""
    rng = np.random.RandomState(0)
    img = rng.randn(2, 6, 9, 3).astype(np.float32)
    halves = np.arange(-3, 24, dtype=np.float32) / 2.0 - 0.5
    xs, ys = np.meshgrid(halves, halves[:18])
    coords = np.broadcast_to(np.stack([xs, ys], -1)[None],
                             (2,) + xs.shape + (2,)).astype(np.float32).copy()
    assert (np.modf(coords)[0] != 0).any() and (coords % 1 == 0.5).any()
    coords[1] += rng.uniform(-3, 3, coords[1].shape).astype(np.float32)
    ref = jgrid(jnp.asarray(img), jnp.asarray(coords), mode="nearest",
                padding_mode=padding)
    got = tgrid(T(img), T(coords), mode="nearest", padding_mode=padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        tgrid(T(img), T(coords), mode="bicubic")


def test_flow_warp_nearest():
    rng = np.random.RandomState(1)
    img = rng.randn(1, 8, 12, 4).astype(np.float32)
    flow = rng.uniform(-4, 4, (1, 8, 12, 2)).astype(np.float32)
    flow[0, :4] = np.round(flow[0, :4] * 2) / 2   # exact halves and integers
    jw, jv = jwarp.flow_warp(jnp.asarray(img), jnp.asarray(flow),
                             padding_mode="zeros", mode="nearest")
    tw, tv = twarp.flow_warp(T(img), T(flow), padding_mode="zeros",
                             mode="nearest")
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < tv.float().mean() < 1


def test_metrics_match():
    """Masked means of the same f32 terms; the sums run in another order
    (rtol 1e-5)."""
    rng = np.random.RandomState(2)
    a, b, c, d = (rng.uniform(0, 20, (1, 16, 24, 1)).astype(np.float32)
                  for _ in range(4))
    m0 = rng.rand(1, 16, 24, 1) > 0.3
    m1 = rng.rand(1, 16, 24, 1) > 0.3
    J = jnp.asarray
    close(tmetrics.masked_mean(T(a), torch.from_numpy(m0)),
          jmetrics.masked_mean(J(a), J(m0)))
    close(tmetrics.masked_mean(T(a), torch.zeros(a.shape, dtype=torch.bool)),
          0.0)
    close(tmetrics.epe_metric(T(a), T(b), torch.from_numpy(m0)),
          jmetrics.epe_metric(J(a), J(b), J(m0)))
    close(tmetrics.thres_metric(T(a), T(b), torch.from_numpy(m0), 3.0),
          jmetrics.thres_metric(J(a), J(b), J(m0), 3.0))
    got = tmetrics.t_epe_metric(T(a), T(b), T(c), T(d), torch.from_numpy(m0),
                                torch.from_numpy(m1))
    ref = jmetrics.t_epe_metric(J(a), J(b), J(c), J(d), J(m0), J(m1))
    for g, r in zip(got, ref):
        close(g, r)
    depth = rng.uniform(1, 5, (10, 14)).astype(np.float32)
    close(tmetrics.depth2normal(T(depth)), jmetrics.depth2normal(J(depth)))


def test_masks_match():
    rng = np.random.RandomState(3)
    shape = (1, 12, 20, 1)
    disp = rng.uniform(0, 230, shape).astype(np.float32)
    disp2 = rng.uniform(0, 60, shape).astype(np.float32)
    seg = (rng.rand(*shape) > 0.2).astype(np.float32)
    flow = rng.uniform(-200, 200, (1, 12, 20, 2)).astype(np.float32)
    change = rng.uniform(-300, 300, shape).astype(np.float32)
    occ = rng.rand(*shape) > 0.8
    J = jnp.asarray
    assert tmasks.BF_DEFAULT == jmasks.BF_DEFAULT
    for kw in ({}, {"gt_semantic_seg": seg}, {"gt_flow_prev": flow},
               {"gt_semantic_seg": seg, "gt_flow_prev": flow,
                "gt_disp_change": change}):
        ref = jmasks.compute_valid_mask(J(disp), (1.0, 210.0),
                                        **{k: J(v) for k, v in kw.items()})
        got = tmasks.compute_valid_mask(T(disp), (1.0, 210.0),
                                        **{k: T(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    small = (flow / 40).astype(np.float32)
    ref = jmasks.compute_gt_disp_change(J(occ), J(disp), J(disp2), J(small))
    got = tmasks.compute_gt_disp_change(torch.from_numpy(occ), T(disp),
                                        T(disp2), T(small))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
