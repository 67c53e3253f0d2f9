"""Kernel 3, the fused GN aggregate + damped 6x6 solve: the port's plain
version against codd_tpu's ``dense`` path (what ``gn_impl="auto"`` takes
at these small widths), its ``windowed`` path (``auto`` at w8 > 96) and
the Pallas ``gn_fused_solve`` in interpret mode.  The CUDA kernel is held
against the plain version in test_torch_gpu.py."""

import numpy as np

import jax.numpy as jnp
import torch

from codd_tpu.ops import gn as jgn
from codd_tpu.ops import se3 as jse3
from codd_tpu.ops.pallas.gn_fused import (gn_fused_solve as pallas_gn,
                                          gn_fused_solve_reference)
from codd_torch.ops import gn as tgn


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _field(h, w, seed=0):
    rng = np.random.RandomState(seed)
    intr = np.array([[90.0, 90.0, w / 2, h / 2]], np.float32)
    depth = rng.uniform(2.0, 40.0, (1, h, w)).astype(np.float32)
    Ts = np.asarray(jse3.exp(jnp.asarray(rng.randn(1, h, w, 6) * 0.01,
                                         jnp.float32)))
    target = (rng.randn(1, h, w, 3) * 0.5).astype(np.float32)
    target[..., 0] += np.arange(w)
    target[..., 1] += np.arange(h)[:, None]
    target[..., 2] = 1.0 / depth
    weight = rng.rand(1, h, w, 3).astype(np.float32)
    ae = (rng.randn(1, h, w, 32) * 0.5).astype(np.float32)
    return Ts, ae, target, weight, depth, intr


def test_cholesky_solve_small():
    rng = np.random.RandomState(1)
    A = rng.randn(50, 6, 6).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    b = rng.randn(50, 6).astype(np.float32)
    got = tgn.cholesky_solve_small(T(H), T(b)).numpy()
    ref = np.asarray(jgn.cholesky_solve_small(jnp.asarray(H), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.linalg.solve(H, b[..., None])[..., 0],
                               atol=1e-4)


def test_build_vals_and_sym_pack():
    Ts, ae, target, weight, depth, intr = _field(8, 16)
    ref = np.asarray(jgn._build_vals(*(jnp.asarray(a) for a in
                                       (Ts, target, weight, depth, intr))))
    got = tgn.build_vals(T(Ts), T(target), T(weight), T(depth), T(intr))
    # 3-term J^T W J products of O(1e3) entries: f32 rounding only
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        tgn.sym_unpack(got[..., :21]).numpy(),
        np.asarray(jgn._sym_unpack(jnp.asarray(got[..., :21].numpy()))))


def test_gn_step_matches_dense_path():
    """A whole GN step at 8x16 (the dense path); the SE(3) fields agree to
    f32 rounding of O(1) entries."""
    Ts, ae, target, weight, depth, intr = _field(8, 16, seed=2)
    assert jgn.resolve_impl("auto", 32, 16) == "dense"
    ref = np.asarray(jgn.gn_step(*(jnp.asarray(a) for a in
                                   (Ts, ae, target, weight, depth, intr))))
    got = tgn.gn_step(*(T(a) for a in (Ts, ae, target, weight, depth, intr)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)


def test_fused_solve_matches_windowed_and_pallas():
    """6x128 (w % 32 == 0 and w > 96: the windowed path and the Pallas
    kernel apply).  The ~4000-term f32 sums run in another order and the
    damped solve amplifies that, so rel 1e-4 of max|dx|."""
    Ts, ae, target, weight, depth, intr = _field(6, 128, seed=3)
    assert jgn.resolve_impl("auto", 32, 128) == "windowed"
    vals = np.asarray(jgn._build_vals(*(jnp.asarray(a) for a in
                                        (Ts, target, weight, depth, intr))))
    ae8 = ae / 8.0
    ref = np.asarray(gn_fused_solve_reference(jnp.asarray(ae8),
                                              jnp.asarray(vals)))
    pal = np.asarray(pallas_gn(jnp.asarray(ae8), jnp.asarray(vals),
                               interpret=True))
    got = tgn.gn_fused_solve_plain(T(ae8), T(vals)).numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(got, pal, atol=1e-4 * scale, rtol=0)


def test_damped_solve_zeroes_non_finite():
    agg = np.zeros((2, 27), np.float32)
    agg[0, :21] = np.nan
    agg[1, 21:] = 1.0
    dx = tgn.damped_solve(T(agg)).numpy()
    np.testing.assert_array_equal(dx[0], 0.0)
    assert np.isfinite(dx[1]).all() and np.abs(dx[1]).max() > 0
