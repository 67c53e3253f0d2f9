"""Kernels 3 and 5, the GN aggregate (+ damped 6x6 solve): the port's
plain versions against codd_tpu's ``dense`` path (what ``gn_impl="auto"``
takes at these small widths), its ``windowed`` path (``auto`` at w8 > 96)
and the Pallas ``gn_fused_solve`` / ``gn_window_aggregate`` in interpret
mode, and ``gn_step`` for every ``impl``.  The CUDA kernels are held
against the plain versions in test_torch_gpu.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from codd_tpu.ops import gn as jgn
from codd_tpu.ops import se3 as jse3
from codd_tpu.ops.pallas.gn_fused import (gn_fused_solve as pallas_gn,
                                          gn_fused_solve_reference)
from codd_tpu.ops.pallas.gn_window import gn_window_aggregate as pallas_window
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


def _sums_tolerance(ae8, vals, bf16):
    """|error| allowed on the 27 sums.  f32: ~4000 terms summed in another
    order, rel 1e-5 of the sum of |terms|.  bf16 scores: torch's and XLA's
    sigmoid differ by an f32 ulp, so a score within an ulp of a bf16
    rounding boundary rounds to the neighbouring bf16 value: 2^-8 of that
    one term; with a few such terms among thousands, 2^-9 of the sum of
    |terms| bounds it with room."""
    absum = tgn.gn_window_aggregate_plain(T(ae8), T(np.abs(vals))).numpy()
    return (2.0 ** -9 if bf16 else 1e-5) * absum + 1e-6


@pytest.mark.parametrize("bf16", [False, True])
def test_window_aggregate_matches_windowed_dense_and_pallas(bf16):
    """Kernel 5's plain version at 8x128 (the windowed paths apply) against
    _windowed_aggregate, the dense branch of build_system and the Pallas
    kernel in interpret mode."""
    Ts, ae, target, weight, depth, intr = _field(8, 128, seed=5)
    J = [jnp.asarray(a) for a in (Ts, ae / 8.0, target, weight, depth, intr)]
    vals = np.asarray(jgn._build_vals(J[0], J[2], J[3], J[4], J[5]))
    ae8 = ae / 8.0
    got = tgn.gn_window_aggregate(T(ae8), T(vals), 32, bf16).numpy()
    tol = _sums_tolerance(ae8, vals, bf16)
    win = np.asarray(jgn._windowed_aggregate(jnp.asarray(ae8),
                                             jnp.asarray(vals), 32,
                                             bf16_scores=bf16))
    pal = np.asarray(pallas_window(jnp.asarray(ae8), jnp.asarray(vals),
                                   radius=32, bs=32, bf16_scores=bf16,
                                   interpret=True))
    assert got.shape == win.shape == (1, 8, 128, 27)
    assert (np.abs(got - win) <= tol).all()
    assert (np.abs(got - pal) <= tol).all()
    if not bf16:  # the dense branch keeps f32 scores whatever the flag
        H, b = jgn.build_system(*J, radius=32, impl="dense")
        tH, tb = tgn.build_system(*(T(np.asarray(a)) for a in J), radius=32,
                                  impl="dense")
        dense = np.concatenate([np.asarray(jgn._sym_pack(H)), np.asarray(b)],
                               -1)
        assert (np.abs(got - dense) <= tol).all()
        assert (np.abs(tgn.sym_pack(tH).numpy() - dense[..., :21])
                <= tol[..., :21]).all()
        assert (np.abs(tb.numpy() - dense[..., 21:]) <= tol[..., 21:]).all()


@pytest.mark.parametrize("w", [16, 128])
def test_resolve_impl_matches(w):
    for impl in tgn.GN_IMPLS:
        assert tgn.resolve_impl(impl, 32, w) == jgn.resolve_impl(impl, 32, w)
    assert tgn.resolve_impl("windowed", 16, w) == "dense"
    with pytest.raises(ValueError):
        tgn._route("flash", 32, w)
    # the route never depends on the shape; only the bf16 rounding does
    ok = w == 128
    assert tgn._route("auto", 32, w, True) == ("fused", ok)
    assert tgn._route("fused", 32, w, True) == ("fused", ok)
    assert tgn._route("windowed", 32, w, True) == ("window", ok)
    assert tgn._route("pallas_window", 32, w, True) == ("window", ok)
    assert tgn._route("dense", 32, w, True) == ("dense", False)
    assert tgn._route("windowed", 32, w, False) == ("window", False)


@pytest.fixture(scope="module")
def step_field():
    return _field(8, 128, seed=6)


@pytest.mark.parametrize("impl", ["windowed", "pallas_window", "dense",
                                  "fused", "auto"])
@pytest.mark.parametrize("bf16", [False, True])
def test_gn_step_every_impl(step_field, impl, bf16):
    """gn_step end to end at 8x128 against codd_tpu's gn_step with the same
    impl.  f32: the SE(3) fields agree to the solve's amplification of the
    sums' rounding (atol 2e-5 on O(1) entries).  bf16 scores: a handful of
    scores may round to the neighbouring bf16 value (see _sums_tolerance),
    which moves dx by up to ~1e-3 of its size: atol 1e-4."""
    arrs = step_field
    ref = np.asarray(jgn.gn_step(*(jnp.asarray(a) for a in arrs), impl=impl,
                                 bf16_scores=bf16))
    before = dict(tgn.kernels.counts())
    got = tgn.gn_step(*(T(a) for a in arrs), impl=impl, bf16_scores=bf16)
    assert tgn.kernels.counts() == before      # CPU: the plain versions
    assert np.abs(got.numpy() - np.asarray(arrs[0])).max() > 1e-4
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 if bf16 else 2e-5,
                               rtol=0)


@pytest.mark.parametrize("impl", ["windowed", "pallas_window", "fused"])
def test_gn_step_where_codd_tpu_resolves_to_dense(impl):
    """8x16: codd_tpu runs its dense form with f32 scores whatever
    bf16_scores says; the port keeps the impl's own route and drops the
    rounding, so the fields agree to f32 rounding of O(1) entries."""
    arrs = _field(8, 16, seed=7)
    assert jgn.resolve_impl(impl, 32, 16) == "dense"
    ref = np.asarray(jgn.gn_step(*(jnp.asarray(a) for a in arrs), impl=impl,
                                 bf16_scores=True))
    got = tgn.gn_step(*(T(a) for a in arrs), impl=impl, bf16_scores=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)
