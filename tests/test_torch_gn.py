"""Kernels 3 and 5, the GN aggregate (+ damped 6x6 solve): the port's
plain versions against codd_tpu's ``dense`` path (what ``gn_impl="auto"``
takes at these small widths), its ``windowed`` path (``auto`` at w8 > 96)
and the Pallas ``gn_fused_solve`` / ``gn_window_aggregate`` in interpret
mode, and ``gn_step`` for every ``impl``.  The CUDA kernels are held
against the plain versions in test_torch_gpu.py; the arithmetic of their
tensor-core products (f32 operands split into TF32 halves) is emulated
here, rounding by rounding, to size its error without a card."""

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

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _field(h, w, seed=0, B=1):
    rng = np.random.RandomState(seed)
    intr = np.tile(np.array([[90.0, 90.0, w / 2, h / 2]], np.float32), (B, 1))
    depth = rng.uniform(2.0, 40.0, (B, h, w)).astype(np.float32)
    Ts = np.asarray(jse3.exp(jnp.asarray(rng.randn(B, h, w, 6) * 0.01,
                                         jnp.float32)))
    target = (rng.randn(B, h, w, 3) * 0.5).astype(np.float32)
    target[..., 0] += np.arange(w)
    target[..., 1] += np.arange(h)[:, None]
    target[..., 2] = 1.0 / depth
    weight = rng.rand(B, h, w, 3).astype(np.float32)
    ae = (rng.randn(B, h, w, 32) * 0.5).astype(np.float32)
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


# ---------------------------------------------------------------------------
# The CUDA aggregation's tensor-core products, emulated in PyTorch.  The
# tensor cores take TF32 operands (10 mantissa bits; they ignore the 13 low
# bits of what they are given) and add exact products in f32, so an f32
# operand goes in as x = hi + lo, hi = x rounded to TF32, lo = x - hi rounded
# to TF32, and a product a.b as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi ("3xTF32":
# lo.lo, 2^-22 of the product, is dropped).  A product of two TF32 values is
# exact in f32, so an f32 bmm of such operands is the tensor core's sum up to
# its order.
# ---------------------------------------------------------------------------

def _tf32(x):
    """f32 -> TF32: to nearest, ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32) + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_split(a, b, products):
    """bmm(a, b) from split operands, the small terms first."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if products == 1:
        return torch.bmm(ah, bh)
    return (torch.bmm(al, bh) + torch.bmm(ah, bl)) + torch.bmm(ah, bh)


def _aggregate_split(ae, vals, radius, bf16, products=3):
    """gn_window_aggregate_plain's function with both products in split
    TF32 (``products`` 3) or plain TF32 (1), the f32 norms outside the dot;
    with ``bf16`` the second product takes bf16 operands (exact in f32)."""
    B, h, w, C = ae.shape
    n = h * w
    q = ae.reshape(B, n, C)
    sq = torch.sum(q * q, -1)
    logits = (2.0 * _mm_split(q, q.transpose(1, 2).contiguous(), products)
              - sq[:, :, None] - sq[:, None, :])
    ys, xs = torch.arange(n) // w, torch.arange(n) % w
    inside = (((ys[:, None] - ys[None, :]).abs() <= radius)
              & ((xs[:, None] - xs[None, :]).abs() <= radius))
    p = torch.sigmoid(logits) * inside[None].float()
    v = vals.reshape(B, n, 27)
    if bf16:
        agg = torch.bmm(p.bfloat16().float(), v.bfloat16().float())
    else:
        agg = _mm_split(p, v, products)
    return agg.reshape(B, h, w, 27)


def _embeddings(kind, scale, h, w, rng):
    """``random``: iid N(0, scale^2), so at scale >= 1 only a query's own
    term survives and its logit is the bare cancellation 2 q.q - 2 |q|^2.
    ``smooth``: one direction of that size plus a 0.05 ripple, so thousands
    of terms with logits near 0 ride on norms of 32 scale^2."""
    if kind == "random":
        ae = scale * rng.randn(1, h, w, 32)
    else:
        ae = scale * rng.randn(1, 1, 1, 32) + 0.05 * rng.randn(1, h, w, 32)
    return T(ae)


def _split_case(kind, scale, seed=11, h=12, w=72):
    rng = np.random.RandomState(seed)
    ae = _embeddings(kind, scale, h, w, rng)
    # 27 columns spread over five decades, as sym_pack(J^T W J) | J^T W r is
    vals = T(rng.randn(1, h, w, 27) * np.logspace(-2, 3, 27))
    absum = tgn.gn_window_aggregate_plain(ae, vals.abs())
    # Whatever computes 2 q.k - |q|^2 - |k|^2 in f32 rounds three terms of
    # size |q|^2 + |k|^2, and the plain version's own sums stand that far
    # from an f64 evaluation (1.8e-4 of the sum of |terms| at scale 4,
    # 1e-7 at 1/8).  A logit off by d moves its term by at most d of
    # itself, so 8 ulp of 2 max|q|^2 is allowed beside the flat share; at
    # the model's scale (1/8) that adds 5e-7 to the 1e-5.
    noise = 8 * 2.0 ** -24 * 2 * float((ae * ae).sum(-1).max())
    return ae, vals, absum, noise


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("scale", [0.125, 1.0, 4.0])
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_split_tf32_products_keep_the_sums(kind, scale, bf16):
    """Each of the 27 sums from 3xTF32 logits and a split (or bf16) second
    product stays within 1e-5 (bf16 scores: 2^-12) of its sum of |terms|,
    plus the f32 rounding of the logit itself, of the plain version and of
    an f64 evaluation; a fourth product (lo.lo) is not needed."""
    ae, vals, absum, noise = _split_case(kind, scale)
    got = _aggregate_split(ae, vals, 32, bf16)
    ref = tgn.gn_window_aggregate_plain(ae, vals, 32, bf16)
    tol = ((2.0 ** -12 if bf16 else 1e-5) + noise) * absum
    assert (torch.abs(got - ref) <= tol).all()
    if not bf16:
        exact = tgn.gn_window_aggregate_plain(ae.double(), vals.double(), 32)
        assert (torch.abs(got.double() - exact) <= tol).all()


@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_single_tf32_breaks_the_sums_at_scale_4(kind):
    """The guard: one TF32 product for the logits (no split) is out by
    orders of magnitude more than the bound at scale 4, where
    |q|^2 ~ 512 meets a 2^-11 rounding of every operand."""
    ae, vals, absum, noise = _split_case(kind, 4.0)
    got = _aggregate_split(ae, vals, 32, False, products=1)
    ref = tgn.gn_window_aggregate_plain(ae, vals, 32)
    ratio = torch.abs(got - ref) / ((1e-5 + noise) * absum)
    assert float(ratio.max()) > 10.0


def _backward_split(g, ae, vals, radius, single=None):
    """gn_window_aggregate_backward_plain's function with its four products
    in split TF32, as kernel 5's backward computes them: the logits' S = A
    A^T, P = [G | V] [V | G]^T, so that P_ij = G_i.v_j + V_i.G_j in one
    product, then dvals = S G and U A with U = S (1 - S) P, and dae =
    -2 (rowsum(U) a - U A); the f32 norms outside the product, the sigmoid
    on f32 logits.  ``single`` ("S", "P", "SG" or "UA") takes that product
    in one TF32 product, for the guards."""
    def mm(a, b, name):
        return _mm_split(a, b, 1 if name == single else 3)

    B, h, w, C = ae.shape
    n = h * w
    q = ae.reshape(B, n, C)
    sq = torch.sum(q * q, -1)
    logits = (2.0 * mm(q, q.transpose(1, 2).contiguous(), "S")
              - sq[:, :, None] - sq[:, None, :])
    ys, xs = torch.arange(n) // w, torch.arange(n) % w
    inside = (((ys[:, None] - ys[None, :]).abs() <= radius)
              & ((xs[:, None] - xs[None, :]).abs() <= radius))
    s = torch.sigmoid(logits) * inside[None].float()
    G, V = g.reshape(B, n, 27), vals.reshape(B, n, 27)
    P = mm(torch.cat([G, V], -1),
           torch.cat([V, G], -1).transpose(1, 2).contiguous(), "P")
    u = s * (1.0 - s) * P
    dae = -2.0 * (u.sum(-1, keepdim=True) * q - mm(u, q, "UA"))
    return dae.reshape(ae.shape), mm(s, G, "SG").reshape(vals.shape)


def _backward_case(kind, scale):
    ae, vals, _, noise = _split_case(kind, scale)
    g = T(np.random.RandomState(12).randn(*vals.shape))
    return g, ae, vals, noise


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_backward_split_tf32_products_keep_the_sums(kind, scale):
    """Kernel 5's backward on the tensor cores: (dae, dvals) from its four
    products in 3xTF32 stay within 1e-5 of each element's sum of |terms|
    (``gn_window_aggregate_backward_terms``), plus the f32 rounding of the
    logit (8 ulp of 2 max|a|^2, as chip_smoke.py allows), of the plain
    backward and of an f64 evaluation."""
    g, ae, vals, noise = _backward_case(kind, scale)
    got = _backward_split(g, ae, vals, 32)
    ref = tgn.gn_window_aggregate_backward_plain(g, ae, vals, 32)
    terms = tgn.gn_window_aggregate_backward_terms(g, ae, vals, 32)
    exact = tgn.gn_window_aggregate_backward_plain(g.double(), ae.double(),
                                                   vals.double(), 32)
    for a, b, e, t in zip(got, ref, exact, terms):
        tol = (1e-5 + noise) * t + 1e-7
        assert (torch.abs(a - b) <= tol).all()
        assert (torch.abs(a.double() - e) <= tol).all()


def _backward_ratio(kind, scale, single):
    g, ae, vals, noise = _backward_case(kind, scale)
    got = _backward_split(g, ae, vals, 32, single)
    ref = tgn.gn_window_aggregate_backward_plain(g, ae, vals, 32)
    terms = tgn.gn_window_aggregate_backward_terms(g, ae, vals, 32)
    return max(float((torch.abs(a - b) / ((1e-5 + noise) * t + 1e-7)).max())
               for a, b, t in zip(got, ref, terms))


@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_backward_single_tf32_logits_break_the_sums_at_scale_4(kind):
    """The guard: one TF32 product for the backward's logits (the other
    three still split) is out by far more than that bound at scale 4."""
    assert _backward_ratio(kind, 4.0, "S") > 10.0


@pytest.mark.parametrize("single", ["P", "SG", "UA"])
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_backward_single_tf32_products_break_the_sums(kind, single):
    """The other three products need their split too: one TF32 product in
    place of P, S G or U A is out by more than three times that bound at
    the model's embedding scale, 1/8."""
    assert _backward_ratio(kind, 0.125, single) > 3.0


@pytest.mark.parametrize("h,w,radius,B", [(5, 19, 3, 2), (9, 40, 32, 1),
                                          (12, 72, 32, 1)])
def test_window_aggregate_plain_matches_dense_at_odd_shapes(h, w, radius, B):
    """The shapes whose edges the CUDA tiling has to mask (a ragged last
    tile, w < R, h < R, R = 3, B = 2): the plain version the kernels are
    held to equals codd_tpu's dense build_system there."""
    arrs = _field(h, w, seed=8, B=B)
    Ts, ae, target, weight, depth, intr = arrs
    J = [jnp.asarray(a) for a in (Ts, ae / 8.0, target, weight, depth, intr)]
    vals = np.asarray(jgn._build_vals(J[0], J[2], J[3], J[4], J[5]))
    Hm, b = jgn.build_system(*J, radius=radius, impl="dense")
    dense = np.concatenate([np.asarray(jgn._sym_pack(Hm)), np.asarray(b)], -1)
    got = tgn.gn_window_aggregate_plain(T(ae / 8.0), T(vals), radius).numpy()
    assert got.shape == dense.shape == (B, h, w, 27)
    absum = tgn.gn_window_aggregate_plain(T(ae / 8.0), T(np.abs(vals)),
                                          radius).numpy()
    assert (np.abs(got - dense) <= 1e-5 * absum + 1e-6).all()
    # the window really is smaller than the image where R = 3
    if radius < max(h, w):
        full = tgn.gn_window_aggregate_plain(T(ae / 8.0), T(np.abs(vals)),
                                             max(h, w)).numpy()
        assert (full > absum * (1 + 1e-3)).any()
