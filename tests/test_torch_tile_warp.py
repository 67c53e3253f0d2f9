"""Kernel 1, the tile-warp cost: the port's plain version against
codd_tpu's XLA oracle (hitnet.tile_warping) and the Pallas kernel in
interpret mode, on the same numpy inputs.  The CUDA kernel is held
against the plain version on the card in test_torch_gpu.py.

Tolerance rel 1e-5 of max|cost|: the sample positions and their floor()
are computed with the same operations in the same order, so the taps
agree; only the order of the C-term L1 sums differs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from codd_tpu.models.stereo.hitnet import tile_warping
from codd_tpu.ops.pallas.tile_warp import tile_warp_cost as pallas_tile_warp
from codd_torch.ops import kernels, tile_warp
from codd_torch.ops.tile_warp import tile_warp_cost, tile_warp_cost_plain

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)


def _inputs(B, H, W, C, seed=0, max_d=None):
    rng = np.random.RandomState(seed)
    fl = rng.randn(B, H, W, C).astype(np.float32)
    fr = rng.randn(B, H, W, C).astype(np.float32)
    ht, wt = H // 4, W // 4
    max_d = W * 0.8 if max_d is None else max_d
    hyp3 = np.stack([rng.rand(B, ht, wt) * max_d,
                     rng.uniform(-1.2, 1.2, (B, ht, wt)),
                     rng.uniform(-1.2, 1.2, (B, ht, wt))], -1)
    return hyp3.astype(np.float32), fl, fr


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (
        np.abs(np.asarray(b)).max() + 1e-9)


@pytest.mark.parametrize("shape,max_d", [
    ((1, 16, 64, 16), None),      # the full-res level's C
    ((2, 16, 32, 24), None),      # batched, the 1/8 and 1/4 levels' C
    ((1, 8, 64, 32), 90.0),       # coarsest level's C; taps off both edges
])
def test_plain_matches_xla_and_pallas(shape, max_d):
    hyp3, fl, fr = _inputs(*shape, max_d=max_d)
    got = tile_warp_cost_plain(*(torch.from_numpy(a) for a in (hyp3, fl, fr)))
    ref = np.asarray(tile_warping(jnp.asarray(hyp3), jnp.asarray(fl),
                                  jnp.asarray(fr)))
    pal = np.asarray(pallas_tile_warp(jnp.asarray(hyp3), jnp.asarray(fl),
                                      jnp.asarray(fr), interpret=True))
    assert got.shape == ref.shape == (shape[0], shape[1] // 4,
                                      shape[2] // 4, 48)
    assert _rel(got, ref) < 1e-5
    assert _rel(got, pal) < 1e-5


def test_wrapper_uses_plain_version_on_cpu():
    hyp3, fl, fr = (torch.from_numpy(a) for a in _inputs(1, 8, 32, 16))
    before = kernels.counts()["tile_warp_cost"]
    out = tile_warp_cost(hyp3, fl, fr)
    assert torch.equal(out, tile_warp_cost_plain(hyp3, fl, fr))
    assert kernels.counts()["tile_warp_cost"] == before



# -- the backward kernel's channel groups (csrc/tile_warp.cu) --

@pytest.mark.parametrize("W,C", [
    # the stereo stage's training levels at 384x768: 1/1 .. 1/16
    (768, 16), (384, 16), (192, 24), (96, 24), (48, 32),
    # phase 3's full-res call and the streaming levels at 384x1280
    (1280, 16), (640, 16), (320, 24), (160, 24), (80, 32),
    # rows wider than one group: the coarse widths at 1280, and 4096
    (1280, 24), (1280, 32), (4096, 16),
])
def test_backward_channel_group(W, C):
    """The backward's row block takes a group of channels a pass: a
    multiple of 4 that divides C, the largest whose W x cg bytes of packed
    signs fit BWD_ROW_BYTES; every row of the main path and of training
    takes all its channels in one group."""
    cg = tile_warp.backward_channel_group(W, C)
    assert cg % 4 == 0 and C % cg == 0
    assert W * cg <= tile_warp.BWD_ROW_BYTES
    larger = [k for k in range(cg + 4, C + 1, 4) if C % k == 0]
    assert all(W * k > tile_warp.BWD_ROW_BYTES for k in larger)
    if W * C <= 1280 * 24:
        assert cg == C
    with pytest.raises(ValueError):
        tile_warp.backward_channel_group(W, C, budget=4 * W - 1)


# -- the premise of the bf16 "exact" form's native bf16x2 arithmetic --

def _round_bf16(x):
    """One round-to-nearest-even rounding of exact float64 values to bf16
    (8 significant bits; below 2^-126 the subnormal grid 2^-133; past the
    largest finite value, inf)."""
    _, e = np.frexp(x)
    e = np.maximum(e, -125)
    q = np.ldexp(np.rint(np.ldexp(x, 8 - e)), e - 8)
    return np.where(np.abs(q) > np.ldexp(255.0, 120), np.copysign(np.inf, x),
                    q)


def _is_tie(x):
    """Exact values halfway between two neighbouring bf16 values."""
    _, e = np.frexp(x)
    return np.abs(np.ldexp(x, 8 - np.maximum(e, -125))) % 1 == 0.5


def _bf16(sign, exp, man):
    bits = ((sign << 15) | (exp << 7) | man).astype(np.uint32) << 16
    return torch.from_numpy(bits.view(np.float32)).to(torch.bfloat16)


def _bf16_pairs(case, op, n=200_000, seed=0):
    """Seeded bf16 operand pairs for one case."""
    rng = np.random.RandomState(seed)
    s = lambda: rng.randint(0, 2, n)                       # noqa: E731
    m = lambda: rng.randint(0, 128, n)                     # noqa: E731
    if case == "all_exponents":
        return (_bf16(s(), rng.randint(1, 255, n), m()),
                _bf16(s(), rng.randint(1, 255, n), m()))
    if case == "apart_14_18":
        ea = rng.randint(20, 235, n)
        eb = ea - rng.randint(14, 19, n) * rng.choice([-1, 1], n)
        return _bf16(s(), ea, m()), _bf16(s(), eb, m())
    if case == "ties":
        if op == "mul":
            # significand products whose dropped bits are exactly one half
            mm = np.arange(128, 256)
            prod = mm[:, None] * mm[None, :]
            shift = np.where(prod >= 1 << 15, 8, 7)
            ia, ib = np.nonzero((prod & ((1 << shift) - 1))
                                == 1 << (shift - 1))
            k = rng.randint(0, len(ia), n)
            # exponents that keep the product normal and finite
            return (_bf16(s(), rng.randint(64, 191, n), mm[ia[k]] - 128),
                    _bf16(s(), rng.randint(64, 191, n), mm[ib[k]] - 128))
        # b is a half or three halves of a's ulp, in either sign
        ea = rng.randint(20, 235, n)
        a = _bf16(s(), ea, m())
        half = torch.from_numpy(np.ldexp(1.0, ea - 135)
                                * rng.choice([1, 3], n)
                                * rng.choice([-1, 1], n))
        return a, half.to(torch.bfloat16)
    assert case == "below_2^-126"
    # products from 2^-160 to 2^-126: the f32 product is rounded on its
    # subnormal grid (2^-149) before the rounding to bf16's (2^-133)
    ea = rng.randint(1, 128, n)
    eb = np.clip(rng.randint(-160, -126, n) + 254 - ea, 1, 254)
    return _bf16(s(), ea, m()), _bf16(s(), eb, m())


@pytest.mark.parametrize("op,case", [
    ("mul", "all_exponents"), ("mul", "apart_14_18"), ("mul", "ties"),
    ("mul", "below_2^-126"),
    ("add", "all_exponents"), ("add", "apart_14_18"), ("add", "ties"),
    ("sub", "all_exponents"), ("sub", "apart_14_18"), ("sub", "ties"),
], ids=lambda v: v)
def test_bf16_ops_round_once(op, case):
    """For bf16 operands an f32 product, sum or difference rounded to bf16
    equals one rounding of the exact (float64) result, in every case
    below: the product of two 8-bit significands is exact in f32 down to
    2^-134, and below it never sits within 2^-150 of a bf16 tie; a sum is
    exact in f32 unless the exponents are over 15 apart, and then the
    smaller operand is far from any tie.  So the exact tile-warp form can
    compute each rounded step as one native bf16x2 operation
    (csrc/tile_warp.cu, form 1).  Each case exercises what it names: ties
    are exact ties, 14-18 apart includes sums f32 rounds, below 2^-126
    includes products f32 rounds."""
    a, b = _bf16_pairs(case, op)
    fn32 = {"mul": torch.mul, "add": torch.add, "sub": torch.sub}[op]
    fn64 = {"mul": np.multiply, "add": np.add, "sub": np.subtract}[op]
    f32 = fn32(a.float(), b.float())
    exact = fn64(a.double().numpy(), b.double().numpy())
    got = f32.to(torch.bfloat16).double().numpy()
    np.testing.assert_array_equal(got, _round_bf16(exact))
    if case == "ties":
        # a few cross into the next binade, where the grid doubles
        assert _is_tie(exact).mean() > 0.9
    if case == "below_2^-126" or (case == "apart_14_18" and op != "mul"):
        assert (f32.double().numpy() != exact).mean() > 0.05
