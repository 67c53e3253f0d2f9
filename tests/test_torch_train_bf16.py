"""bf16 training on the CPU (``runtime.bf16_compute``): codd_torch against
codd_tpu on the same numpy-seeded inputs.

* kernel 1's bf16 VJP: ``tile_warp_cost_backward_plain`` (the kernel's
  arithmetic) against ``jax.jit(jax.vjp(tile_warping))`` in bf16 on a strip
  of W=1280, C=16, where the bf16 x grid rounds above 512 and 1024: dhyp3
  and dfea_l equal in bits; dfea_r, whose gather-transpose XLA adds in bf16
  after each term (pixel order) and the port in f32 with one rounding,
  within n half-ulps (2^-8 of it each) of its sum of |terms|, n its number
  of terms; the test's replay of XLA's order gives XLA's bits.  Autograd
  through ``tile_warp_cost`` takes that backward;
* ``grad_clip`` on bf16 cotangents at the 0.01 threshold (a bf16 value
  against a weak-typed float compares in bf16: 0.01 is 0.010009765625);
* one ``TileUpdate`` stage's VJP in bf16 (kernel 1's exact form inside)
  on the same inputs, weights and cotangents;
* ``make_train_step(bf16_compute=True)`` for the stereo stage
  (``configs/models/stereo.py``, max_disp 32, B=2, T=2, 64x128) against
  codd_tpu's ``make_train_step(bf16_compute=True)``, both under SGD(1.0),
  so that the parameter update is the gradient: every gradient and
  parameter f32; the loss, grad_norm and the updates within the bounds
  stated at the check; with Adam, f32 moments;
* ``accum_steps=2`` against the full batch under bf16;
* the convex upsampling's softmax in bf16 (``jax.nn.softmax``'s roundings
  and VJP).

The joint model under bf16 compute: ``tests/test_torch_train_bf16_joint.py``.
At random weights bf16 is chaotic end to end: an argmin or argmax that
flips moves a disparity by pixels (``tests/test_torch_bf16.py``).  Each
tolerance says where it comes from.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from codd_tpu.models.builder import build_estimator as jbuild
from codd_tpu.models.builder import build_loss_config as jbuild_loss
from codd_tpu.models.stereo.hitnet import tile_warping
from codd_tpu.ops.gn import grad_clip as jgrad_clip
from codd_tpu.train import trainer as jtrainer
from codd_tpu.utils.precision import cast_floats as jcast_floats
from codd_torch.config import load_config
from codd_torch.models.builder import build_estimator, build_loss_config
from codd_torch.ops import tile_warp
from codd_torch.ops.gn import grad_clip
from codd_torch.train import optim, trainer
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

BF = torch.bfloat16
JBF = jnp.bfloat16
T, H, W = 2, 64, 128
MAXD = 32
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def np32(a):
    """A jax or torch array as f32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def tbf(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(BF)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


# ---------------------------------------------------------------------------
# kernel 1's VJP in bf16
# ---------------------------------------------------------------------------

def _strip(seed=0, b=1, h=8, w=1280, c=16):
    """Disparities in (-10, 330): taps leave the image on both sides and
    reach x > 1024, where the bf16 x grid steps by 8; slants in (-3, 3);
    every 7th left column and every 5th right column zero, so that l and
    the warped value tie (|x|'s cotangent is +g at 0, as JAX's)."""
    rng = np.random.RandomState(seed)
    fl, fr = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    fl[:, :, ::7] = 0.0
    fr[:, :, ::5] = 0.0
    d = rng.uniform(-10.0, 330.0, (b, h // 4, w // 4))
    sl = rng.uniform(-3.0, 3.0, (2, b, h // 4, w // 4))
    hyp3 = np.stack([d, sl[0], sl[1]], -1).astype(np.float32)
    g = rng.randn(b, h // 4, w // 4, 48).astype(np.float32)
    return hyp3, fl, fr, g


@pytest.fixture(scope="module")
def vjp_ref():
    hyp3, fl, fr, g = _strip()
    vjp = jax.jit(lambda h, l, r, c: jax.vjp(tile_warping, h, l, r)[1](c))
    ref = vjp(*(jnp.asarray(a).astype(JBF) for a in (hyp3, fl, fr, g)))
    return (hyp3, fl, fr, g), [np32(x) for x in ref]


def test_tile_warp_vjp_bf16_matches_jax(vjp_ref):
    """dhyp3 and dfea_l equal in bits (values: a zero may differ in sign);
    dfea_r within n 2^-8 of its sum of |terms| (XLA's n - 1 rounded adds
    against the port's one rounding; measured 0.65 n at most, 17.6 % of
    the elements off XLA's bits), and XLA's own bits where the port's
    tap cotangents are added in XLA's order, rounded after each add."""
    (hyp3, fl, fr, g), ref = vjp_ref
    ins = [tbf(a) for a in (hyp3, fl, fr)]
    got = tile_warp.tile_warp_cost_backward_plain(tbf(g), *ins)
    assert all(x.dtype == BF for x in got)
    np.testing.assert_array_equal(np32(got[0]), ref[0])
    np.testing.assert_array_equal(np32(got[1]), ref[1])
    terms, n = tile_warp.tile_warp_cost_backward_terms(tbf(g), ins[0],
                                                      ins[2])
    diff = np.abs(np32(got[2]) - ref[2])
    assert (diff <= n.numpy() * 2.0 ** -8 * terms.numpy()).all()
    off = float((diff > 0).mean())
    assert 0.0 < off < 0.3, off
    # XLA's order: pixel by pixel along the row, each add rounded
    B, Hh, Ww, C = fr.shape
    f, ok, idx, cols = tile_warp._taps_exact(ins[0], ins[2])
    dl = tile_warp._pixel_shuffle(tbf(g), 4)
    omf = 1 - f
    e = []
    for kk, j in enumerate((2, 1, 0)):
        warped = cols[..., j, :] * omf + cols[..., j + 1, :] * f
        e.append(tile_warp._abs_vjp(ins[1] - warped, dl[..., kk:kk + 1]))
    a = [-x * omf for x in e]
    b = [-x * f for x in e]
    taps = torch.stack([a[2], b[2] + a[1], b[1] + a[0], b[0]], -2) \
        * ok[..., None].to(BF)
    acc = torch.zeros(B, Hh, Ww + 6, C, dtype=BF)
    bi = torch.arange(B)[:, None, None]
    hi = torch.arange(Hh)[None, :, None]
    for x in range(Ww):
        cidx = idx[:, :, x]
        acc[bi, hi, cidx] = acc[bi, hi, cidx] + taps[:, :, x]
    np.testing.assert_array_equal(np32(acc[:, :, 3:Ww + 3]), ref[2])


def test_tile_warp_autograd_bf16_takes_the_plain_backward(vjp_ref):
    """Under autograd the bf16 cost goes through ``TileWarpCost``: its
    forward is the exact form's bits, its gradients the plain backward's."""
    (hyp3, fl, fr, g), _ = vjp_ref
    ins = [tbf(a).requires_grad_() for a in (hyp3, fl, fr)]
    out = tile_warp.tile_warp_cost(*ins)
    assert out.dtype == BF and out.requires_grad
    with torch.no_grad():
        assert torch.equal(out, tile_warp.tile_warp_cost_plain(*ins))
    out.backward(tbf(g))
    plain = tile_warp.tile_warp_cost_backward_plain(
        tbf(g), *(t.detach() for t in ins))
    for t, p in zip(ins, plain):
        assert t.grad.dtype == BF
        assert torch.equal(t.grad, p)


def test_tile_warp_pallas_form_has_no_vjp():
    """codd_tpu differentiates only tile_warping (the "exact" form)."""
    hyp3, fl, fr, _ = _strip(h=4, w=64)
    ins = [tbf(a).requires_grad_() for a in (hyp3, fl, fr)]
    with pytest.raises(NotImplementedError):
        tile_warp.tile_warp_cost(*ins, form="pallas")
    with torch.no_grad():
        assert tile_warp.tile_warp_cost(*ins, form="pallas").dtype == BF


# ---------------------------------------------------------------------------
# grad_clip on bf16 cotangents
# ---------------------------------------------------------------------------

def test_grad_clip_bf16_matches_jax():
    """The cotangents around the threshold: bf16's 0.01 (0.010009765625)
    and its neighbours, 0.00999 and 0.0101 rounded, signs, NaN, inf: the
    same bits as codd_tpu's ``_gc_bwd`` (|g| > clip compared in bf16)."""
    step = 2.0 ** -14  # bf16's ulp at 0.01
    v = np.array([0.0, 0.01, 0.0101, 0.00999, 0.010009765625,
                  0.010009765625 + step, 0.010009765625 - step / 2, 0.5,
                  1e-3, np.nan, np.inf], np.float32)
    v = np.concatenate([v, -v])
    x = jnp.zeros(v.shape, JBF)
    ref = jax.vjp(jgrad_clip, x)[1](jnp.asarray(v).astype(JBF))[0]
    xt = torch.zeros(v.shape, dtype=BF, requires_grad=True)
    grad_clip(xt).backward(tbf(v))
    assert xt.grad.dtype == BF
    np.testing.assert_array_equal(np32(xt.grad), np32(ref))
    # the threshold's neighbours: kept at bf16's 0.01, zeroed one ulp above
    kept = np32(xt.grad)[:len(v) // 2]
    assert kept[4] != 0 and kept[5] == 0


# ---------------------------------------------------------------------------
# one tile-update stage's VJP in bf16 (kernel 1's exact form inside)
# ---------------------------------------------------------------------------

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


def test_tile_update_stage_vjp_bf16():
    """``TileUpdate`` (two tile warps of kernel 1's exact form, the slant
    upsample, the convolutions, the confidence argmax) in bf16 on the same
    seeded inputs, weights and cotangents: its outputs and the gradients of
    every weight and input against ``jax.vjp`` in bf16.  The outputs agree
    to 1e-2 of their norm (measured 5e-3: the port's CPU bf16 convolutions
    round once after an f32 sum, XLA's in its own order).  The gradients
    differ more: XLA's CPU reduce of a bf16 array rounds after every add
    (a bias gradient sums the cotangents over every pixel so), where the
    port sums in f32 and rounds once, as cuDNN does on the card; and a
    sign of |l - w| follows any ulp that reaches it.  Each gradient is held
    to 0.15 of its norm (measured 2e-2 to 7.9e-2; an f32 evaluation of the
    same stage is 10-77 % away from both), and the argmax selects the same
    hypothesis on at least 99 % of the tiles."""
    from codd_tpu.models.stereo.hitnet import TileUpdate as JTileUpdate
    from codd_torch.models.stereo.hitnet import TileUpdate as TTileUpdate
    rng = np.random.RandomState(3)
    h, w = 32, 64
    fl, fr = (rng.randn(1, h, w, 16).astype(np.float32) for _ in range(2))
    cur = rng.randn(1, h // 4, w // 4, 16).astype(np.float32)
    prev = rng.randn(1, h // 8, w // 8, 16).astype(np.float32)
    for hyp, d in ((cur, 12.0), (prev, 6.0)):
        hyp[..., 0] = np.abs(hyp[..., 0]) * d
        hyp[..., 1:3] *= 0.3
    jmod = JTileUpdate()
    ins = [jnp.asarray(a).astype(JBF) for a in (fl, fr, cur, prev)]
    v = _numpy_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                     *ins))
    outs, vjp = jax.vjp(lambda p, *a: jmod.apply(jcast_floats(p, JBF), *a),
                        v, *ins)
    gs = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    jg = vjp(tuple(jnp.asarray(g).astype(JBF) for g in gs))
    tmod = TTileUpdate()
    tmod.load_state_dict(torch_state_dict_from_jax(v), strict=True)
    params = dict(tmod.named_parameters())
    tins = [tbf(a).requires_grad_() for a in (fl, fr, cur, prev)]
    with trainer.compute_copies(tmod, BF):
        touts = tmod(*tins, train=True)
        torch.autograd.backward(touts, [tbf(g) for g in gs])
    for o, t in zip(outs, touts):
        assert t.dtype == BF and rel_norm(np32(t), np32(o)) <= 1e-2
    sel_j = np32(outs[0])[..., 0] == np32(outs[1])[..., 0]
    sel_t = np32(touts[0])[..., 0] == np32(touts[1])[..., 0]
    assert (sel_j == sel_t).mean() >= 0.99
    jp = torch_state_dict_from_jax(jax.tree_util.tree_map(np32, jg[0]))
    for k, p in params.items():
        assert p.grad.dtype == torch.float32
        assert rel_norm(p.grad.numpy(), jp[k].numpy()) <= 0.15, k
    for t, g in zip(tins, jg[1:]):
        assert t.grad.dtype == BF
        assert rel_norm(np32(t.grad), np32(g)) <= 0.15


# ---------------------------------------------------------------------------
# the stereo stage's step
# ---------------------------------------------------------------------------

def _cfg(name, *options):
    opts = [f"model.stereo.initialization.max_disp={MAXD}",
            f"model.stereo.loss.max_disp={MAXD}"] + list(options)
    return dict(load_config(str(ROOT / "configs" / "models" / name),
                            opts)["model"])


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1.0, 25.0, (b, T, H, W, 1)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.05] = 0.0
    return {
        "l_img": rng.rand(b, T, H, W, 3).astype(np.float32),
        "r_img": rng.rand(b, T, H, W, 3).astype(np.float32),
        "gt_disp": gt,
        "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]] * b,
                               np.float32),
    }


class _Sgd:
    """SGD(1.0) in the optimizer's interface: the update is -grad."""

    def init(self, params):
        return optim.AdamState(0, {}, {})

    def trained_names(self, tree):
        return list(tree)

    def update(self, grads, state, params=None):
        return {k: -g for k, g in grads.items()}, state


def _port(cfg, variables):
    m = build_estimator(cfg, device="cpu", seed=None)
    m.load_state_dict(torch_state_dict_from_jax(variables), strict=True)
    return m


@pytest.fixture(scope="module")
def stereo_bf16():
    """codd_tpu's ``make_train_step(bf16_compute=True)`` under SGD(1.0):
    the update is minus the gradient of the f32 masters."""
    cfg, batch = _cfg("stereo.py"), _batch()
    jm, lc = jbuild(cfg), jbuild_loss(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes)
    tx = optax.sgd(1.0)
    state, logs = jtrainer.make_train_step(jm, tx, lc, bf16_compute=True)(
        jtrainer.create_train_state(variables, tx), batch)
    grads = jax.tree_util.tree_map(lambda a, b: np32(a) - np32(b),
                                   variables, state.params)
    assert all(x.dtype == jnp.float32
               for x in jax.tree_util.tree_leaves(state.params))
    return dict(cfg=cfg, batch=batch, variables=variables,
                grads=torch_state_dict_from_jax(grads),
                logs={k: float(v) for k, v in logs.items()})


def test_stereo_step_bf16_matches_codd_tpu(stereo_bf16):
    """The step on f32 masters: every gradient and parameter f32.  At
    random weights the bf16 stereo stage is chaotic (the init cost's argmin
    and the tile updates' argmax flip on near ties, moving a disparity by
    pixels), so the step is held loosely and its stages tightly
    (test_tile_update_stage_vjp_bf16, test_tile_warp_vjp_bf16_matches_jax):
    the loss to 2e-2 (measured 3.4e-3), grad_norm to 0.15 (6.6e-2; 1.1e-2
    on another seed), the gradients' per-tensor error to a median of 0.5
    of their norm (0.21; up to 1.03 for a few small tensors) and their
    error over all tensors to 0.5 (0.16)."""
    s = stereo_bf16
    model = _port(s["cfg"], s["variables"])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = trainer.make_train_step(model, _Sgd(), build_loss_config(s["cfg"]),
                                   bf16_compute=True)
    state, logs = step(trainer.create_train_state(model, _Sgd()),
                       {k: _t(v) for k, v in s["batch"].items()})
    assert rel(logs["loss"].item(), s["logs"]["loss"]) < 2e-2
    assert rel(logs["grad_norm"].item(), s["logs"]["grad_norm"]) < 0.15
    assert logs["step_skipped"].item() == s["logs"]["step_skipped"] == 0
    errs, num, den = [], 0.0, 0.0
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is None, k
        g = (before[k] - p.detach()).numpy()
        ref = s["grads"][k].numpy()
        num += float(np.sum((g.astype(np.float64) - ref) ** 2))
        den += float(np.sum(ref.astype(np.float64) ** 2))
        if np.any(ref):
            errs.append(rel_norm(g, ref))
    assert np.median(errs) < 0.5
    assert np.sqrt(num / den) < 0.5


def test_stereo_step_bf16_adam_keeps_f32(stereo_bf16):
    """With Adam (the stereo schedule's), the masters and both moments stay
    f32 and finite after two steps; the loss is finite."""
    s = stereo_bf16
    model = _port(s["cfg"], s["variables"])
    opt = optim.make_optimizer(lambda step: 4e-4, 1.0)
    step = trainer.make_train_step(model, opt, build_loss_config(s["cfg"]),
                                   bf16_compute=True)
    state = trainer.create_train_state(model, opt)
    batch = {k: _t(v) for k, v in s["batch"].items()}
    for _ in range(2):
        state, logs = step(state, batch)
        assert np.isfinite(logs["loss"].item())
    assert state.opt_state.count == 2
    for tree in (state.params, state.opt_state.mu, state.opt_state.nu):
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
                   for v in tree.values())


def test_accumulation_bf16_matches_full_batch(stereo_bf16):
    """accum_steps=2 against 1 under bf16 compute and SGD(1.0): the losses
    are batch means, but the CPU convolutions of a batch of 4 views and of
    2 sum in other orders, so a bf16 rounding moves here and there and the
    chaos above carries it: the loss to 5e-4 (measured 5.3e-5), the
    gradient norm to 5e-3 (4.2e-4) and each update to 0.1 of its norm
    (2.4e-2 at most, 4.7e-3 at the median)."""
    s = stereo_bf16
    batch = {k: _t(v) for k, v in s["batch"].items()}
    res = []
    for accum in (1, 2):
        model = _port(s["cfg"], s["variables"])
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        step = trainer.make_train_step(model, _Sgd(),
                                       build_loss_config(s["cfg"]), accum,
                                       bf16_compute=True)
        _, logs = step(trainer.create_train_state(model, _Sgd()), batch)
        res.append((logs, {k: (p.detach() - before[k]).numpy()
                           for k, p in model.named_parameters()}))
    (l1, d1), (l2, d2) = res
    assert rel(l2["loss"].item(), l1["loss"].item()) < 5e-4
    assert rel(l2["grad_norm"].item(), l1["grad_norm"].item()) < 5e-3
    for k in d1:
        assert rel_norm(d2[k], d1[k]) <= 0.1, k


# ---------------------------------------------------------------------------
# the convex upsampling's softmax in bf16
# ---------------------------------------------------------------------------

def test_softmax_bf16_matches_jax():
    """``utils/precision.py:softmax`` below f32 against ``jax.nn.softmax``
    run op by op on the mask's shape (B, h, w, 9, 8, 8), axis 3: the
    forward and its VJP in bits (``torch.softmax`` rounds once and moves
    ~47 % of the values by an ulp); f32 is ``torch.softmax``."""
    from codd_torch.utils.precision import softmax
    rng = np.random.RandomState(4)
    x = (rng.randn(1, 4, 8, 9, 8, 8) * 3).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    with jax.disable_jit():
        y, vjp = jax.vjp(lambda t: jax.nn.softmax(t, axis=3),
                         jnp.asarray(x).astype(JBF))
        gx = vjp(jnp.asarray(g).astype(JBF))[0]
    xt = tbf(x).requires_grad_()
    yt = softmax(xt, 3)
    yt.backward(tbf(g))
    assert yt.dtype == BF and xt.grad.dtype == BF
    np.testing.assert_array_equal(np32(yt), np32(y))
    np.testing.assert_array_equal(np32(xt.grad), np32(gx))
    assert (np32(torch.softmax(tbf(x), 3)) != np32(y)).mean() > 0.1
    x32 = _t(x)
    assert torch.equal(softmax(x32, 3), torch.softmax(x32, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absolute_vjp_matches_jnp_abs(dtype):
    """``utils/precision.py:absolute`` against ``jax.vjp`` of ``jnp.abs``
    on values with exact zeros (+0 and -0): the values and the cotangents
    in bits, +g at 0, where ``torch.abs``'s backward gives 0."""
    from codd_torch.utils.precision import absolute
    rng = np.random.RandomState(6)
    x = rng.randn(4, 64).astype(np.float32)
    x[:, ::3] = 0.0
    x[:, 1::7] = -0.0
    g = rng.randn(*x.shape).astype(np.float32)
    y, vjp = jax.vjp(jnp.abs, jnp.asarray(x).astype(dtype))
    gx = vjp(jnp.asarray(g).astype(dtype))[0]
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    yt = absolute(xt)
    yt.backward(torch.tensor(g).to(xt.dtype))
    np.testing.assert_array_equal(np32(yt), np32(y))
    np.testing.assert_array_equal(np32(xt.grad), np32(gx))
    zero = x == 0
    np.testing.assert_array_equal(np32(xt.grad)[zero],
                                  np32(torch.tensor(g).to(xt.dtype))[zero])
    with torch.no_grad():
        assert torch.equal(absolute(xt), torch.abs(xt))
