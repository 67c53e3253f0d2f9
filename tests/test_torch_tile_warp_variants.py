"""``tile_warp_variant`` ``tilewin`` and ``grouped``: the port's
``tile_warp_tilewin`` / ``tile_warp_grouped`` against codd_tpu's
``tile_warping_tilewin`` / ``tile_warping_grouped`` on the same numpy
inputs, in the forward (f32 and bf16, slants of sigma 0.3 and 3.0), the f32
VJP against ``jax.vjp``, and a stereo-stage training step with
``tile_warp_variant="tilewin"`` against ``jax.value_and_grad`` of
codd_tpu's stage, as tests/test_torch_train.py holds the ``auto`` one.

Tolerances.  bf16: equal in bits to codd_tpu's functions run op by op
(every bf16 step rounded; plain ``jax.jit`` keeps ``grouped``'s lerp in f32
inside a fusion and then differs by one bf16 ulp).  f32: 1e-5 of the
largest cost, as kernel 1's f32 tests (measured 2.2e-6): the port's f32
plane offsets are -0.5 where ``jnp.linspace`` gives -0.49999994, and the
16-channel L1 sums run in another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.losses import assembly as jassembly
from codd_tpu.models.builder import build_estimator as jbuild
from codd_tpu.models.builder import build_loss_config as jbuild_loss
from codd_tpu.models.stereo import hitnet as jhit
from codd_torch.config import load_config
from codd_torch.losses import assembly
from codd_torch.models.builder import build_estimator, build_loss_config
from codd_torch.ops import tile_warp
from codd_torch.train import optim, trainer
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
VARIANTS = {"tilewin": (jhit.tile_warping_tilewin,
                        tile_warp.tile_warp_tilewin),
            "grouped": (jhit.tile_warping_grouped,
                        tile_warp.tile_warp_grouped)}


def _inputs(sigma, seed=0, B=1, H=16, W=64, C=16):
    """Disparities in (2, 20), slants dx, dy drawn N(0, sigma^2)."""
    rng = np.random.RandomState(seed)
    fl = rng.randn(B, H, W, C).astype(np.float32)
    fr = rng.randn(B, H, W, C).astype(np.float32)
    ht, wt = H // 4, W // 4
    hyp3 = np.stack([rng.uniform(2.0, 20.0, (B, ht, wt)),
                     rng.randn(B, ht, wt) * sigma,
                     rng.randn(B, ht, wt) * sigma], -1).astype(np.float32)
    return hyp3, fl, fr


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma", [0.3, 3.0])
@pytest.mark.parametrize("variant", ["tilewin", "grouped"])
def test_variant_matches_codd_tpu(variant, sigma, dtype):
    jfn, tfn = VARIANTS[variant]
    args = _inputs(sigma)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax.disable_jit():
        ref = np.asarray(jfn(*(jnp.asarray(a, jdt) for a in args)
                             ).astype(jnp.float32))
    t = [torch.from_numpy(a).to(tdt) for a in args]
    got = tfn(*t)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape == (1, 4, 16,
                                                                  48)
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
    else:
        assert _rel(got, ref) < 1e-5
    # another function than tile_warping where slants are large: taps
    # outside the window read zero
    exact = tile_warp.tile_warp_cost_plain(*t).float().numpy()
    if sigma == 3.0:
        assert (got != exact).mean() > 0.01


@pytest.mark.parametrize("sigma", [0.3, 3.0])
@pytest.mark.parametrize("variant", ["tilewin", "grouped"])
def test_variant_vjp_matches_jax_vjp(variant, sigma):
    """Autograd through the port's function against ``jax.vjp`` of
    codd_tpu's, f32, B=2: 1e-5 of each gradient's largest value, the
    bound of kernel 1's VJP test (measured 1.9e-6: fea_r's taps summed in
    another order, hyp3's 16 pixels x 16 channels x 3 offsets too)."""
    jfn, tfn = VARIANTS[variant]
    hyp3, fl, fr = _inputs(sigma, seed=1, B=2)
    g = np.random.RandomState(5).randn(2, 4, 16, 48).astype(np.float32)
    out, vjp = jax.vjp(jfn, *map(jnp.asarray, (hyp3, fl, fr)))
    ref = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    ins = [torch.from_numpy(a).requires_grad_() for a in (hyp3, fl, fr)]
    got = tfn(*ins)
    assert _rel(got.detach().numpy(), out) < 1e-5
    got.backward(torch.from_numpy(g))
    for name, t, r in zip(("hyp3", "fea_l", "fea_r"), ins, ref):
        assert np.any(r), name
        assert _rel(t.grad.numpy(), r) < 1e-5, name


def test_tilewin_contraction_checked():
    args = [torch.from_numpy(a) for a in _inputs(0.3)]
    assert torch.equal(tile_warp.tile_warp_tilewin(*args, contraction="mac"),
                       tile_warp.tile_warp_tilewin(*args))
    with pytest.raises(ValueError):
        tile_warp.tile_warp_tilewin(*args, contraction="einsum")


# ---------------------------------------------------------------------------
# a stereo-stage step with tile_warp_variant="tilewin"
# ---------------------------------------------------------------------------

B, T, H, W = 1, 2, 64, 128
MAXD = 32


def _cfg(*options):
    opts = [f"model.stereo.initialization.max_disp={MAXD}",
            f"model.stereo.loss.max_disp={MAXD}"] + list(options)
    return dict(load_config(str(ROOT / "configs" / "models" / "stereo.py"),
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


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1.0, 25.0, (B, T, H, W, 1)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.05] = 0.0
    return {"l_img": rng.rand(B, T, H, W, 3).astype(np.float32),
            "r_img": rng.rand(B, T, H, W, 3).astype(np.float32),
            "gt_disp": gt,
            "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]] * B,
                                   np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def tilewin_stage():
    cfg = _cfg("model.runtime.tile_warp_variant=tilewin")
    batch = _batch()
    jm, lc = jbuild(cfg), jbuild_loss(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes)

    def loss_fn(v):
        outs = jm.apply(v, batch["l_img"], batch["r_img"],
                        batch["intrinsics"], train=True)
        return jassembly.codd_train_loss(lc, outs, batch)

    (loss, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables)
    np32 = lambda tree: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), tree)
    return dict(cfg=cfg, batch=batch, variables=variables, loss=float(loss),
                logs=np32(logs), grads=torch_state_dict_from_jax(np32(grads)))


def test_stereo_step_with_tilewin_matches(tilewin_stage, monkeypatch):
    """The stereo stage with ``tile_warp_variant="tilewin"``: its
    propagation runs ``tile_warp_tilewin`` (kernel 1's wrapper is not
    called), the loss to 1e-5, each log to 1e-4 and every parameter's
    gradient to 1e-3 of its norm against codd_tpu's, the bounds of
    tests/test_torch_train.py's ``auto`` stage; then one training step."""
    s = tilewin_stage
    calls = {"tilewin": 0, "kernel 1": 0}
    real = tile_warp.tile_warp_tilewin
    from codd_torch.models.stereo import hitnet as thit
    monkeypatch.setattr(thit, "tile_warp_tilewin", lambda *a: calls.update(
        tilewin=calls["tilewin"] + 1) or real(*a))
    monkeypatch.setattr(thit, "tile_warp_cost", lambda *a: calls.update(
        {"kernel 1": calls["kernel 1"] + 1}))
    model = build_estimator(s["cfg"], device="cpu", seed=None)
    model.load_state_dict(torch_state_dict_from_jax(s["variables"]),
                          strict=True)
    tb = {k: _t(v) for k, v in s["batch"].items()}
    outs = model(tb["l_img"], tb["r_img"], tb["intrinsics"], train=True)
    loss, logs = assembly.codd_train_loss(build_loss_config(s["cfg"]), outs,
                                          tb)
    loss.backward()
    # 9 warps a frame (one in tile_update0, two in each of 1-4), T frames
    assert calls == {"tilewin": 9 * T, "kernel 1": 0}
    assert _rel(loss.item(), s["loss"]) < 1e-5
    for k, v in s["logs"].items():
        assert _rel(logs[k].item(), v) < 1e-4, k
    checked = 0
    for k, p in model.named_parameters():
        ref = s["grads"][k].numpy()
        if not np.any(ref):
            assert p.grad is None or float(p.grad.abs().max()) <= 1e-6, k
            continue
        err = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref)
        assert err <= 1e-3 * np.linalg.norm(ref), (k, err)
        checked += 1
    assert checked > 100
    tx = optim.make_optimizer(lambda step: 1e-3, 1.0)
    step = trainer.make_train_step(model, tx, build_loss_config(s["cfg"]))
    state, slogs = step(trainer.create_train_state(model, tx), tb)
    assert state.opt_state.count == 1 and np.isfinite(slogs["loss"].item())


@pytest.mark.parametrize("variant", ["tilewin", "grouped"])
def test_variants_train_in_bf16(variant):
    """bf16 compute trains through both variants (their ATen ops in bf16,
    tilewin's lerps and costs in f32): a finite loss and finite gradients
    of every stereo parameter, f32 masters.  Only "pallas" raises
    (tests/test_torch_train.py::test_unported_training_raises)."""
    cfg = _cfg(f"model.runtime.tile_warp_variant={variant}")
    model = build_estimator(cfg, device="cpu")
    tx = optim.make_optimizer(lambda step: 1e-3, 1.0)
    step = trainer.make_train_step(model, tx, build_loss_config(cfg),
                                   bf16_compute=True)
    state, logs = step(trainer.create_train_state(model, tx),
                       {k: _t(v) for k, v in _batch(seed=3).items()})
    assert np.isfinite(logs["loss"].item())
    assert np.isfinite(logs["grad_norm"].item()) and logs["grad_norm"] > 0
    assert all(p.dtype == torch.float32 for p in model.parameters())
