"""Training on the CPU, the joint model: codd_torch's training step of
``configs/models/codd.py`` (stereo, RAFT-3D and fusion trained together)
against codd_tpu's, on the same numpy weights and batches.

* the training splat: ``splat_render``'s VJP (kernel 4 with its backward,
  ``SplatComposite``, whose plain version runs on the CPU) against
  ``jax.vjp`` of ``_splat_one_sort``, the reference's differentiable
  splat, on seeded scenes without ties, at both call sites (r=1 / C=6,
  r=2 / C=32), cotangents on the features and the depth buffer;
* the patch lookup's coordinate gradient: the four-level lookup's VJP
  with respect to the coordinates against ``jax.vjp`` of ``_lookup_level``
  over codd_tpu's pyramid, with queries inside, on the rim of and outside
  the levels;
* the joint step at 64x128, B=1, T=2, 2 GN iterations: the loss and every
  parameter's gradient against ``jax.value_and_grad`` of codd_tpu's loss,
  for ``codd.py`` as it stands and with ``freeze_stereo`` (the motion and
  fusion gradients of one are the other's: the stereo is upstream of
  both, and its train branch's ``pred_disp`` is its eval branch's; the
  frozen loss is the JAX loss less its stereo terms), free-running and
  teacher-forced.

One JAX compile (``value_and_grad`` of the whole model, nothing frozen,
~130 s on an 8-core CPU), shared by the joint cases.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.losses import assembly as jassembly
from codd_tpu.models.builder import build_estimator as jbuild
from codd_tpu.models.builder import build_loss_config as jbuild_loss
from codd_tpu.models.motion.motion import Motion as JMotion
from codd_tpu.ops import corr as jcorr
from codd_tpu.ops import splat as jsplat
from codd_torch.config import load_config
from codd_torch.losses import assembly
from codd_torch.models.builder import build_estimator, build_loss_config
from codd_torch.ops import corr as tcorr
from codd_torch.ops import splat as tsplat
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

B, T, H, W = 1, 2, 64, 128
MAXD = 32
ITERS = 2
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def _cfg(*options):
    opts = [f"model.stereo.initialization.max_disp={MAXD}",
            f"model.stereo.loss.max_disp={MAXD}",
            f"model.motion.iters={ITERS}"] + list(options)
    return dict(load_config(str(ROOT / "configs" / "models" / "codd.py"),
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
    """Seeded clip with motion supervision: images, disparity in (1, 25),
    flow in (-3, 3) px, disparity change in (-1, 1)."""
    rng = np.random.RandomState(seed)
    return {
        "l_img": rng.rand(B, T, H, W, 3).astype(np.float32),
        "r_img": rng.rand(B, T, H, W, 3).astype(np.float32),
        "gt_disp": rng.uniform(1.0, 25.0, (B, T, H, W, 1)).astype(np.float32),
        "gt_flow": rng.uniform(-3.0, 3.0, (B, T, H, W, 2)).astype(np.float32),
        "gt_disp_change": rng.uniform(-1.0, 1.0, (B, T, H, W, 1)
                                      ).astype(np.float32),
        "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]] * B,
                               np.float32),
    }


# ---------------------------------------------------------------------------
# the training splat
# ---------------------------------------------------------------------------

def _scene(h, w, C, N, seed, radius):
    """Seeded points whose depths lie 2 % apart (distinct in the packed
    keys, so both sorts order every pixel's fragments alike; as
    tests/test_torch_splat.py), a few behind the camera."""
    rng = np.random.RandomState(seed)
    fx = fy = 15.0
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    Z = (1.02 ** rng.permutation(N)).astype(np.float32)
    px = rng.uniform(-radius, w + radius, N).astype(np.float32)
    py = rng.uniform(-radius, h + radius, N).astype(np.float32)
    pts = np.stack([(px - cx) / fx * Z, (py - cy) / fy * Z, Z], -1)
    pts[:3, 2] = -1.0   # behind the camera: culled
    feats = rng.randn(N, C).astype(np.float32)
    intr = np.array([fx, fy, cx, cy], np.float32)
    return pts.astype(np.float32), feats, intr


def _in_graph(t, name):
    """Whether autograd's graph behind ``t`` holds a node called ``name``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        if type(fn).__name__ == name:
            return True
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return False


@pytest.mark.parametrize("h,w,C,N,radius", [
    (10, 12, 6, 80, 1.0),    # the full-res call: C=6, r=1
    (12, 16, 32, 70, 2.0),   # the quarter-res call: C=32, r=2
])
def test_splat_vjp_matches_splat_one_sort(h, w, C, N, radius):
    """The gradients of the points and the features, for random cotangents
    on the composited features and the depth buffer: the port's
    ``splat_render`` (``SplatComposite``: kernel 4's plain forward and
    ``composite_backward_plain``, autograd through the projection) against
    ``jax.vjp`` of ``_splat_one_sort``, to 1e-5 of the largest (measured
    5e-7 for the points, 2e-6 for the features: f32 sums in another
    order; codd_tpu's global cumsum rounds its forward, not its VJP, which
    differentiates each difference exactly).  ``composite_backward_plain``
    gives the features' gradient in bits, and its alpha and depth
    gradients are autograd's through ``composite_plain``."""
    pts, feats, intr = _scene(h, w, C, N, seed=C, radius=radius)
    rng = np.random.RandomState(C + 1)
    go = rng.randn(h, w, C).astype(np.float32)
    gz = rng.randn(h, w).astype(np.float32)
    def jfn(p, f, go, gz):   # one compile, not one per op
        out, vjp = jax.vjp(lambda p, f: jsplat._splat_one_sort(
            p, f, jnp.asarray(intr), h, w, radius, 8, 0.0), p, f)
        return out, vjp((go, gz))

    (jo, jz), (jp, jf) = jax.tree_util.tree_map(
        np.asarray, jax.jit(jfn)(pts, feats, go, gz))
    p, f = _t(pts).requires_grad_(), _t(feats).requires_grad_()
    out, zb = tsplat.splat_render(p[None], f[None], _t(intr)[None], h, w,
                                  radius)
    assert _in_graph(out, "SplatCompositeBackward")
    assert rel(out.detach().numpy()[0], np.asarray(jo)) < 1e-4
    assert rel(zb.detach().numpy()[0], np.asarray(jz)) < 1e-4
    ((out[0] * _t(go)).sum() + (zb[0] * _t(gz)).sum()).backward()
    assert rel(p.grad.numpy(), jp) < 1e-5
    assert rel(f.grad.numpy(), jf) < 1e-5

    order, offsets, alpha, Z = tsplat.sort_fragments(_t(pts), _t(intr), h, w,
                                                     radius)
    g2, gz2 = _t(go).reshape(-1, C), _t(gz).reshape(-1)
    df, da, dz = tsplat.composite_backward_plain(order, offsets, alpha,
                                                 _t(feats), g2, gz2)
    assert torch.equal(df, f.grad)
    a_ = alpha.clone().requires_grad_()
    z_ = Z.clone().requires_grad_()
    o_, zb_, _ = tsplat.composite_plain(order, offsets, a_, z_, _t(feats))
    ((o_ * g2).sum() + (zb_ * gz2).sum()).backward()
    assert rel(da.numpy(), a_.grad.numpy()) < 1e-6
    assert torch.equal(dz, z_.grad)


def test_splat_forward_only_without_a_gradient():
    """Without a gradient to give (no input requires one, or under
    ``torch.no_grad()``) ``splat_render`` composites without autograd; its
    output is the differentiable path's in bits."""
    pts, feats, intr = _scene(10, 12, 6, 80, seed=6, radius=1.0)
    args = (_t(pts)[None], _t(feats)[None], _t(intr)[None], 10, 12, 1.0)
    plain = tsplat.splat_render(*args)
    assert plain[0].grad_fn is None
    p = args[0].clone().requires_grad_()
    with torch.no_grad():
        assert tsplat.splat_render(p, *args[1:])[0].grad_fn is None
    diff = tsplat.splat_render(p, *args[1:])
    assert diff[0].grad_fn is not None
    assert all(torch.equal(a, b.detach()) for a, b in zip(plain, diff))


# ---------------------------------------------------------------------------
# the patch lookup's coordinate gradient
# ---------------------------------------------------------------------------

def test_patch_lookup_coords_vjp_matches_jax():
    """The four-level patch lookup's VJP with respect to the coordinates
    (``CorrPatchLookup``, the plain coordinate backward on the CPU)
    against ``jax.vjp`` of codd_tpu's ``_lookup_level`` over the same bf16
    pyramid at ``coords / 2^l``, to 1e-5 of the largest (measured 3e-7:
    f32 sums of 49 taps in another order).  Queries inside, on the rim of
    and outside the levels; a query whose window misses a level has no
    gradient from it.  The lookup's own gradients still reach f1 and the
    levels; the plain coordinate backward is the Function's in bits."""
    rng = np.random.RandomState(4)
    Bc, h, w, C = 2, 8, 16, 128
    f1 = rng.randn(Bc, h, w, C).astype(np.float32)
    f2 = rng.randn(Bc, h, w, C).astype(np.float32)
    coords = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
              + rng.uniform(-6, 6, (Bc, h, w, 2))).astype(np.float32)
    coords[:, 0, 0] = (-40.5, 3.25)         # outside every level
    coords[:, 1, 1] = (w + 8.5, h + 8.5)    # outside level 0, not level 3
    coords[:, 2, 2] = (-3.75, 2.5)          # on the rim: part of the window
    coords[:, 3, 3] = (w + 2.5, -3.5)
    g = rng.randn(Bc, h, w, 4 * 49).astype(np.float32)
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4,
                                    impl="patch")

    def jfn(c):
        return jnp.concatenate(
            [jcorr._lookup_level(jpyr["f1"], lvl, c / 2 ** i, 3)
             for i, lvl in enumerate(jpyr["levels"])], -1)

    out, vjp = jax.vjp(jfn, jnp.asarray(coords))
    (jdc,) = vjp(jnp.asarray(g))
    jdc = np.asarray(jdc)
    assert np.abs(jdc[:, 0, 0]).max() == 0.0 and np.abs(jdc).max() > 1.0
    a, b = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    pyr = tcorr.build_corr_pyramid(a, b, 4, 3, impl="patch")
    ct = _t(coords).requires_grad_()
    got = tcorr.corr_lookup(pyr, ct, 3)
    assert rel(got.detach().numpy(), np.asarray(out)) < 1e-6
    got.backward(_t(g))
    assert rel(ct.grad.numpy(), jdc) < 1e-5
    assert ct.grad[:, 0, 0].abs().max() == 0.0
    assert a.grad is not None and b.grad is not None
    plain = tcorr.corr_patch_lookup_coords_backward_plain(
        _t(g), pyr["f1"].detach(), [l.detach() for l in pyr["levels"]],
        _t(coords), 3)
    assert torch.equal(plain, ct.grad)


# ---------------------------------------------------------------------------
# the joint step
# ---------------------------------------------------------------------------

def _jax_loss_fn(jm, lc, batch):
    capture = lambda mdl, name: isinstance(mdl, JMotion) and \
        name == "__call__"  # noqa: E731

    def f(v):
        outs, inter = jm.apply(v, batch["l_img"], batch["r_img"],
                               batch["intrinsics"], train=True,
                               capture_intermediates=capture,
                               mutable=["intermediates"])
        loss, logs = jassembly.codd_train_loss(lc, outs, batch)
        return loss, (logs, inter)
    return f


@pytest.fixture(scope="module")
def joint_ref():
    """codd_tpu's loss and gradients of ``codd.py`` with nothing frozen,
    and its motion module's output (the warped memory) at frame 1."""
    cfg = _cfg()
    batch = _batch()
    jm, lc = jbuild(cfg), jbuild_loss(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes, seed=3)
    (loss, (logs, inter)), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jm, lc, batch), has_aux=True))(variables)
    memory5 = inter["intermediates"]["motion"]["__call__"][0][0]
    return dict(batch=batch, variables=variables, loss=float(loss),
                logs=_np(logs), memory5=_np(memory5),
                grads=torch_state_dict_from_jax(_np(grads)))


def _port_run(ref, frozen_stereo, teacher_forced):
    """The port's loss, logs and gradients; teacher-forced, the warped
    memory takes codd_tpu's values and keeps the port's graph (``x + (ref
    - x).detach()``), so the fusion sees codd_tpu's inputs while every
    gradient still flows through the port's splats."""
    cfg = _cfg(*(["model.train_cfg.freeze_stereo=True"] if frozen_stereo
                 else []))
    model = build_estimator(cfg, device="cpu", seed=None)
    model.load_state_dict(torch_state_dict_from_jax(ref["variables"]),
                          strict=True)
    if teacher_forced:
        real = model.motion.forward

        def forced(*a, **k):
            mem, raft_out, fmap, netinp = real(*a, **k)
            mem = tuple(m + (_t(r) - m).detach()
                        for m, r in zip(mem, ref["memory5"]))
            return mem, raft_out, fmap, netinp
        model.motion.forward = forced
    tb = {k: _t(v) for k, v in ref["batch"].items()}
    outs = model(tb["l_img"], tb["r_img"], tb["intrinsics"], train=True)
    loss, logs = assembly.codd_train_loss(build_loss_config(cfg), outs, tb)
    loss.backward()
    return (loss.item(), {k: v.item() for k, v in logs.items()},
            {k: (None if p.grad is None else p.grad.numpy().copy())
             for k, p in model.named_parameters()})


def _noise(grads):
    """Parameters whose gradient vanishes by invariance (the biases in
    front of instance norms, the ae head's bias): f32 noise below 1e-6 of
    the largest norm in codd_tpu."""
    norms = {k: float(np.linalg.norm(g.numpy())) for k, g in grads.items()}
    top = max(norms.values())
    return {k for k, n in norms.items() if 0 < n <= 1e-6 * top}, top


def _check(ref, loss, logs, grads, frozen_stereo, loss_bound, fusion_bound,
           bound):
    """The loss (less the stereo terms when the stereo is frozen) to
    ``loss_bound``, the logs to that or 1e-4, each trained fusion
    parameter's gradient to ``fusion_bound`` of its norm and every other
    one's to ``bound``; noise gradients to 1e-6 of the largest norm; a
    frozen stereo has none."""
    stereo = ("loss_disp", "init_loss", "prop_loss", "slant_loss", "w_loss")
    keep = {k: v for k, v in ref["logs"].items() if k != "loss" and not (
        frozen_stereo and k.rstrip("0123456789") in stereo)}
    want = (sum(float(v) for k, v in keep.items() if k.startswith("loss"))
            if frozen_stereo else ref["loss"])
    assert set(logs) == set(keep) | {"loss"}
    assert rel(loss, want) < loss_bound
    for k, v in keep.items():
        assert rel(logs[k], v) < max(loss_bound, 1e-4), k
    noise, top = _noise(ref["grads"])
    checked = 0
    for k, g in grads.items():
        r = ref["grads"][k].numpy()
        if frozen_stereo and k.startswith("stereo."):
            assert g is None, k
            continue
        if not np.any(r):
            assert g is None or not np.any(g), k
            continue
        assert g is not None, k
        diff = float(np.linalg.norm(g.astype(np.float64) - r))
        if k in noise:
            assert diff <= 1e-6 * top, k
            continue
        err = diff / float(np.linalg.norm(r))
        assert err <= (fusion_bound if k.startswith("fusion.") else bound), \
            (k, err)
        checked += 1
    assert checked > (500 if frozen_stereo else 700)


@pytest.mark.parametrize("frozen_stereo", [True, False],
                         ids=["stereo_frozen", "nothing_frozen"])
def test_joint_step_free_running(joint_ref, frozen_stereo):
    """The port's own RAFT-3D and splats.  codd_tpu composites equal
    z-keys in arbitrary order (ROADMAP Queue 3, "Splat tie order"), which
    moves the warped memory on a share of pixels, so every gradient is
    held to the tie order's 5e-2 of its norm and the loss to 1e-3, as the
    fusion stage is in tests/test_torch_train.py (measured: the fusion
    net's 2.3e-2, RAFT-3D's 4.3e-3, the stereo's 4.2e-3, the loss 2.4e-6).  Stereo frozen: no stereo
    gradient, and the loss is codd_tpu's less its stereo terms."""
    loss, logs, grads = _port_run(joint_ref, frozen_stereo, False)
    _check(joint_ref, loss, logs, grads, frozen_stereo, 1e-3, 5e-2, 5e-2)


@pytest.mark.parametrize("frozen_stereo", [True, False],
                         ids=["stereo_frozen", "nothing_frozen"])
def test_joint_step_teacher_forced(joint_ref, frozen_stereo):
    """The warped memory takes codd_tpu's values, and its gradients still
    flow back through the port's splats: the loss to 1e-5 (measured
    1.3e-7) and the fusion net's gradients to 1e-4 of their norms
    (measured 1.8e-6, tighter than the teacher-forced fusion stage's 1e-3
    in tests/test_torch_train.py); RAFT-3D's and the stereo's to 1e-2 (measured 4.3e-3
    and 1.7e-3: f32 sums in other orders through two GN solves, and
    codd_tpu's bf16 scatter of the correlation levels' cotangents into
    fnet, as in the motion stage, tests/test_torch_train_motion.py).  The
    splats' tie order moves none of these beyond that here."""
    loss, logs, grads = _port_run(joint_ref, frozen_stereo, True)
    _check(joint_ref, loss, logs, grads, frozen_stereo, 1e-5, 1e-4, 1e-2)
