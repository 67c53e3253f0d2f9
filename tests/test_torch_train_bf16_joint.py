"""bf16 training on the CPU, the joint model: ``configs/models/codd.py``
with nothing frozen and 2 GN iterations under ``runtime.bf16_compute``,
codd_torch against codd_tpu on the same numpy weights and inputs.

* the dtype of every output of the training forward and of every
  gradient against ``jax.eval_shape`` of codd_tpu's bf16 loss (no
  compile: the trace is the reference), and the dtypes that reach the
  patch lookup (f32 coordinates, bf16 levels and f1, in both);
* the step: f32 masters, f32 Adam moments, a finite loss;
* RAFT-3D's checkpointed GN iterations rebuild the same bf16 bits in the
  backward's recompute;
* the motion module in train mode (RAFT-3D with the per-iteration
  supervision flows, the differentiated splats) on the same bf16 inputs
  and weights, and the supervision's induced-flow path on the same bf16
  SE(3) field and mask against codd_tpu run op by op (``jax.jit`` lets
  XLA skip a bf16 rounding inside a fusion where an f32 op consumes it,
  ``xla_allow_excess_precision``; the port rounds every bf16 op, as JAX
  without jit does), each with the tolerance stated at the check;
* the VJPs in bf16 of one GN iteration (the update block with
  ``grad_clip`` on its heads, the patch lookup, the GN solve, the
  supervision flows) and of the fusion module, on the same bf16 inputs,
  with the weights cast from the f32 masters as the step casts them,
  against codd_tpu's compiled without excess precision: every parameter
  and input gradient, each to the bound stated at the check.

At random weights bf16 is chaotic end to end (``tests/test_torch_bf16.py``),
so the step's values and gradients are held stage by stage, not as a
whole (the stereo stage's step: ``tests/test_torch_train_bf16.py``).
"""

import numpy as np
import pytest

import flax.linen
import jax
import jax.numpy as jnp
import torch
import torch.utils.checkpoint

from codd_tpu.losses import assembly as jassembly
from codd_tpu.models.builder import build_estimator as jbuild
from codd_tpu.models.builder import build_loss_config as jbuild_loss
from codd_tpu.models.fusion.fusion import Fusion as JFusion
from codd_tpu.models.motion import raft3d as jraft
from codd_tpu.ops import corr as jcorr
from codd_tpu.ops import projective as jproj
from codd_tpu.ops import se3 as jse3
from codd_tpu.ops import upsample as jup
from codd_tpu.ops import warp as jwarp
from codd_tpu.utils.precision import cast_floats as jcast_floats
from codd_torch.config import load_config
from codd_torch.losses import assembly
from codd_torch.models.builder import build_estimator, build_loss_config
from codd_torch.models.fusion import fusion as tfusion
from codd_torch.models.motion import raft3d as traft
from codd_torch.ops import corr as tcorr
from codd_torch.ops import gn as tgn
from codd_torch.ops import projective as tproj
from codd_torch.ops import upsample as tup
from codd_torch.ops import warp as twarp
from codd_torch.train import optim, trainer
from codd_torch.utils.params import torch_state_dict_from_jax
from codd_torch.utils.precision import cast_floats, rdiv

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

BF = torch.bfloat16
JBF = jnp.bfloat16
B, T, H, W = 1, 2, 64, 128
MAXD = 32
ITERS = 2
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def np32(a):
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


def _cfg(*options):
    opts = [f"model.stereo.initialization.max_disp={MAXD}",
            f"model.stereo.loss.max_disp={MAXD}",
            f"model.motion.iters={ITERS}"] + list(options)
    return dict(load_config(str(ROOT / "configs" / "models" / "codd.py"),
                            opts)["model"])


def _numpy_params(shapes, seed=3):
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


def _lookup_spy(module, seen):
    """Wrap ``module.corr_ops.corr_lookup`` to record the dtypes it is
    given: (coordinates, levels, f1) where the pyramid holds them."""
    real = module.corr_ops.corr_lookup

    def spy(pyramid, coords, *a, **k):
        levels = pyramid.get("levels") if isinstance(pyramid, dict) else None
        f1 = pyramid.get("f1") if isinstance(pyramid, dict) else None
        seen.append((str(coords.dtype).replace("torch.", ""),
                     None if levels is None else
                     tuple(sorted({str(x.dtype).replace("torch.", "")
                                   for x in levels})),
                     None if f1 is None else
                     str(f1.dtype).replace("torch.", "")))
        return real(pyramid, coords, *a, **k)
    return spy


@pytest.fixture(scope="module")
def ref():
    """codd_tpu's bf16 loss traced by ``jax.eval_shape`` with its gradient:
    the dtypes of every output and gradient, and those reaching the patch
    lookup."""
    cfg, batch = _cfg(), _batch()
    jm, lc = jbuild(cfg), jbuild_loss(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes)

    def loss(v):
        # codd_tpu/train/trainer.py's micro_loss under bf16_compute
        outs = jm.apply(jcast_floats(v, JBF), batch["l_img"].astype(JBF),
                        batch["r_img"].astype(JBF), batch["intrinsics"],
                        train=True)
        o32 = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32) if x.dtype == JBF else x, outs)
        total, logs = jassembly.codd_train_loss(lc, o32, batch)
        return total, (logs, outs)

    seen, fusion_ins = [], []

    def fusion_spy(next_fun, args, kwargs, context):
        if isinstance(context.module, JFusion) and \
                context.method_name == "__call__":
            fusion_ins.append([(tuple(a.shape), str(a.dtype)) for a in args])
        return next_fun(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp, \
            flax.linen.intercept_methods(fusion_spy):
        mp.setattr(jraft.corr_ops, "corr_lookup", _lookup_spy(jraft, seen))
        (_, (logs, outs)), grads = jax.eval_shape(
            jax.value_and_grad(loss, has_aux=True), variables)
    dtype = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: str(x.dtype), t)
    return dict(cfg=cfg, batch=batch, variables=variables, lookups=seen,
                fusion_ins=fusion_ins,
                outs=dtype(outs), logs=sorted(logs),
                grads=[str(x.dtype) for x in jax.tree_util.tree_leaves(
                    grads)])


def _port(ref):
    model = build_estimator(ref["cfg"], device="cpu", seed=None)
    model.load_state_dict(torch_state_dict_from_jax(ref["variables"]),
                          strict=True)
    return model


def _port_batch(ref):
    return {k: _t(v) for k, v in ref["batch"].items()}


def test_joint_dtypes_match_codd_tpu(ref):
    """Every output leaf of the training forward has codd_tpu's dtype (the
    stereo pyramids bf16, the supervision flows and the fused disparity
    f32, ...); every gradient is f32 in both, as the masters; the loss's
    logs are codd_tpu's; the patch lookup takes f32 coordinates and bf16
    levels and f1 in both; the fusion's inputs have codd_tpu's shapes and
    dtypes."""
    model = _port(ref)
    seen = []
    tb = _port_batch(ref)
    fusion_ins = []
    real_fusion = model.fusion.forward

    def fusion_spy(*args):
        fusion_ins.append([(tuple(a.shape), str(a.dtype).replace(
            "torch.", "")) for a in args])
        return real_fusion(*args)
    model.fusion.forward = fusion_spy
    with pytest.MonkeyPatch.context() as mp, \
            trainer.training_forward(model, bf16_compute=True) as forward:
        mp.setattr(traft.corr_ops, "corr_lookup", _lookup_spy(traft, seen))
        o32, outs = forward(tb)
        loss, logs = assembly.codd_train_loss(build_loss_config(ref["cfg"]),
                                              o32, tb)
        loss.backward()
    dtype = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: str(x.dtype).replace("torch.", ""), t)
    got = jax.tree_util.tree_leaves_with_path(dtype(outs))
    want = jax.tree_util.tree_leaves_with_path(ref["outs"])
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert [d for _, d in got] == [d for _, d in want]
    assert {d for _, d in got} == {"bfloat16", "float32"}
    assert sorted(logs) == ref["logs"] and torch.isfinite(loss)
    assert set(ref["grads"]) == {"float32"}
    assert len(ref["grads"]) == len(list(model.parameters())) + len(
        list(model.buffers()))
    for k, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
    # the port's backward recomputes each checkpointed iteration
    assert len(ref["lookups"]) == ITERS and len(seen) == 2 * ITERS
    assert set(seen) == set(ref["lookups"]) == {
        ("float32", ("bfloat16",), "bfloat16")}
    # the fusion's eight inputs, frame 1: the stereo's disparity, features
    # and the projected memory bf16; the warped disparity, flow and
    # confidence f32 (the splat's)
    assert fusion_ins == ref["fusion_ins"] and len(fusion_ins) == T - 1


def test_joint_step_keeps_f32_masters(ref):
    """Two steps of ``make_train_step(bf16_compute=True)`` with Adam: the
    masters and both moments f32 and finite, the buffers untouched."""
    model = _port(ref)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    opt = optim.make_optimizer(lambda step: 4e-4, 1.0)
    step = trainer.make_train_step(model, opt, build_loss_config(ref["cfg"]),
                                   bf16_compute=True)
    state = trainer.create_train_state(model, opt)
    batch = {k: _t(v) for k, v in ref["batch"].items()}
    for _ in range(2):
        state, logs = step(state, batch)
        assert np.isfinite(logs["loss"].item())
        assert logs["step_skipped"].item() == 0
    for tree in (state.params, state.opt_state.mu, state.opt_state.nu):
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
                   for v in tree.values())
    for k, v in model.named_buffers():
        assert v.dtype == torch.float32 and torch.equal(v, buffers[k]), k


def test_checkpoint_recompute_rebuilds_the_bf16_bits(ref):
    """RAFT-3D checkpoints each GN iteration in training; the backward's
    recompute must rebuild the forward's bf16 values: each recomputed
    iteration's outputs equal, in bits, those of the forward call it
    recomputes (2 frames' worth of 2 iterations, recomputed in reverse)."""
    model = _port(ref)
    calls = []
    real = traft.GNIteration.forward

    def keep(self, *args, **kw):
        out = real(self, *args, **kw)
        calls.append([o.detach().clone() for o in out])
        return out
    # each iteration recomputed whole (not only up to the last tensor the
    # backward needs), so that it returns its outputs
    tb = _port_batch(ref)
    with pytest.MonkeyPatch.context() as mp, \
            trainer.training_forward(model, bf16_compute=True) as forward, \
            torch.utils.checkpoint.set_checkpoint_early_stop(False):
        mp.setattr(traft.GNIteration, "forward", keep)
        o32, _ = forward(tb)
        n = len(calls)
        loss, _ = assembly.codd_train_loss(build_loss_config(ref["cfg"]),
                                           o32, tb)
        loss.backward()
    forward, again = calls[:n], calls[n:]
    assert n == ITERS and len(again) == n
    assert all(c[0].dtype == BF for c in calls)
    for a in again:
        assert any(all(torch.equal(x, y) for x, y in zip(a, f))
                   for f in forward)


def test_motion_module_train_mode_bf16():
    """The motion module in train mode (RAFT-3D's two GN iterations with
    their supervision flows, then the splats of the warped memory) in bf16
    on the same bf16 inputs and weights.  The SE(3) field agrees to 1e-2 of
    its largest value (measured 1.7e-3), RAFT-3D's confidence and the next
    frame's features to 3e-2 (7e-3, 1.0e-2), the reverse supervision flows
    to 5e-2 (2.3e-2); the induced flows difference two projections of
    points moved by that field, which amplifies its bf16 ulps: to 0.1 of
    their norm (5.6e-2); the splatted memory follows each point's landing
    pixel: to 0.25 of its norm (0.11).  The induced flow's own arithmetic
    is held on one field in test_induced_flow_path_bf16."""
    cfg = _cfg()
    batch = _batch()
    jm = jbuild(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    v = _numpy_params(shapes)
    rng = np.random.RandomState(7)
    ins = [rng.rand(B, H, W, 3), rng.uniform(2, 20, (B, H, W)),
           rng.rand(B, H, W, 3), rng.randn(B, H // 4, W // 4, 16),
           rng.uniform(2, 20, (B, H, W)), rng.randn(B, H // 8, W // 8, 128),
           rng.randn(B, H // 8, W // 8, 512)]
    jins = [jnp.asarray(a, jnp.float32).astype(JBF) for a in ins]
    intr = batch["intrinsics"]
    jo = jax.jit(lambda p, *a: jm.apply(
        jcast_floats(p, JBF), *a, intr, True,
        method=lambda m, *x: m.motion(*x)))(v, *jins)
    model = build_estimator(cfg, device="cpu", seed=None)
    model.load_state_dict(torch_state_dict_from_jax(v), strict=True)
    cast_floats(model)
    to = model.motion(*(tbf(np32(a)) for a in jins), torch.from_numpy(intr),
                      train_mode=True, warp_grad=True)
    (jmem, jraw, jfmap, jnet), (tmem, traw, tfmap, tnet) = jo, to
    assert str(jraw["Ts"].dtype) == "bfloat16" and traw["Ts"].dtype == BF
    assert rel(np32(traw["Ts"]), np32(jraw["Ts"])) <= 1e-2
    assert rel(np32(traw["weight"]), np32(jraw["weight"])) <= 3e-2
    assert rel(np32(tfmap), np32(jfmap)) <= 3e-2
    assert rel(np32(tnet), np32(jnet)) <= 3e-2
    for a, b in zip(traw["flow2d_rev"], jraw["flow2d_rev"]):
        assert a.dtype == torch.float32 and rel(np32(a), np32(b)) <= 5e-2
    for a, b in zip(traw["flow2d_est"] + [traw["flow2d_est_induced"]],
                    jraw["flow2d_est"] + [jraw["flow2d_est_induced"]]):
        assert a.dtype == torch.float32
        assert rel_norm(np32(a), np32(b)) <= 0.1
    for a, b in zip(tmem, jmem):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        if np.any(np32(b)):
            assert rel_norm(np32(a), np32(b)) <= 0.25


def test_induced_flow_path_bf16():
    """The supervision's est path on one bf16 SE(3) field (B, 8, 16), bf16
    mask logits and f32 depth: ``upsample_se3`` (the mask's softmax as
    ``jax.nn.softmax`` rounds it) then ``induced_flow``, and the rev
    path's ``cvx_upsample`` of f32 flows by a bf16 mask (in f32, as
    ``jnp.einsum`` promotes), against codd_tpu op by op: the same dtypes;
    the upsampled field within one bf16 ulp, off codd_tpu's bits on at
    most 1e-3 of its elements (measured 3 of 57,344: the 9-term bf16
    einsum's sum order); the induced flow of codd_tpu's upsampled field
    in bits; the rev flows to 1e-6 of their largest value (the f32
    einsum's order)."""
    from codd_tpu.ops import se3 as jse3
    rng = np.random.RandomState(9)
    h8, w8 = H // 8, W // 8
    tw = np.concatenate([rng.randn(B, h8, w8, 3) * 0.2,
                         rng.randn(B, h8, w8, 3) * 0.02], -1)
    depth = rng.uniform(2.0, 30.0, (B, H, W)).astype(np.float32)
    flow8 = rng.randn(B, h8, w8, 2).astype(np.float32)
    intr = np.array([[100.0, 100.0, W / 2, H / 2]], np.float32)
    with jax.disable_jit():
        Ts = jse3.exp(jnp.asarray(tw, jnp.float32).astype(JBF))
        mask = jnp.asarray(rng.randn(B, h8, w8, 64 * 9),
                           jnp.float32).astype(JBF)
        jup_ = jup.upsample_se3(Ts, mask)
        jflow = jproj.induced_flow(jup_, depth, intr)[0]
        jrev = jup.cvx_upsample(jnp.asarray(flow8), mask)
    tup_ = tup.upsample_se3(tbf(np32(Ts)), tbf(np32(mask)))
    tflow = tproj.induced_flow(tbf(np32(jup_)), _t(depth), _t(intr))[0]
    trev = tup.cvx_upsample(_t(flow8), tbf(np32(mask)))
    assert str(tup_.dtype).replace("torch.", "") == str(jup_.dtype)
    assert str(tflow.dtype).replace("torch.", "") == str(jflow.dtype)
    assert trev.dtype == torch.float32 and str(jrev.dtype) == "float32"
    diff = np.abs(np32(tup_) - np32(jup_))
    assert (diff <= 2.0 ** -7 * np.abs(np32(jup_))).all()
    assert (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(np32(tflow), np32(jflow))
    assert rel(np32(trev), np32(jrev)) <= 1e-6


# the cotangents of a stage's outputs in the VJP tests: seeded normals
# times COT_SCALE / the output's size.  The losses are means, so the loss's
# own cotangents are ~1 / size; a hundred times that makes grad_clip
# (cotangents with |g| > 0.01 zeroed) zero a share of the heads'
# cotangents, so that its placement and threshold are held too
COT_SCALE = 100.0


def _cotangents(leaves, seed):
    rng = np.random.RandomState(seed)
    return [jnp.asarray((rng.randn(*s.shape) * COT_SCALE / np.prod(s.shape)
                         ).astype(np.float32)).astype(s.dtype)
            for s in leaves]


def _jax_vjp(f, args, seed):
    """f's outputs at ``args`` and its VJP for ``_cotangents``, compiled
    with XLA's excess precision off: ``jax.jit`` otherwise keeps a bf16
    value in f32 inside a fusion, where the port (and JAX op by op) rounds
    every bf16 op.  Returns (outputs, input gradients, cotangents)."""
    leaves, tdef = jax.tree_util.tree_flatten(jax.eval_shape(f, *args))
    cots = _cotangents(leaves, seed)

    def run(*a):
        outs, vjp = jax.vjp(f, *a)
        return outs, vjp(jax.tree_util.tree_unflatten(tdef, cots))
    outs, grads = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    return outs, grads, cots


def _clip_spy(seen):
    """``grad_clip`` that records, for each call, the share of its
    cotangent's elements it zeroes (|g| > 0.01 in the cotangent's dtype)."""
    real = tgn.grad_clip

    def spy(x, clip=0.01):
        y = real(x, clip)
        y.register_hook(lambda g: seen.append(float((g.abs() > clip).float()
                                                    .mean())))
        return y
    return spy


def _params_close(named, jgrads, bound):
    """Each parameter's gradient (f32) within ``bound`` of its norm of
    codd_tpu's (none where codd_tpu's is 0); one that vanishes by
    invariance (norm at most 1e-6 of the largest, as the ae head's bias in
    front of the GN's normalisation) within 1e-6 of the largest norm."""
    ref = {k: jgrads[k].numpy().astype(np.float64) for k, _ in named}
    top = max(np.linalg.norm(r) for r in ref.values())
    for k, p in named:
        if not np.any(ref[k]):  # out of the stage's reach
            assert p.grad is None or not p.grad.any(), k
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        d = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[k])
        n = np.linalg.norm(ref[k])
        if n <= 1e-6 * top:
            assert d <= 1e-6 * top, k
            continue
        assert d <= bound * n, (k, d / n)


def test_gn_iteration_vjp_bf16(ref):
    """One of RAFT-3D's GN iterations in training (the scan body: the
    patch lookup over a pyramid built from the two fmaps, the update block
    with ``grad_clip`` on its four heads, the GN solve, the iteration's
    supervision flows), its VJP in bf16 on the same bf16 inputs, the
    weights cast from the f32 masters as the step casts them
    (``trainer.compute_copies``), against codd_tpu's.  grad_clip zeroes a
    share of the delta, weight and mask heads' cotangents (COT_SCALE).
    The bf16 outputs to 5e-3 of their norm (measured 7.0e-4), the f32
    supervision flows to 2e-2 (3.8e-3); each update-block gradient to 0.1
    of its norm (measured 3.5e-2, the first correlation encoder's: bf16
    roundings of 196-channel convolutions in another order); the
    gradients of net and inp to 5e-2 (2.0e-2), of the two fmaps through
    the pyramid to 0.1 (3.4e-2)."""
    h8, w8 = H // 8, W // 8
    rng = np.random.RandomState(13)
    ins = [np.tanh(rng.randn(B, h8, w8, 128)),
           np.maximum(rng.randn(B, h8, w8, 384), 0),
           rng.randn(B, h8, w8, 128), rng.randn(B, h8, w8, 128)]
    jins = [jnp.asarray(a, jnp.float32).astype(JBF) for a in ins]
    twist = np.concatenate([rng.randn(B, h8, w8, 3) * 0.02,
                            rng.randn(B, h8, w8, 3) * 0.05], -1)
    Ts = jax.jit(jse3.exp)(jnp.asarray(twist, jnp.float32).astype(JBF))
    depth = [jnp.asarray(rng.uniform(2, 20, (B, H, W)), jnp.float32)
             .astype(JBF) for _ in range(2)]
    intr = ref["batch"]["intrinsics"]
    x0, y0 = jwarp.meshgrid_xy(h8, w8, JBF)
    coords0 = jnp.broadcast_to(jnp.stack([x0, y0], -1)[None],
                               (B, h8, w8, 2))
    jit_ = jraft.GNIteration(emit_supervision=True)

    def f(p, net, inp, f1, f2):
        carry = (net, Ts, jnp.zeros((B, h8, w8, 576), JBF),
                 jnp.zeros((B, h8, w8, 3), JBF), inp,
                 jcorr.build_corr_pyramid(f1, f2, 4, impl="patch"),
                 depth[0][:, 3::8, 3::8],
                 1.0 / jnp.maximum(depth[1][:, 3::8, 3::8], 1e-8),
                 intr / 8.0, coords0, depth[0], intr)
        out, ys = jit_.apply({"params": jcast_floats(p, JBF)}, carry, None)
        return out[:4], ys

    params = ref["variables"]["params"]["motion"]["raft3d"]["gn_iter"]
    jo, jg, cots = _jax_vjp(f, (params, *jins), 17)
    jgrads = torch_state_dict_from_jax(jax.tree_util.tree_map(
        np32, {"update_block": jg[0]["update_block"]}))

    it = _port(ref).motion.raft3d.gn_iter
    tins = [tbf(np32(a)).requires_grad_() for a in jins]
    tdepth = [tbf(np32(d)) for d in depth]
    tintr = _t(intr)
    tx0, ty0 = twarp.meshgrid_xy(h8, w8, BF)
    clipped = []
    with pytest.MonkeyPatch.context() as mp, trainer.compute_copies(it, BF):
        mp.setattr(traft, "grad_clip", _clip_spy(clipped))
        outs = it(tins[0], tbf(np32(Ts)), tins[1],
                  tcorr.build_corr_pyramid(tins[2], tins[3], impl="patch"),
                  tdepth[0][:, 3::8, 3::8],
                  rdiv(1.0, tdepth[1][:, 3::8, 3::8].clamp(min=1e-8)),
                  tintr / 8.0,
                  torch.stack([tx0, ty0], -1)[None].expand(B, h8, w8, 2),
                  tdepth[0], tintr)
        torch.autograd.backward(list(outs), [
            torch.tensor(np32(c)).to(o.dtype) for o, c in zip(outs, cots)])
    for o, j in zip(outs, jax.tree_util.tree_leaves(jo)):
        assert str(o.dtype).replace("torch.", "") == str(j.dtype)
        assert rel_norm(np32(o), np32(j)) <= (
            5e-3 if o.dtype == BF else 2e-2)
    # the heads in the backward's order: mask, weight, delta, ae (whose
    # cotangents stay below the threshold)
    assert len(clipped) == 4 and clipped[3] == 0, clipped
    assert all(0 < c < 1 for c in clipped[:3]), clipped
    _params_close(list(it.named_parameters()), jgrads, 0.1)
    for t, g, bound in zip(tins, jg[1:], (5e-2, 5e-2, 0.1, 0.1)):
        assert t.grad.dtype == BF
        assert rel_norm(np32(t.grad), np32(g)) <= bound


def test_fusion_vjp_bf16(ref):
    """The fusion module (the training step's last stage: the photometric
    costs of both disparities, the correlations of the features and of
    the disparities, the weight and reset heads with ``grad_clip``), its
    VJP in bf16 on inputs of the shapes and dtypes codd_tpu's bf16 step
    gives it (``ref``'s trace), the weights cast from the f32 masters,
    against codd_tpu's.  The warped disparity has the splat's holes,
    exact zeros: where two neighbours are holes, |0 - 0|'s cotangent is
    +g in codd_tpu (``jnp.abs``), as ``utils.precision.absolute`` gives
    it (``torch.abs`` gives 0: 0.16 of the warped disparity's gradient).
    The outputs to 2e-3 of their norm (measured 9.1e-4); each fusion
    gradient to 6e-2 of its norm (measured 2.5e-2, the correlation
    convolutions' biases); each input's to 3e-2 (1.0e-2)."""
    sig = ref["fusion_ins"][0]
    rng = np.random.RandomState(5)
    ins = [rng.uniform(1.0, 25.0, sig[0][0]),
           rng.uniform(1.0, 25.0, sig[1][0]) * (rng.rand(*sig[1][0]) > 0.2),
           rng.randn(*sig[2][0]), rng.randn(*sig[3][0]),
           rng.randn(*sig[4][0]), rng.rand(*sig[5][0]),
           rng.randn(*sig[6][0]), rng.randn(*sig[7][0])]
    jins = [jnp.asarray(a, jnp.float32).astype(dt)
            for a, (_, dt) in zip(ins, sig)]
    jm = jbuild(ref["cfg"])
    f = lambda p, *a: jm.apply(  # noqa: E731
        jcast_floats(p, JBF), *a, method=lambda m, *x: m.fusion(*x))
    jo, jg, cots = _jax_vjp(f, (ref["variables"], *jins), 19)
    jgrads = torch_state_dict_from_jax(jax.tree_util.tree_map(np32, jg[0]))

    model = _port(ref)
    tins = [torch.tensor(np32(a)).to(getattr(torch, dt))
            .requires_grad_() for a, (_, dt) in zip(jins, sig)]
    clipped = []
    with pytest.MonkeyPatch.context() as mp, \
            trainer.compute_copies(model, BF):
        mp.setattr(tfusion, "grad_clip", _clip_spy(clipped))
        outs = model.fusion(*tins)
        torch.autograd.backward(list(outs), [
            torch.tensor(np32(c)) for c in cots])
    for o, j in zip(outs, jo):
        assert o.dtype == torch.float32 and str(j.dtype) == "float32"
        assert rel_norm(np32(o), np32(j)) <= 2e-3
    assert len(clipped) == 2 and all(0 < c < 1 for c in clipped), clipped
    _params_close([(k, p) for k, p in model.named_parameters()
                   if k.startswith("fusion.")], jgrads, 6e-2)
    for t, g in zip(tins, jg[1:]):
        assert t.grad.dtype == t.dtype
        assert rel_norm(np32(t.grad), np32(g)) <= 3e-2
