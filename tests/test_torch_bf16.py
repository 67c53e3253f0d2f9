"""bf16 inference: codd_torch against codd_tpu on the same bf16 inputs.

``bench.py --bf16`` casts codd_tpu's parameters and frames to bf16 (the
intrinsics stay f32) and lets compute follow the dtypes, with f32 pinned
in the SE(3) math, the GN system and solve, the splat and the correlation
products.  The port reproduces that module by module:

* the dtype of every output and carry leaf of ``first_step`` and of two
  ``step`` calls (``memory_disp`` turns f32 after the first ``step``);
* kernel 1's two bf16 forms against ``tile_warping`` under ``jax.jit``
  (the "exact" form, bit for bit) and the Pallas kernel's body in
  interpret mode (the "pallas" form, within 1 bf16 ulp), on a strip of
  H=8, W=1280, C=16, where the bf16 x grid rounds above 512 and 1024;
* the other bf16 points: the plane offsets, the init cost and its argmin
  above 256, the SE(3) island, the correlation pyramid, the GN boundary,
  the splat's output dtype;
* the cascade stage by stage at the first ``step`` of a 64x128 stream
  (max_disp 64, 2 GN iterations): each stage is fed codd_tpu's own bf16
  inputs of that stage.  At random weights bf16 is chaotic end to end
  (an argmin or an argmax that flips moves a disparity by pixels), so the
  whole cascade is not compared; each stage's tolerance is stated where
  it is checked.

Weights are numpy draws over codd_tpu's parameter shapes (no
``model.init`` compile), carried over by ``torch_state_dict_from_jax``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.models.codd import CODD as JCODD
from codd_tpu.models.stereo.hitnet import calc_init_cost as jcalc_init_cost
from codd_tpu.models.stereo.hitnet import tile_warping
from codd_tpu.ops import corr as jcorr
from codd_tpu.ops import se3 as jse3
from codd_tpu.ops.gn import gn_step as jgn_step
from codd_tpu.ops.pallas.tile_warp import tile_warp_cost as pallas_tile_warp
from codd_tpu.ops.splat import splat_render as jsplat_render
from codd_tpu.ops.upsample import to_plane as jto_plane
from codd_torch.models.codd import CODD as TCODD
from codd_torch.models.motion.motion import disp_to_depth
from codd_torch.models.stereo.hitnet import calc_init_cost
from codd_torch.ops import corr as tcorr
from codd_torch.ops import se3, splat
from codd_torch.ops.gn import gn_step
from codd_torch.ops.projective import inv_project
from codd_torch.ops.tile_warp import tile_warp_cost, tile_warp_cost_plain
from codd_torch.ops.upsample import plane_offsets, to_plane
from codd_torch.utils.params import torch_state_dict_from_jax
from codd_torch.utils.precision import cast_floats, rdiv, round_floats

BF = torch.bfloat16
JBF = jnp.bfloat16
B, H, W = 1, 64, 128
CARRY = ("memory_img", "memory_feat", "memory_disp", "fmap", "netinp",
         "kalman_p")
EPS = np.finfo(np.float32).eps


def np32(a):
    """A jax or torch array as f32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def tt(a, dtype=BF):
    return torch.from_numpy(np32(a).copy()).to(dtype)


def jt(a, dtype=JBF):
    return jnp.asarray(np32(a)).astype(dtype)


def ulps(got, ref):
    """|got - ref| in bf16 ulps of ref (ulp = 2^(exponent - 7))."""
    got, ref = np32(got), np32(ref)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    return np.abs(got - ref) / ulp


def rel_max(got, ref):
    got, ref = np32(got), np32(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)


# ---------------------------------------------------------------------------
# the shared codd_tpu run
# ---------------------------------------------------------------------------

_STAGES = {("stereo/backbone", "__call__"), ("stereo/tile_init", "__call__"),
           ("stereo/tile_update", "__call__"), ("motion", "__call__"),
           ("motion/raft3d", "__call__"), ("fusion", "__call__"),
           ("fusion", "project")}


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


@pytest.fixture(scope="module")
def ref():
    """codd_tpu in bf16: first_step + one step with the stages' outputs
    captured; the dtypes of first_step + two steps from ``eval_shape``."""
    rng = np.random.RandomState(0)
    left = rng.rand(B, 3, H, W, 3).astype(np.float32)
    right = rng.rand(B, 3, H, W, 3).astype(np.float32)
    intr = np.array([[100.0, 100.0, W / 2, H / 2]], np.float32)
    jm = JCODD(max_disp=64, iters=2)
    shapes = jax.eval_shape(lambda k: jm.init(k, left[:, :2], right[:, :2],
                                              intr), jax.random.PRNGKey(0))
    v32 = _numpy_params(shapes)
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(JBF), v32)
    L = [jt(left[:, t]) for t in range(3)]
    R = [jt(right[:, t]) for t in range(3)]

    def capture(mdl, name):
        return ("/".join(mdl.scope.path), name) in _STAGES

    first = jax.jit(lambda v, l, r, i: jm.apply(
        v, l, r, i, method=JCODD.first_step))
    step = jax.jit(lambda v, c, l, r, i: jm.apply(
        v, c, l, r, i, method=JCODD.step, capture_intermediates=capture,
        mutable=["intermediates"]))
    carry0, out0 = first(vb, L[0], R[0], intr)
    (carry1, out1), inter = step(vb, carry0, L[1], R[1], intr)
    # dtypes of every leaf at frames 0, 1, 2 (frame 2 starts from an f32
    # memory_disp, so it is its own trace)
    shape_step = lambda c, l: jax.eval_shape(
        lambda v, c, l, r, i: jm.apply(v, c, l, r, i, method=JCODD.step),
        vb, c, l, l, intr)
    c1s, o1s = shape_step(carry0, L[1])
    c2s, o2s = shape_step(c1s, L[2])

    def dtypes(c, o):
        return ({k: str(getattr(c, k).dtype) for k in CARRY},
                {k: str(v.dtype) for k, v in o.items()})

    tree = lambda t: jax.tree_util.tree_map(
        lambda a: None if a is None else np32(a), t,
        is_leaf=lambda a: a is None)
    return dict(
        left=left, right=right, intr=intr, v32=v32,
        carry0={k: np32(getattr(carry0, k)) for k in CARRY},
        dtypes=[dtypes(carry0, out0), dtypes(c1s, o1s), dtypes(c2s, o2s)],
        out1=tree(out1), st=tree(inter["intermediates"]))


@pytest.fixture(scope="module")
def port(ref):
    tm = TCODD(max_disp=64, iters=2).eval()
    tm.load_state_dict(torch_state_dict_from_jax(ref["v32"]), strict=True)
    return cast_floats(tm)


def _port_dtypes(c, o):
    return ({k: str(getattr(c, k).dtype).replace("torch.", "")
             for k in CARRY},
            {k: str(v.dtype).replace("torch.", "") for k, v in o.items()})


def test_dtype_of_every_leaf_at_frames_0_1_2(ref, port):
    """The port's own bf16 stream: every carry and output leaf has
    codd_tpu's dtype at every frame (memory_disp bf16 after first_step,
    f32 after each step; pred_disp, pred_warp, flow2d_est_induced and the
    fusion weights f32, the rest bf16)."""
    intr = torch.from_numpy(ref["intr"])
    fr = lambda side, t: tt(ref[side][:, t])
    c, o = port.first_step(fr("left", 0), fr("right", 0), intr)
    got = [_port_dtypes(c, o)]
    for t in (1, 2):
        c, o = port.step(c, fr("left", t), fr("right", t), intr)
        got.append(_port_dtypes(c, o))
        assert all(torch.isfinite(v.float()).all() for v in o.values())
    for frame, (g, r) in enumerate(zip(got, ref["dtypes"])):
        assert g == r, (frame, g, r)
    assert got[0][0]["memory_disp"] == "bfloat16"
    assert got[1][0]["memory_disp"] == got[2][0]["memory_disp"] == "float32"


# ---------------------------------------------------------------------------
# the cascade stage by stage, frame 1, each stage on codd_tpu's own inputs
# ---------------------------------------------------------------------------

def _feats(ref):
    fea = [tt(a) for a in ref["st"]["stereo"]["backbone"]["__call__"][0]]
    return [f[:B].contiguous() for f in fea], [f[B:].contiguous() for f in fea]


def test_stage_stereo_backbone(ref, port):
    """HITUNet on the bf16 frame pair: each level within 2e-2 of its max
    (bf16 rounds each conv's output; the two sides round the bias add and
    sum in different orders)."""
    with torch.no_grad():
        fea = port.stereo.backbone(torch.cat([tt(ref["left"][:, 1]),
                                              tt(ref["right"][:, 1])], 0))
    for got, want in zip(fea, ref["st"]["stereo"]["backbone"]["__call__"][0]):
        assert got.dtype == BF and rel_max(got, want) < 2e-2


def test_stage_tile_init(ref, port):
    """Init costs within 1e-2 of their max; the argmin disparity, rounded
    to bf16, equal on >= 99 % of the tiles of each level (a bf16 cost
    ties where the last bit decides); where it is equal, the hypothesis
    within 2e-2 of its max."""
    fl, fr = _feats(ref)
    with torch.no_grad():
        costs, hyps = port.stereo.tile_init(fl, fr)
    rc, rh = ref["st"]["stereo"]["tile_init"]["__call__"][0]
    for lvl in range(5):
        assert costs[lvl].dtype == hyps[lvl].dtype == BF
        assert rel_max(costs[lvl], rc[lvl]) < 1e-2
        same = np32(hyps[lvl][..., 0]) == rh[lvl][..., 0]
        assert same.mean() >= 0.99, (lvl, same.mean())
        d = np.abs(np32(hyps[lvl]) - rh[lvl])[same]
        assert d.max() <= 2e-2 * np.abs(rh[lvl]).max(), lvl


def test_stage_tile_propagation(ref, port):
    """Propagation from codd_tpu's features and init hypotheses (kernel
    1's exact form inside): the disparity within 1e-2 of its max on
    >= 99 % of the pixels (an argmax over the two hypotheses' confidences
    may flip in bf16)."""
    fl, fr = _feats(ref)
    rh = ref["st"]["stereo"]["tile_init"]["__call__"][0][1]
    with torch.no_grad():
        disp = port.stereo.tile_update(fl, fr, [tt(h) for h in rh])
    want = ref["st"]["stereo"]["tile_update"]["__call__"][0][0]
    assert disp.dtype == BF
    off = np.abs(np32(disp) - want) > 1e-2 * np.abs(want).max()
    assert off.mean() <= 0.01, off.mean()


def _motion_inputs(ref):
    c0 = ref["carry0"]
    pred = tt(ref["st"]["stereo"]["tile_update"]["__call__"][0][0])
    return dict(img=tt(ref["left"][:, 1]), disp=pred[..., 0],
                mem_img=tt(c0["memory_img"]), mem_feat=tt(c0["memory_feat"]),
                mem_disp=tt(c0["memory_disp"]), fmap=tt(c0["fmap"]),
                netinp=tt(c0["netinp"]), intr=torch.from_numpy(ref["intr"]))


def test_stage_raft3d(ref, port):
    """RAFT-3D, 2 GN iterations, from codd_tpu's carry and depths: Ts
    within 2 bf16 ulps of 1 (2^-7); weight, fmap and netinp within 2e-2
    of their max; the induced flow (f32, from the upsampled Ts through the
    depth) within 1e-2 of its max on >= 90 % of the pixels (one ulp of a
    bf16 rotation moves a far point by a pixel)."""
    m = _motion_inputs(ref)
    with torch.no_grad():
        out, fmap, netinp = port.motion.raft3d(
            m["img"], disp_to_depth(m["mem_disp"]), disp_to_depth(m["disp"]),
            m["intr"], m["fmap"], m["netinp"])
    want, wfmap, wnetinp = ref["st"]["motion"]["raft3d"]["__call__"][0]
    assert (out["Ts"].dtype, out["weight"].dtype,
            out["flow2d_est_induced"].dtype) == (BF, BF, torch.float32)
    assert np.abs(np32(out["Ts"]) - want["Ts"]).max() <= 2 ** -7
    for got, w in ((out["weight"], want["weight"]), (fmap, wfmap),
                   (netinp, wnetinp)):
        assert got.dtype == BF and rel_max(got, w) < 2e-2
    f, wf = np32(out["flow2d_est_induced"]), want["flow2d_est_induced"]
    assert (np.abs(f - wf) > 1e-2 * np.abs(wf).max()).mean() <= 0.10


def _splat_reference_mask(points, feats, intr, h, w, radius):
    """Pixels where codd_tpu's splat is defined, and its cumsum error
    bound: where two of a pixel's first 8 fragments share the packed key
    that codd_tpu sorts unstably, their order is arbitrary ("tie"
    pixels); its sums are differences of a global f32 cumsum, within 8
    f32 eps of the running sums of |weighted payload|, |head z| and the
    count."""
    order, offsets, alpha, Z = splat.sort_fragments(points, intr, h, w,
                                                    radius)
    npix, N = h * w, Z.shape[0]
    z_bits = 32 - (npix + 1).bit_length()
    pid = torch.repeat_interleave(torch.arange(npix),
                                  offsets[1:] - offsets[:-1])
    zq = splat._quantize_z(Z, z_bits)[order[:int(offsets[-1])] % N]
    rank = torch.arange(len(pid)) - offsets[:-1][pid]
    same = (pid[1:] == pid[:-1]) & (zq[1:] == zq[:-1]) & (rank[:-1] < 8)
    tie = torch.zeros(npix, dtype=torch.bool)
    tie[pid[1:][same]] = True
    aout, azb, cnt = splat.composite_plain(order, offsets, alpha, Z.abs(),
                                           feats.abs())
    run = torch.cumsum(torch.cat([aout, azb[:, None], cnt[:, None]], 1)
                       .double(), 0) * 8 * EPS
    return (tie.reshape(h, w).numpy(), run[:, :-2].reshape(h, w, -1).numpy(),
            run[:, -2].reshape(h, w).numpy())


def test_stage_motion_splats(ref, port):
    """Motion's two splats on codd_tpu's RAFT-3D outputs (the port's
    RAFT-3D replaced by them).  The points are bf16 (``se3.act`` rounds to
    Ts's dtype), so many fragments of a pixel share a depth, and codd_tpu's
    unstable sort composites those in arbitrary order: tie pixels are
    excluded (their share reported).  Elsewhere the full-res flow and
    confidence warps are within codd_tpu's cumsum bound + 1e-4 rel, the
    disparity warp within that bound's image through 210/z, and the
    1/4-res bf16 feature warp within the bound + 1 bf16 ulp (2^-7 rel)."""
    m = _motion_inputs(ref)
    want_raft = ref["st"]["motion"]["raft3d"]["__call__"][0][0]
    forced = {k: tt(v, torch.float32 if k == "flow2d_est_induced" else BF)
              for k, v in want_raft.items()}
    hook = port.motion.raft3d.register_forward_hook(
        lambda mod, args, res: (forced, res[1], res[2]))
    try:
        with torch.no_grad():
            mem, _, _, _ = port.motion(
                m["img"], m["disp"], m["mem_img"], m["mem_feat"],
                m["mem_disp"], m["fmap"], m["netinp"], m["intr"])
    finally:
        hook.remove()
    assert [t.dtype for t in mem] == [BF, BF, torch.float32, torch.float32,
                                      torch.float32]
    want = [np.asarray(w)[0] for w in ref["st"]["motion"]["__call__"][0][0]]
    got = [np32(t)[0] for t in mem]
    intr = m["intr"][0]
    depth = disp_to_depth(m["mem_disp"])
    with torch.no_grad():
        pts = se3.act(forced["Ts"], inv_project(depth, m["intr"]))
        pts4 = se3.act(forced["Ts"][:, 1::4, 1::4],
                       inv_project(depth[:, 1::4, 1::4], m["intr"] / 4))
    assert pts.dtype == pts4.dtype == BF
    feats = torch.cat([forced["flow2d_est_induced"],
                       forced["weight"].float()], -1).reshape(-1, 6)
    tie, bound, zbound = _splat_reference_mask(
        pts[0].reshape(-1, 3).float(), feats, intr, H, W, 1.0)
    keep = ~tie
    for idx, ch in ((4, slice(0, 3)), (2, slice(3, 6))):
        d = np.abs(got[idx] - want[idx])
        tol = bound[..., ch] + 1e-4 * (1 + np.abs(want[idx]))
        assert (d <= tol)[keep].all(), idx
    jd, td = want[3], got[3]
    zj = np.where(jd > 0, 210.0 / np.maximum(jd, 1e-30), 0.0)
    dtol = 210.0 * zbound / np.maximum(zj - zbound, 1e-6) ** 2
    near_w = np.abs(jd - W) <= dtol  # the disp > W -> 0 cut is ill-defined
    ok = np.abs(td - jd) <= dtol + 1e-4 * (1 + np.abs(jd))
    assert ok[keep & ~near_w].all()
    tie4, bound4, _ = _splat_reference_mask(
        pts4[0].reshape(-1, 3).float(), m["mem_feat"][0].reshape(-1, 32)
        .float(), intr / 4, H // 4, W // 4, 2.0)
    d = np.abs(got[1] - want[1])
    tol = bound4 + 2 ** -7 * np.abs(want[1]) + 1e-6
    assert (d <= tol)[~tie4].all()
    print(f"splat tie pixels: full res {tie.mean():.3f}, "
          f"quarter res {tie4.mean():.3f}")
    assert tie.mean() < 0.6 and tie4.mean() < 0.9


def test_stage_fusion(ref, port):
    """The key projection (bf16) within 2e-2 of its max; the fusion net on
    codd_tpu's stereo and motion outputs: the fused disparity and both
    weights are f32 (the warped memory is), within 1e-3 of their max."""
    o1, st = ref["out1"], ref["st"]
    mem = st["motion"]["__call__"][0][0]
    with torch.no_grad():
        feat = port.fusion.project(tt(o1["left_feat"]))
        fused = port.fusion(
            tt(o1["pred_curr"]), tt(mem[3], torch.float32)[..., None],
            tt(st["fusion"]["project"][0]), tt(mem[1]),
            tt(mem[4], torch.float32), tt(mem[2], torch.float32),
            tt(o1["left_feat"]), tt(o1["right_feat"]))
    assert feat.dtype == BF
    assert rel_max(feat, st["fusion"]["project"][0]) < 2e-2
    for got, want in zip(fused, st["fusion"]["__call__"][0]):
        assert got.dtype == torch.float32 and rel_max(got, want) < 1e-3


# ---------------------------------------------------------------------------
# kernel 1's bf16 forms and the other bf16 points, on synthetic inputs
# ---------------------------------------------------------------------------

def _tile_inputs(B_, H_, W_, C, seed, max_d):
    rng = np.random.RandomState(seed)
    fl = rng.randn(B_, H_, W_, C).astype(np.float32)
    fr = rng.randn(B_, H_, W_, C).astype(np.float32)
    ht, wt = H_ // 4, W_ // 4
    hyp3 = np.stack([rng.rand(B_, ht, wt) * max_d,
                     rng.uniform(-1.2, 1.2, (B_, ht, wt)),
                     rng.uniform(-1.2, 1.2, (B_, ht, wt))], -1)
    return [jt(a) for a in (hyp3.astype(np.float32), fl, fr)]


@pytest.mark.parametrize("shape,max_d", [
    ((1, 8, 1280, 16), 1024.0),   # the full-res strip: x rounds above 512
    ((2, 8, 1280, 16), 1024.0),
    ((1, 8, 1280, 16), -200.0),   # taps past the right edge
    ((1, 8, 64, 32), 90.0),       # the coarsest level's C
])
def test_tile_warp_bf16_forms(shape, max_d):
    """"exact": bit for bit ``jax.jit(tile_warping)`` on bf16 inputs (0
    ulps); "pallas": within 1 bf16 ulp of the Pallas kernel's body in
    interpret mode (its f32 sums round the other way at a tie).  Both
    bf16; the wrapper takes the plain form on the CPU."""
    a = _tile_inputs(*shape, seed=shape[0] + shape[2], max_d=max_d)
    t = [tt(x) for x in a]
    exact = tile_warp_cost_plain(*t)
    pallas = tile_warp_cost_plain(*t, form="pallas")
    assert exact.dtype == pallas.dtype == BF
    np.testing.assert_array_equal(np32(exact),
                                  np32(jax.jit(tile_warping)(*a)))
    assert ulps(pallas, pallas_tile_warp(*a, interpret=True)).max() <= 1.0
    assert torch.equal(tile_warp_cost(*t, form="pallas"), pallas)
    # the two forms are different functions under bf16
    assert not torch.equal(exact, pallas)


def test_tile_warp_form_checks():
    t = [tt(x) for x in _tile_inputs(1, 8, 32, 16, 0, 20.0)]
    with pytest.raises(ValueError):
        tile_warp_cost_plain(*t, form="tilewin")
    with pytest.raises(TypeError):
        tile_warp_cost_plain(*(x.half() for x in t))
    f32 = [x.float() for x in t]
    assert torch.equal(tile_warp_cost_plain(*f32, form="pallas"),
                       tile_warp_cost_plain(*f32))


def test_plane_offsets_and_to_plane_bf16():
    """jnp.linspace's bf16 offsets (-0.49609375 at size 4) and to_plane
    rounding at each step: bit for bit."""
    assert plane_offsets(4, BF).float().tolist() == [-1.5, -0.49609375, 0.5,
                                                     1.5]
    assert plane_offsets(2, BF).float().tolist() == [-0.5, 0.5]
    rng = np.random.RandomState(3)
    d, dx, dy = (jt(rng.uniform(-300, 300, (2, 4, 8))) for _ in range(3))
    for size in (4, 2):
        np.testing.assert_array_equal(
            np32(to_plane(tt(d), tt(dx), tt(dy), size)),
            np32(jax.jit(jto_plane, static_argnums=3)(d, dx, dy, size)))


def test_init_cost_and_argmin_above_256():
    """The bf16 init cost (f32 channel sums, one rounding) bit for bit,
    and the argmin rounded to bf16: indices above 256 round to even."""
    rng = np.random.RandomState(4)
    tl, tr = jt(rng.rand(1, 2, 8, 16)), jt(rng.rand(1, 2, 32, 16))
    np.testing.assert_array_equal(
        np32(calc_init_cost(tt(tl), tt(tr), 16)),
        np32(jax.jit(jcalc_init_cost, static_argnums=2)(tl, tr, 16)))
    cost = np.ones((1, 1, 64, 320), np.float32)
    cost[0, 0, np.arange(64), 256 + np.arange(64)] = 0.0
    c_t = tt(cost)
    _, idx = torch.min(c_t, -1)
    want = np32(jnp.argmin(jt(cost), -1).astype(JBF))
    np.testing.assert_array_equal(np32(idx.to(BF)), want)
    assert (want != 256 + np.arange(64)).any()


def test_se3_f32_island():
    """exp / log / act / mul take bf16 fields, compute in f32 and round
    the result to the first argument's dtype: within 1 bf16 ulp of
    codd_tpu (both round the same f32 value; the f32 math differs in the
    last f32 bits)."""
    rng = np.random.RandomState(5)
    tau = jt(rng.randn(4, 5, 6) * 0.3)
    g = jse3.exp(tau)
    p = jt(rng.randn(4, 5, 3) * 10)
    pairs = [(se3.exp(tt(tau)), g), (se3.log(tt(g)), jse3.log(g)),
             (se3.act(tt(g), tt(p)), jse3.act(g, p)),
             (se3.mul(tt(g), tt(g)), jse3.mul(g, g)),
             (se3.act(tt(g), tt(p, torch.float32)),
              jse3.act(g, p.astype(jnp.float32)))]
    for got, want in pairs:
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        assert ulps(got, want).max() <= 1.0


def test_corr_pyramid_from_bf16_features():
    """The pyramid from bf16 feature maps: the pool runs on bf16, level
    after level (each level within 2^-7 of its max |value|, one bf16 ulp
    of the largest: codd_tpu's ``reduce_window`` rounds each of its three
    adds, the port's sum of four rounds once), bf16 volumes equal at level
    0 and within 2^-6 of their max above, and the lookups in f32 as in
    codd_tpu for both layouts."""
    rng = np.random.RandomState(6)
    f1, f2 = (jt(rng.randn(1, 8, 16, 32)) for _ in range(2))
    coords = (np.stack(np.meshgrid(np.arange(16), np.arange(8)), -1)[None]
              + rng.uniform(-3, 3, (1, 8, 16, 2))).astype(np.float32)
    P = 7
    jp = jcorr.build_corr_pyramid(f1, f2, 4, impl="patch", radius=3)
    tp = tcorr.build_corr_pyramid(tt(f1), tt(f2), 4, 3, impl="patch")
    for lvl, want in enumerate(jp["levels"]):
        got = tp["levels"][lvl][:, P:-P, P:-P]
        assert got.dtype == BF
        assert np.abs(np32(got) - np32(want)).max() <= (
            2 ** -7 * np.abs(np32(want)).max()), lvl
    jv = jcorr.build_corr_pyramid(f1, f2, 4, impl="volume", radius=3)
    tv = tcorr.build_corr_pyramid(tt(f1), tt(f2), 4, 3, impl="volume")
    for lvl, (got, want) in enumerate(zip(tv, jv["vols"])):
        assert got.dtype == BF
        # level 0 bit for bit; coarser levels carry their levels' ulps
        assert rel_max(got, want) <= (0 if lvl == 0 else 2 ** -6), lvl
    for pyr, jpyr in ((tp, jp), (tv, jv)):
        got = tcorr.corr_lookup(pyr, torch.from_numpy(coords), 3)
        want = jcorr.corr_lookup(jpyr, jnp.asarray(coords), 3)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        assert rel_max(got, want) < 2e-2


def test_gn_step_bf16_boundary():
    """gn_step on a bf16 SE(3) field with bf16 embeddings and weights and
    an f32 target: the system is built and solved in f32 (the kernels take
    f32 ``ae`` and values), the update cast to bf16 before ``exp``, and
    the result bf16, within 1 bf16 ulp of codd_tpu's."""
    rng = np.random.RandomState(7)
    h, w = 8, 16
    Ts = jse3.exp(jt(rng.randn(1, h, w, 6) * 0.01))
    ae = jt(rng.randn(1, h, w, 32))
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    target = np.stack([x + rng.randn(h, w) * 0.3, y + rng.randn(h, w) * 0.3,
                       0.1 + rng.rand(h, w) * 0.05], -1)[None]
    target = jnp.asarray(target.astype(np.float32))
    weight = jt(rng.rand(1, h, w, 3))
    depth = jt(5 + rng.rand(1, h, w) * 10)
    intr = jnp.asarray([[12.5, 12.5, 8.0, 4.0]], jnp.float32)
    for impl in ("auto", "pallas_window"):
        want = jax.jit(lambda *a: jgn_step(*a, impl=impl))(
            Ts, ae, target, weight, depth, intr)
        got = gn_step(tt(Ts), tt(ae), tt(target, torch.float32), tt(weight),
                      tt(depth), tt(intr, torch.float32), impl=impl)
        assert got.dtype == BF and want.dtype == JBF
        assert ulps(got, want).max() <= 1.0, impl


def test_splat_output_takes_the_features_dtype():
    """The splat runs in f32 and returns the features' dtype (bf16 in,
    bf16 out; zbuf too), within 1 bf16 ulp (2^-7 rel) + 1e-5 of codd_tpu's
    gather splat on a scene without depth ties (its sums, differences of
    a global f32 cumsum, leave ~1e-7 where nothing landed)."""
    rng = np.random.RandomState(8)
    n = 400
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n),
                  5 + np.arange(n) * 0.037], -1)[None].astype(np.float32)
    feats = jt(rng.randn(1, n, 6))
    intr = np.array([[20.0, 20.0, 16.0, 8.0]], np.float32)
    out, zb = splat.splat_render(tt(X, torch.float32), tt(feats),
                                 torch.from_numpy(intr), 16, 32)
    wout, wzb = jsplat_render(jnp.asarray(X), feats, jnp.asarray(intr), 16,
                              32, impl="xla_gather")
    assert out.dtype == zb.dtype == BF and wout.dtype == wzb.dtype == JBF
    for got, want in ((out, wout), (zb, wzb)):
        got, want = np32(got), np32(want)
        assert (np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-5).all()
    assert (np32(zb) > 0).mean() > 0.5


def test_disp_warp_right_edge_of_a_wide_bf16_map():
    """At the right edge of a bf16 map wider than 256, the clip bound W-1
    rounds up to W (319 -> 320): codd_tpu's ``take_along_axis`` then reads
    NaN (its fusion cues at 1280 wide are NaN there); the port clamps the
    index again as an integer and reads the edge column.  Everywhere else
    the two are equal bit for bit."""
    from codd_tpu.ops.warp import disp_warp as jdisp_warp
    from codd_torch.ops.warp import disp_warp
    rng = np.random.RandomState(9)
    img = jt(rng.randn(1, 2, 320, 4))
    disp = jt(rng.rand(1, 2, 320) * 3)
    for k in (-1.0, 0.0, 1.0):
        want = np32(jax.jit(lambda a, d: jdisp_warp(
            a, d + k, padding_mode="zeros")[0])(img, disp))
        got = np32(disp_warp(tt(img), tt(disp) + k, padding_mode="zeros")[0])
        bad = np.isnan(want)
        assert np.isfinite(got).all()
        assert bad[..., :316, :].sum() == 0 and (k > 0) <= bad.any()
        np.testing.assert_array_equal(got[~bad], want[~bad])


def test_precision_helpers():
    m = torch.nn.Linear(3, 2)
    w = m.weight.detach().clone()
    round_floats(m)
    assert m.weight.dtype == torch.float32
    assert torch.equal(m.weight, w.to(BF).float())
    tree = {"a": [torch.ones(2), torch.arange(3)], "b": (torch.zeros(1),)}
    c = cast_floats(tree)
    assert c["a"][0].dtype == BF and c["a"][1].dtype == torch.int64
    assert isinstance(c["b"], tuple) and c["b"][0].dtype == BF
    assert cast_floats(m) is m and m.weight.dtype == BF
    x = tt(np.linspace(0.3, 300, 997, dtype=np.float32))
    np.testing.assert_array_equal(np32(rdiv(210.0, x)),
                                  np32(210.0 / jt(x)))
