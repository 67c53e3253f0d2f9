"""The volumes' running cotangent: kernel 2b's plain version adding into it,
and the autograd plumbing that makes one a backward pass
(``ops/corr.py``: ``VolumePyramid``, ``VolumeCarry``, ``VolumeCotangent``).

Every case is held in bits, for both selects (``"xla"``, ``corr_impl``
``volume``; ``"reduce"``, ``volume_reduce``), on a coordinate field whose
windows pass every edge of every level:

* the plain backward's add into a non-zero running cotangent is
  ``acc + dense`` (one bf16 rounding an element), its coordinates' gradient
  the dense call's;
* a bare list of volumes keeps its dense ``.grad``: autograd's bf16 sum of
  the lookups' dense cotangents, last lookup first;
* the volumes of ``build_corr_pyramid`` reach the matmul that built them
  with that same sum, made as one running cotangent; another op on the
  volumes adds its cotangent last;
* a second backward over a retained graph gives the same gradients;
* the motion stage through the volumes makes one running cotangent a
  backward (a fill a level) and adds no dense cotangent.

The motion stage against ``codd_tpu`` and the in-order sum of its 2b
calls are in ``tests/test_torch_corr_volume_backward.py``.
"""

import numpy as np
import pytest
import torch

from codd_torch.config import load_config
from codd_torch.losses import assembly
from codd_torch.models.builder import build_estimator, build_loss_config
from codd_torch.ops import corr

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
SELECTS = ("xla", "reduce")


def _case(seed, Bc=2, h=6, w=10, C=16):
    """Feature maps and makers of coordinate fields that throw windows up
    to 14 px past every edge (level 0 is 6x10, level 3 is 0x1 and all
    padding) and of the lookup's cotangents."""
    rng = np.random.RandomState(seed)
    f1 = torch.from_numpy(rng.randn(Bc, h, w, C).astype(np.float32))
    f2 = torch.from_numpy(rng.randn(Bc, h, w, C).astype(np.float32))
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]

    def field():
        return torch.from_numpy((grid + rng.uniform(-14.0, 14.0, (
            Bc, h, w, 2))).astype(np.float32))

    def cot():
        return torch.from_numpy(rng.randn(Bc, h, w, 4 * 49).astype(
            np.float32))

    return f1, f2, field, cot


def _bits(t):
    return t.contiguous().view(torch.int16)


def _dense(g, vols, coords, select):
    """The plain backward's dense volume cotangents of one lookup."""
    return corr.corr_lookup_backward_plain(g, [v.detach() for v in vols],
                                           coords, 3, None, select)[0]


def _in_order(dense):
    """autograd's bf16 sum of dense cotangents, in the order given."""
    acc = list(dense[0])
    for d in dense[1:]:
        acc = [a + x for a, x in zip(acc, d)]
    return acc


@pytest.mark.parametrize("select", SELECTS)
def test_plain_backward_adds_into_a_running_cotangent(select):
    """Into a running cotangent of random bf16 values (and +0s), each
    window element takes one bf16 rounding of its sum, ``acc + dense`` in
    bits, everything else keeps its bits; the running cotangent is updated
    in place and returned; the coordinates' gradient is the dense call's
    bits."""
    f1, f2, field, cot = _case(0)
    vols = corr.build_corr_pyramid(f1, f2, 4, 3)
    coords, g = field(), cot()
    rng = np.random.RandomState(1)
    acc = []
    for v in vols:
        a = torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
        a[torch.from_numpy(rng.rand(*v.shape) < 0.25)] = 0.0
        acc.append(a.to(torch.bfloat16))
    dense, dc = corr.corr_lookup_backward_plain(g, vols, coords, 3, None,
                                                select)
    run = [a.clone() for a in acc]
    got, gc = corr.corr_lookup_backward_plain(g, vols, coords, 3, None,
                                              select, out=run)
    assert all(x is y for x, y in zip(got, run))
    assert torch.equal(gc, dc)
    for a, d, x in zip(acc, dense, got):
        assert torch.equal(_bits(x), _bits(a + d))
        assert d.count_nonzero() > 0
    # through the wrapper, as the autograd Function calls it
    run = [a.clone() for a in acc]
    got, _ = corr.corr_lookup_backward(g, vols, coords, 3, None, select, run)
    for a, d, x in zip(acc, dense, got):
        assert torch.equal(_bits(x), _bits(a + d))


@pytest.mark.parametrize("select", SELECTS)
def test_bare_list_keeps_its_dense_grad(select):
    """Leaf volumes in a plain list: three lookups' backward return dense
    cotangents, and each volume's ``.grad`` is autograd's bf16 sum of
    them, last lookup first (no running cotangent)."""
    f1, f2, field, cot = _case(2)
    base = corr.build_corr_pyramid(f1, f2, 4, 3)
    assert type(base) is list
    vols = [v.clone().requires_grad_() for v in base]
    calls = [(field(), cot()) for _ in range(3)]
    seen = []
    real = corr.corr_lookup_backward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(corr, "corr_lookup_backward",
                   lambda *a: seen.append(a[6:]) or real(*a))
        out = sum((corr.corr_lookup(vols, c, 3, select=select) * g).sum()
                  for c, g in calls)
        out.backward()
    assert seen == [(None,)] * 3
    want = _in_order([_dense(g, base, c, select) for c, g in calls[::-1]])
    for v, w in zip(vols, want):
        assert v.grad.dtype == torch.bfloat16
        assert torch.equal(_bits(v.grad), _bits(w))


def _pyramid_run(f1, f2, calls, select, other=None, retain=False):
    """``build_corr_pyramid`` under autograd, one lookup per call (and
    ``other(vols)``, another op on the volumes, where given), backward from
    the cotangents: the cotangents the carry hands the matmul, the running
    cotangent each 2b call got, and the gradients of f1, f2 and the
    coordinates."""
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    vols = corr.build_corr_pyramid(a, b, 4, 3)
    assert isinstance(vols, corr.VolumePyramid)
    arrived, running = [], []
    vols[0].grad_fn.register_hook(
        lambda gi, go: arrived.append([x.clone() for x in gi]))
    cs = [c.clone().requires_grad_() for c, _ in calls]
    real = corr.corr_lookup_backward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(corr, "corr_lookup_backward",
                   lambda *args: running.append(args[6]) or real(*args))
        loss = sum((corr.corr_lookup(vols, c, 3, select=select) * g).sum()
                   for c, (_, g) in zip(cs, calls))
        if other is not None:
            loss = loss + other(vols)
        loss.backward(retain_graph=retain)
        grads = [a.grad.clone(), b.grad.clone()] + [c.grad.clone()
                                                     for c in cs]
        if retain:
            for t in (a, b, *cs):
                t.grad = None
            loss.backward()
            grads2 = [a.grad, b.grad] + [c.grad for c in cs]
            return arrived, running, grads, grads2
    return arrived, running, grads


@pytest.mark.parametrize("select", SELECTS)
def test_pyramid_cotangent_is_the_in_order_sum(select):
    """Three lookups on the pyramid's volumes: every 2b call gets the same
    running cotangent (one a backward), the lookups return none for the
    volumes, and what reaches the volumes' matmul is autograd's in-order
    bf16 sum of the three dense cotangents in bits; f1, f2 and the
    coordinates get the gradients of the same graph over a bare list of
    the same volumes (the dense path), in bits."""
    f1, f2, field, cot = _case(3)
    calls = [(field(), cot()) for _ in range(3)]
    arrived, running, grads = _pyramid_run(f1, f2, calls, select)
    assert len(running) == 3 and running[0] is not None
    assert all(r is running[0] for r in running)
    base = corr.build_corr_pyramid(f1, f2, 4, 3)
    want = _in_order([_dense(g, base, c, select) for c, g in calls[::-1]])
    assert len(arrived) == 1
    for got, w in zip(arrived[0], want):
        assert torch.equal(_bits(got), _bits(w))
    # the dense path: the pyramid's volumes as a bare list
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    vols = list(corr.build_corr_pyramid(a, b, 4, 3))
    vols = [v.view_as(v) for v in vols]
    cs = [c.clone().requires_grad_() for c, _ in calls]
    sum((corr.corr_lookup(vols, c, 3, select=select) * g).sum()
        for c, (_, g) in zip(cs, calls)).backward()
    for got, w in zip(grads, [a.grad, b.grad] + [c.grad for c in cs]):
        assert torch.equal(got, w)


@pytest.mark.parametrize("select", SELECTS)
def test_another_consumer_adds_last(select):
    """Two more ops on the volumes besides two lookups: autograd sums
    their dense cotangents at the carry, and the carry adds that sum to
    the running cotangent last, in bf16: (lookups' in-order sum) + (the
    other ops' sum)."""
    f1, f2, field, cot = _case(4)
    calls = [(field(), cot()) for _ in range(2)]
    rng = np.random.RandomState(5)
    w = [torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
         for v in corr.build_corr_pyramid(f1, f2, 4, 3)]

    def other(vols):
        return (sum((v.float() * x).sum() for v, x in zip(vols, w))
                + (vols[0].float() ** 2).sum())

    arrived, running, _ = _pyramid_run(f1, f2, calls, select, other)
    base = corr.build_corr_pyramid(f1, f2, 4, 3)
    lookups = _in_order([_dense(g, base, c, select) for c, g in calls[::-1]])
    # the other ops' cotangents, as autograd sums them at the carry
    vs = [v.detach().requires_grad_() for v in base]
    others = torch.autograd.grad(other(vs), vs)
    assert len(arrived) == 1
    for got, lk, ot in zip(arrived[0], lookups, others):
        assert torch.equal(_bits(got), _bits(lk + ot))
        assert ot.count_nonzero() > 0


@pytest.mark.parametrize("select", SELECTS)
def test_second_backward_over_a_retained_graph(select):
    """``backward(retain_graph=True)`` twice: the second pass zeroes a new
    running cotangent (the first was released to the matmul) and gives
    every gradient the first pass's bits."""
    f1, f2, field, cot = _case(6)
    calls = [(field(), cot()) for _ in range(2)]
    arrived, running, first, second = _pyramid_run(f1, f2, calls, select,
                                                    retain=True)
    assert len(arrived) == 2 and len(running) == 4
    assert running[0] is running[1] and running[2] is running[3]
    assert running[2] is not running[0]
    for x, y in zip(arrived[0], arrived[1]):
        assert torch.equal(_bits(x), _bits(y))
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_motion_stage_makes_one_running_cotangent():
    """The motion stage (``configs/models/stereo_motion.py``,
    ``corr_impl="volume"``, 64x128, 2 GN iterations) under the profiler,
    host ops with shapes: its backward fills one running cotangent (one
    ``zero_`` a level) and adds no tensor shaped as a volume, where one
    dense cotangent a GN iteration would fill 2 a level and add 1; every
    2b call adds into that one running cotangent."""
    from torch.profiler import ProfilerActivity, profile
    opts = ["model.stereo.initialization.max_disp=32",
            "model.stereo.loss.max_disp=32", "model.motion.iters=2",
            "model.runtime.corr_impl=volume"]
    cfg = dict(load_config(str(ROOT / "configs" / "models"
                               / "stereo_motion.py"), opts)["model"])
    model = build_estimator(cfg, device="cpu", seed=0)
    rng = np.random.RandomState(0)
    B, T, H, W = 1, 2, 64, 128
    batch = {
        "l_img": rng.rand(B, T, H, W, 3), "r_img": rng.rand(B, T, H, W, 3),
        "gt_disp": rng.uniform(1.0, 25.0, (B, T, H, W, 1)),
        "gt_flow": rng.uniform(-3.0, 3.0, (B, T, H, W, 2)),
        "gt_disp_change": rng.uniform(-1.0, 1.0, (B, T, H, W, 1)),
        "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]] * B)}
    batch = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in batch.items()}
    shapes, running = set(), []
    real_build, real_bwd = corr.build_corr_pyramid, corr.corr_lookup_backward

    def build(*args, **kwargs):
        vols = real_build(*args, **kwargs)
        for v in vols:
            b, n, hp, wp = v.shape
            shapes.update({(b, n, hp, wp), (b, n, hp * wp)})
        return vols

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(corr, "build_corr_pyramid", build)
        mp.setattr(corr, "corr_lookup_backward",
                   lambda *a: running.append(a[6]) or real_bwd(*a))
        outs = model(batch["l_img"], batch["r_img"], batch["intrinsics"],
                     train=True)
        loss, _ = assembly.codd_train_loss(build_loss_config(cfg), outs,
                                           batch)
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as p:
            loss.backward()

    def count(names):
        return sum(1 for e in p.events() if e.name in names and e.input_shapes
                   and tuple(e.input_shapes[0]) in shapes)

    assert len(shapes) == 8
    assert count(("aten::zero_",)) == 4
    assert count(("aten::add", "aten::add_")) == 0
    assert len(running) == 2 and running[0] is running[1]
    assert any(p.grad is not None and p.grad.count_nonzero() > 0
               for p in model.motion.raft3d.fnet.parameters())
