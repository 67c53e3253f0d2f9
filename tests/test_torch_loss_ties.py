"""|x| at an exact tie in the losses: the port's gradient against
``jax.vjp`` of ``codd_tpu``'s loss on the same inputs.

``jnp.abs``'s cotangent at 0 is +g (``select(x >= 0, g, -g)``);
``torch.abs``'s backward gives 0 there.  Every |x| that a loss
differentiates is ``utils/precision.py:absolute``, which takes JAX's.
Each case puts exact ties at one site on a set of pixels and holds every
input gradient to JAX's within 1e-5 of its largest value (f32 means and
9x9 convolutions in another order), and checks that the ties are there.
Where the tie's cotangent reaches the inputs (the motion loss's three
terms, the fusion weight's |w - 0.5|, the slants, ``comp_err``), it is
of the size of the other pixels' and ``torch.abs`` fails the case.

Two sites feed a function whose derivative vanishes at the tie, so the
tie gives the same gradient under either VJP (up to rounding): the
propagation term's |d_gt - d| enters ``echo_loss``, whose derivative at 0
is 0, and the normal term's |1 - cos| is 0 only where cos is at its
maximum.  ``losses/assembly.py``'s ``epe`` feeds only a log and is not
differentiated.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.losses import hitnet as jhit
from codd_tpu.losses import temporal as jtemporal
from codd_torch.losses import hitnet as thit
from codd_torch.losses import temporal as ttemporal

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

H, W = 64, 128
MAXD = 32


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_()


def _close(got, want):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * (np.abs(want).max() + 1e-12)


def _tie_mask(rng, shape, share=0.3):
    return rng.rand(*shape[:-1], 1) < share


@pytest.mark.parametrize("site", ["flow", "dz", "reverse"])
def test_motion_loss_tie(site):
    """``motion_loss``'s |fl_est - fl_gt| (flow), |dz_est - dz_gt| (dz) and
    |flow2d_rev - fl_gt| (reverse), tied on 30 % of the pixels at every
    GN iteration."""
    rng = np.random.RandomState(5)
    n = 3
    gt = rng.randn(1, H, W, 3).astype(np.float32)
    est = [rng.randn(1, H, W, 3).astype(np.float32) for _ in range(n)]
    rev = [rng.randn(1, H, W, 2).astype(np.float32) for _ in range(n)]
    mask = rng.rand(1, H, W, 1) > 0.2
    tie = _tie_mask(rng, gt.shape)
    for i in range(n):
        if site == "flow":
            est[i][..., :2] = np.where(tie, gt[..., :2], est[i][..., :2])
        elif site == "dz":
            est[i][..., 2:] = np.where(tie, gt[..., 2:], est[i][..., 2:])
        else:
            rev[i] = np.where(tie, gt[..., :2], rev[i])

    def jloss(e, r):
        return jtemporal.motion_loss(e, r, jnp.asarray(gt), mask)[0]

    jl, vjp = jax.vjp(jloss, [jnp.asarray(a) for a in est],
                      [jnp.asarray(a) for a in rev])
    jge, jgr = vjp(jnp.ones_like(jl))
    te, tr = [_t(a) for a in est], [_t(a) for a in rev]
    ttemporal.motion_loss(te, tr, torch.from_numpy(gt),
                          torch.from_numpy(mask))[0].backward()
    at = (tie & mask)[..., 0]
    tied = (np.asarray(jge[0])[..., :2] if site == "flow"
            else np.asarray(jge[0])[..., 2:] if site == "dz"
            else np.asarray(jgr[0]))
    assert at.sum() > 100 and (tied[at] > 0).all()
    for t, j in zip(te + tr, list(jge) + list(jgr)):
        _close(t.grad, j)


def test_fusion_loss_tie():
    """``fusion_loss``'s |w_curr - 0.5|: a fusion weight of exactly 0.5 on
    pixels where the current and the warped disparity are within C1 of
    each other's error (the sigmoid head's value at a logit of 0)."""
    rng = np.random.RandomState(6)
    gt = rng.uniform(2, 30, (1, H, W, 1)).astype(np.float32)
    pred = gt + rng.uniform(-2, 2, gt.shape).astype(np.float32)
    near = rng.rand(1, H, W, 1) < 0.5
    curr = gt + np.where(near, rng.uniform(-0.4, 0.4, gt.shape),
                         rng.uniform(-8, 8, gt.shape)).astype(np.float32)
    warp = gt + np.where(near, rng.uniform(-0.4, 0.4, gt.shape),
                         rng.uniform(-8, 8, gt.shape)).astype(np.float32)
    warp[:, :4] = 0.0
    fw = rng.rand(1, H, W, 1).astype(np.float32)
    tie = _tie_mask(rng, gt.shape, 0.5)
    fw = np.where(tie, np.float32(0.5), fw)
    rw = rng.rand(1, H, W, 1).astype(np.float32)
    kw = dict(wr_weight=0.7, wf_weight=1.3, max_disp=float(MAXD))

    def jloss(p, f, r):
        return jtemporal.fusion_loss(p, jnp.asarray(gt), f, r,
                                     jnp.asarray(curr), jnp.asarray(warp),
                                     **kw)

    jl, vjp = jax.vjp(jloss, *map(jnp.asarray, (pred, fw, rw)))
    jg = vjp(jnp.ones_like(jl))
    ts = [_t(a) for a in (pred, fw, rw)]
    ttemporal.fusion_loss(ts[0], torch.from_numpy(gt), ts[1], ts[2],
                          torch.from_numpy(curr), torch.from_numpy(warp),
                          **kw).backward()
    d = np.abs(curr - gt) - np.abs(warp - gt)
    at = (tie & (np.abs(d) <= 1.0) & (warp > 0) & (gt <= MAXD))[..., 0]
    assert at.sum() > 100 and (np.asarray(jg[1])[0, ..., 0][at[0]] < 0).all()
    for t, j in zip(ts, jg):
        _close(t.grad, j)


def _hit_inputs(rng):
    cvs = [rng.rand(1, H // s, W // s, MAXD // (s // 4)).astype(np.float32)
           * 3 for s in (64, 32, 16, 8, 4)]
    d_gt = rng.uniform(0.5, 30.0, (1, H, W, 1)).astype(np.float32)
    planes = [d_gt + rng.uniform(-0.8, 0.8, d_gt.shape).astype(np.float32)
              for _ in range(12)]
    dxs = [rng.randn(1, H, W, 1).astype(np.float32) for _ in range(12)]
    dys = [rng.randn(1, H, W, 1).astype(np.float32) for _ in range(12)]
    ws = [rng.randn(1, H, W, 1).astype(np.float32) for _ in range(8)]
    return [cvs, planes, dxs, dys, ws], d_gt


def _hit_grads(fn_j, fn_t, pyr_j, pyr_t, d_gt, **kw):
    """Gradients of (codd_tpu, port) ``hit_loss``-like ``fn`` to every
    pyramid; ``pyr_j`` / ``pyr_t`` may differ where a tie needs each
    framework's own ground-truth slants."""
    jcfg, tcfg = jhit.HITLossConfig(max_disp=MAXD), thit.HITLossConfig(
        max_disp=MAXD)

    def jloss(p):
        return fn_j(jcfg, *p, jnp.asarray(d_gt), **kw)[0]

    jl, vjp = jax.vjp(jloss, jax.tree_util.tree_map(jnp.asarray, pyr_j))
    jg, = vjp(jnp.ones_like(jl))
    tp = [[_t(a) for a in lvl] for lvl in pyr_t]
    fn_t(tcfg, *tp, torch.from_numpy(d_gt), **kw)[0].backward()
    for tlvl, jlvl in zip(tp, jg):
        for t, j in zip(tlvl, jlvl):
            _close(t.grad, j)
    return jg


def test_hit_loss_propagation_tie():
    """|d_gt - d| of the propagation term, tied on 30 % of the pixels at
    every level: ``echo_loss``'s derivative at 0 is 0, so JAX's gradient
    there is 0 as ``torch.abs``'s is."""
    rng = np.random.RandomState(7)
    pyr, d_gt = _hit_inputs(rng)
    tie = _tie_mask(rng, d_gt.shape)
    pyr[1] = [np.where(tie, d_gt, p) for p in pyr[1]]
    jg = _hit_grads(jhit.hit_loss, thit.hit_loss, pyr, pyr, d_gt)
    assert tie.sum() > 100
    assert all((np.asarray(g)[tie] == 0).all() for g in jg[1])


def test_hit_loss_slant_tie():
    """|dx_gt - dx| and |dy_gt - dy| of the slant term: every level's
    slants equal to the ground truth's (each framework's own 9x9 fit of
    d_gt) on 30 % of the pixels, the propagation within 1 px there."""
    rng = np.random.RandomState(8)
    pyr, d_gt = _hit_inputs(rng)
    tie = _tie_mask(rng, d_gt.shape)
    fits = {"j": [np.asarray(jhit._conv9x9(jnp.asarray(d_gt), k))
                  for k in (jhit._KX, jhit._KY)],
            "t": [thit._conv9x9(torch.from_numpy(d_gt), k).numpy()
                  for k in (thit._KX, thit._KY)]}
    own = {}
    for side, (gx, gy) in fits.items():
        p = [list(lvl) for lvl in pyr]
        p[2] = [np.where(tie, gx, a) for a in pyr[2]]
        p[3] = [np.where(tie, gy, a) for a in pyr[3]]
        own[side] = p
    jg = _hit_grads(jhit.hit_loss, thit.hit_loss, own["j"], own["t"], d_gt)
    at = (tie & (d_gt < MAXD))[..., 0]
    assert at.sum() > 100
    assert all((np.asarray(g)[0, ..., 0][at[0]] != 0).all()
               for g in jg[2] + jg[3])


@pytest.mark.parametrize("site", ["comp_err", "normal"])
def test_hit_loss_with_depth_tie(site):
    """``hit_loss_with_depth``: the finest disparity equal to d_gt on a
    24 x 40 block.  comp_err: log1p(|a - b|) ties in the depth term at
    every pixel of the block and in the depth-gradient term at the
    pixels whose 9x9 window lies in it; JAX's gradient there is not 0.
    normal: only the normal term (lambda_depth = lambda_depth_grad = 0);
    |1 - cos| ties where the two normals are equal and cos rounds to 1,
    its maximum, so the gradient there is rounding under either VJP."""
    rng = np.random.RandomState(9)
    pyr, d_gt = _hit_inputs(rng)
    block = np.zeros_like(d_gt, dtype=bool)
    block[:, 20:44, 40:80] = True
    pyr[1][-1] = np.where(block, d_gt, pyr[1][-1])
    kw = dict(calib=50.0)
    if site == "normal":
        kw.update(lambda_depth=0.0, lambda_depth_grad=0.0)
    jg = _hit_grads(jhit.hit_loss_with_depth, thit.hit_loss_with_depth, pyr,
                    pyr, d_gt, **kw)
    # the port's own normals: equal and cos == 1 inside the block
    depth = 50.0 / (torch.from_numpy(pyr[1][-1]) + 1e-8)
    tdepth = 50.0 / (torch.from_numpy(d_gt) + 1e-8)
    pdx = thit._conv9x9(depth, thit._KX)
    tdx = thit._conv9x9(tdepth, thit._KX)
    inner = block.copy()
    inner[:, :24] = inner[:, 40:] = False
    inner[:, :, :44] = inner[:, :, 76:] = False
    assert bool((pdx == tdx)[torch.from_numpy(inner)].all())
    g = np.asarray(jg[1][-1])
    if site == "comp_err":
        assert (g[block] != 0).all()
    else:
        pn = torch.cat([-pdx, -thit._conv9x9(depth, thit._KY),
                        torch.ones_like(pdx)], -1)
        cos = torch.sum(pn * pn, -1) / (torch.linalg.norm(pn, dim=-1) ** 2
                                        + 1e-8)
        assert int((cos == 1.0)[torch.from_numpy(inner[..., 0])].sum()) > 50
