"""RAFT-3D dense SE(3) scene flow (counterpart of
``codd_tpu/models/motion/raft3d.py``).

Per GN iteration: project the previous frame's points through the current
transform field, sample the current inverse depth, look up the
correlation pyramid (kernel 2, or kernel 6 with ``corr_impl="patch"``),
run the ConvGRU update, and take one damped Gauss-Newton step on the
SE(3) field (kernel 3, or kernel 5 + a PyTorch solve with
``gn_impl="windowed"``/``"pallas_window"``).  The flax
``nn.scan`` over iterations is a Python loop over one ``GNIteration``
module (shared weights, named ``gn_iter`` like the scan).

Training (``forward(..., train_mode=True)``, ``codd_tpu``'s
``raft3d.py:106-166, 212-297``): the pyramid takes the patch layout when
``corr_impl`` is ``auto``; ``volume`` and ``volume_reduce`` train
through the volumes (kernel 2, and kernel 2b in the backward, with their
select's rounding), and ``volume_pallas`` raises as ``codd_tpu`` cannot
differentiate it either; each iteration detaches the SE(3) field at its
top, clips the cotangents of its four heads (``grad_clip``) and emits the
full-res supervision ``flow2d_est`` (the induced flow of the upsampled
field) and ``flow2d_rev`` (the upsampled revised target); and each runs
under ``torch.utils.checkpoint``, the counterpart of ``nn.remat``, so its
activations are recomputed in the backward and the lookup and GN kernels
run their forward twice a step.  The volumes' cotangents of the
iterations add up in bf16 in autograd's buffer, last iteration first, as
``codd_tpu``'s scan carry adds them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import corr as corr_ops
from ...ops import se3
from ...ops.gn import gn_step, grad_clip
from ...ops.grid_sample import grid_sample
from ...ops.projective import induced_flow, projective_transform
from ...ops.upsample import cvx_upsample, upsample_se3
from ...ops.warp import meshgrid_xy
from ...utils.precision import rdiv
from ..layers import Conv
from .encoders import BasicEncoder
from .hrnet import HRNetSmall, ResizeConcatConv

__all__ = ["RAFT3D", "ConvGRU", "BasicUpdateBlock", "GNIteration"]


class ConvGRU(nn.Module):
    """Dual-dilation gated update."""

    def __init__(self, hidden_dim: int = 128, dilation: int = 4):
        super().__init__()
        self.hd = hd = hidden_dim
        for g in ("z", "r", "q"):
            setattr(self, f"conv{g}1", Conv(hd, hd, 3, padding=1))
            setattr(self, f"conv{g}2", Conv(hd, hd, 3, padding=dilation,
                                            dilation=dilation))

    def forward(self, h, *inputs):
        hd = self.hd
        iz = sum(inp[..., :hd] for inp in inputs)
        ir = sum(inp[..., hd:2 * hd] for inp in inputs)
        iq = sum(inp[..., 2 * hd:3 * hd] for inp in inputs)
        z = torch.sigmoid(self.convz1(h) + self.convz2(h) + iz)
        r = torch.sigmoid(self.convr1(h) + self.convr2(h) + ir)
        rh = r * h
        q = torch.tanh(self.convq1(rh) + self.convq2(rh) + iq)
        return (1 - z) * h + z * q


class BasicUpdateBlock(nn.Module):
    """GRU + output heads."""

    def __init__(self, hidden_dim: int = 128, corr_channels: int = 196):
        super().__init__()
        self.flow_enc0 = Conv(9, 128, 7, padding=3)
        self.flow_enc1 = Conv(128, 3 * 128, 1)
        self.corr_enc0 = Conv(corr_channels, 256, 3, padding=1)
        self.corr_enc1 = Conv(256, 256, 3, padding=1)
        self.corr_enc2 = Conv(256, 3 * 128, 1)
        self.gru = ConvGRU(hidden_dim)
        for name, out in (("ae", 32), ("delta", 3), ("weight", 3),
                          ("mask", 64 * 9)):
            setattr(self, f"{name}0", Conv(hidden_dim, 256, 3, padding=1))
            setattr(self, f"{name}1", Conv(256, out, 1))

    def _head(self, name, net, sigmoid=False):
        x = getattr(self, f"{name}1")(F.relu(getattr(self, f"{name}0")(net)))
        return grad_clip(torch.sigmoid(x) if sigmoid else x)

    def forward(self, net, inp, corr, flow, dz, twist):
        motion_info = torch.cat([flow, 10.0 * dz, 10.0 * twist], -1)
        motion_info = motion_info.clamp(-50.0, 50.0)
        mot = self.flow_enc1(F.relu(self.flow_enc0(motion_info)))
        cor = F.relu(self.corr_enc0(corr))
        cor = F.relu(self.corr_enc1(cor))
        cor = self.corr_enc2(cor)
        net = self.gru(net, inp, cor, mot)
        ae = self._head("ae", net)
        delta = self._head("delta", net)
        weight = self._head("weight", net, sigmoid=True)
        mask = self._head("mask", net)
        return net, mask, ae, delta, weight


class GNIteration(nn.Module):
    """One GRU + Gauss-Newton refinement step; given ``depth_prev`` and
    ``intrinsics`` (training) it also returns the iteration's full-res
    supervision flows."""

    def __init__(self, hidden_dim: int = 128, corr_radius: int = 3,
                 corr_levels: int = 4, gn_impl: str = "auto",
                 gn_bf16_scores: bool = False, corr_select: str = "xla"):
        super().__init__()
        self.corr_radius = corr_radius
        self.corr_select = corr_select
        self.gn_impl = gn_impl
        self.gn_bf16_scores = gn_bf16_scores
        self.update_block = BasicUpdateBlock(
            hidden_dim, corr_levels * (2 * corr_radius + 1) ** 2)

    def forward(self, net, Ts, inp, vols, depth1_r8, zinv2, intr8, coords0,
                depth_prev=None, intrinsics=None):
        Ts = Ts.detach()
        coords1_xyz, _ = projective_transform(Ts, depth1_r8, intr8)
        coords1 = coords1_xyz[..., :2]
        zinv_proj = coords1_xyz[..., 2:]
        zinv = grid_sample(zinv2[..., None], coords1, mode="bilinear",
                           padding_mode="zeros")
        corr = corr_ops.corr_lookup(vols, coords1, self.corr_radius,
                                    select=self.corr_select)
        flow = coords1 - coords0
        dz = zinv - zinv_proj
        twist = se3.log(Ts)
        dt = net.dtype  # the carry keeps its dtype under bf16
        net2, mask, ae, delta, weight = self.update_block(
            net, inp, corr, flow, dz, twist)
        target = (coords1_xyz + delta).float()
        Ts = gn_step(Ts, ae, target, weight, depth1_r8, intr8,
                     impl=self.gn_impl, bf16_scores=self.gn_bf16_scores
                     ).to(Ts.dtype)
        mask = mask.to(dt)
        out = (net2.to(dt), Ts, mask, weight.to(dt))
        if depth_prev is None:
            return out
        rev = cvx_upsample(8.0 * (target[..., :2] - coords0), mask)
        est, _, _ = induced_flow(upsample_se3(Ts, mask), depth_prev,
                                 intrinsics)
        return out + (est, rev)


class RAFT3D(nn.Module):
    def __init__(self, iters: int = 16, corr_levels: int = 4,
                 corr_radius: int = 3, hidden_dim: int = 128,
                 gn_impl: str = "auto", gn_bf16_scores: bool = False,
                 corr_impl: str = "auto"):
        super().__init__()
        if corr_impl not in corr_ops.CORR_IMPLS:
            raise ValueError(f"bad corr_impl {corr_impl!r}; one of "
                             f"{corr_ops.CORR_IMPLS}")
        # eval: "auto" and the three volume selects are one volume lookup
        # ("auto" is volume_reduce); training: "auto" is "patch"
        self.corr_impl = corr_impl
        self.pyramid_impl = "patch" if corr_impl == "patch" else "volume"
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.fnet = BasicEncoder(128)
        self.cnet = HRNetSmall()
        self.cnet_out = ResizeConcatConv(18 + 36 + 72 + 144, 128 * 4)
        self.gn_iter = GNIteration(
            hidden_dim, corr_radius, corr_levels, gn_impl, gn_bf16_scores,
            corr_ops.CORR_SELECTS.get(corr_impl, "reduce"))

    def encode(self, image):
        return self.fnet(image), self.cnet_out(self.cnet(image))

    def forward(self, image_curr, depth_prev, depth_curr, intrinsics,
                fmap_prev, netinp_prev, train_mode: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Returns (outputs {Ts, flow2d_est_induced, weight} at full res,
        and with ``train_mode`` the lists ``flow2d_est`` and ``flow2d_rev``
        of every iteration, fmap_curr, netinp_curr) — the last two are the
        next frame's carry."""
        B, H, W, _ = image_curr.shape
        h8, w8 = H // 8, W // 8
        dt, dev = image_curr.dtype, image_curr.device
        pyramid_impl = self.pyramid_impl
        if train_mode:
            if self.corr_impl == "volume_pallas":
                raise NotImplementedError(
                    "RAFT3D: corr_impl='volume_pallas' has no backward: "
                    "codd_tpu cannot differentiate its select either "
                    "(window_select has no VJP); train with corr_impl "
                    "volume, volume_reduce, patch or auto")
            if self.corr_impl == "auto":
                pyramid_impl = "patch"
        fmap_curr = self.fnet(image_curr)
        vols = corr_ops.build_corr_pyramid(fmap_prev, fmap_curr,
                                           self.corr_levels, self.corr_radius,
                                           impl=pyramid_impl)
        net = torch.tanh(netinp_prev[..., :128])
        inp = F.relu(netinp_prev[..., 128:])
        intr8 = intrinsics / 8.0
        depth1_r8 = depth_prev[:, 3::8, 3::8]
        zinv2 = rdiv(1.0, depth_curr[:, 3::8, 3::8].clamp(min=1e-8))
        x0, y0 = meshgrid_xy(h8, w8, dt, dev)
        coords0 = torch.stack([x0, y0], -1)[None].expand(B, h8, w8, 2)
        Ts = se3.identity((B, h8, w8), dt, dev)
        mask = torch.zeros((B, h8, w8, 64 * 9), dtype=dt, device=dev)
        weight = torch.zeros((B, h8, w8, 3), dtype=dt, device=dev)
        ests, revs = [], []
        for _ in range(self.iters):
            if train_mode:
                net, Ts, mask, weight, est, rev = checkpoint(
                    self.gn_iter, net, Ts, inp, vols, depth1_r8, zinv2,
                    intr8, coords0, depth_prev, intrinsics,
                    use_reentrant=False)
                ests.append(est)
                revs.append(rev)
            else:
                net, Ts, mask, weight = self.gn_iter(
                    net, Ts, inp, vols, depth1_r8, zinv2, intr8, coords0)
        Ts_up = upsample_se3(Ts, mask)
        flow2d, _, _ = induced_flow(Ts_up, depth_prev, intrinsics)
        out = {"Ts": Ts_up, "flow2d_est_induced": flow2d,
               "weight": cvx_upsample(weight, mask)}
        if train_mode:
            out["flow2d_est"], out["flow2d_rev"] = ests, revs
        netinp_curr = self.cnet_out(self.cnet(image_curr))
        return out, fmap_curr, netinp_curr
