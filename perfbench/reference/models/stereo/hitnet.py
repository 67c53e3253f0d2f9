"""HITNet tile-hypothesis stereo matcher (counterpart of
``codd_tpu/models/stereo/hitnet.py``), its eval branch in float32.

HITUNet feature pyramid [1/16 .. 1/1] -> 4x4 tile initialisation with a
full-range matching cost per level -> coarse-to-fine tile propagation,
whose slant-plane warp cost is kernel 1 (``ops/tile_warp.py``).  Tile
hypotheses carry 16 channels [d, dx, dy, 13-ch descriptor].  Submodules
are named after the flax modules so parameters bridge by path."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.tile_warp import tile_warp_cost
from ...ops.upsample import hyp_upsample, pixel_unshuffle
from ..layers import Conv, ConvTranspose, SharedStrideConv, lrelu

__all__ = ["HITUNet", "calc_init_cost", "TileInitialization",
           "TilePropagation", "HITNetStereo"]

FEA_CH = (32, 24, 24, 16, 16)  # HITUNet outputs at [1/16, 1/8, 1/4, 1/2, 1/1]


class _ConvDown(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.c0 = Conv(cin, features, 4, stride=2, padding=1)
        self.c1 = Conv(features, features, 3, padding=1)

    def forward(self, x):
        return lrelu(self.c1(lrelu(self.c0(x))))


class _ConvMerge(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.c0 = Conv(cin, features, 1)
        self.c1 = Conv(features, features, 3, padding=1)
        self.c2 = Conv(features, features, 3, padding=1)

    def forward(self, x):
        return lrelu(self.c2(lrelu(self.c1(lrelu(self.c0(x))))))


class HITUNet(nn.Module):
    """UNet backbone -> [1/16, 1/8, 1/4, 1/2, 1/1] features with channels
    [32, 24, 24, 16, 16]."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 16, 3, padding=1)
        self.down1 = _ConvDown(16, 16)
        self.down2 = _ConvDown(16, 24)
        self.down3 = _ConvDown(24, 24)
        self.down4_0 = _ConvDown(24, 32)
        self.down4_1 = Conv(32, 32, 3, padding=1)
        self.down4_2 = Conv(32, 32, 3, padding=1)
        self.up4 = ConvTranspose(32, 24)
        self.merge4 = _ConvMerge(48, 24)
        self.up3 = ConvTranspose(24, 24)
        self.merge3 = _ConvMerge(48, 24)
        self.up2 = ConvTranspose(24, 16)
        self.merge2 = _ConvMerge(32, 16)
        self.up1 = ConvTranspose(16, 16)
        self.merge1 = _ConvMerge(32, 16)

    def forward(self, x):
        x_down = lrelu(self.conv1(x))
        x_down1 = self.down1(x_down)
        x_down2 = self.down2(x_down1)
        x_down3 = self.down3(x_down2)
        x4 = lrelu(self.down4_1(self.down4_0(x_down3)))
        x_down4 = lrelu(self.down4_2(x4))
        x_up4 = self.merge4(torch.cat([x_down3, lrelu(self.up4(x_down4))], -1))
        x_up3 = self.merge3(torch.cat([x_down2, lrelu(self.up3(x_up4))], -1))
        x_up2 = self.merge2(torch.cat([x_down1, lrelu(self.up2(x_up3))], -1))
        x_up1 = self.merge1(torch.cat([x_down, lrelu(self.up1(x_up2))], -1))
        return [x_down4, x_up4, x_up3, x_up2, x_up1]


def calc_init_cost(feat_l, feat_r_full, max_disp: int, rows: int = 0):
    """cost[b, y, j, d] = ||L_j - R_{4j-d}||_1 with right features left of
    column 0 reading zero.  feat_l (B,ht,wt,C), feat_r_full (B,ht,4wt,C)
    -> (B,ht,wt,D).  Windows of the zero-padded right features are strided
    views (``unfold``); ``rows`` tile rows are done at a time to bound the
    (rows, wt, C, D) difference tensor (0 = choose)."""
    B, ht, wt, C = feat_l.shape
    D = max_disp
    rp = F.pad(feat_r_full, (0, 0, D, 0))               # (B,ht,D+wr,C)
    # win[..., j, c, m] = rp[..., 4j + m, c]; column 4j - d is m = D - d
    win = rp.unfold(2, D + 1, 4)[..., 1:].flip(-1)      # (B,ht,wt,C,D)
    if rows <= 0:
        rows = max(1, (1 << 26) // max(1, B * wt * C * D))
    out = []
    for y in range(0, ht, rows):
        diff = feat_l[:, y:y + rows, :, :, None] - win[:, y:y + rows]
        out.append(torch.abs(diff).sum(3))
    return torch.cat(out, 1)


class _TileConv(nn.Module):
    """Shared-weight 4x4 tile embedding; left stride (4,4), right (4,1)."""

    def __init__(self, cin):
        super().__init__()
        self.c0 = SharedStrideConv(cin, 16, (4, 4))
        self.c1 = Conv(16, 16, 1)

    def forward(self, fea_l, fea_r):
        tl = lrelu(self.c1(lrelu(self.c0(fea_l, (4, 4)))))
        fr = F.pad(fea_r, (0, 0, 0, 3))
        tr = lrelu(self.c1(lrelu(self.c0(fr, (4, 1)))))
        return tl, tr


_LEVELS = ("16x", "8x", "4x", "2x", "1x")
_DIVS = (16, 8, 4, 2, 1)


class TileInitialization(nn.Module):
    def __init__(self, max_disp: int = 320):
        super().__init__()
        self.max_disp = max_disp
        for lvl, name in enumerate(_LEVELS):
            guide_ch = 16 if lvl < 2 else FEA_CH[lvl - 2]
            setattr(self, f"tile_conv{name}", _TileConv(FEA_CH[lvl]))
            setattr(self, f"tile_fea_dscrpt{name}", Conv(1 + guide_ch, 13, 1))

    def forward(self, fea_l, fea_r):
        """Returns (cost pyramid, hypothesis pyramid), coarse to fine at
        tile resolutions [1/64 .. 1/4]."""
        costs, hyps = [], []
        for lvl, name in enumerate(_LEVELS):
            tl, tr = getattr(self, f"tile_conv{name}")(fea_l[lvl], fea_r[lvl])
            cost = calc_init_cost(tl, tr, self.max_disp // _DIVS[lvl])
            cmin, d0 = torch.min(cost, -1, keepdim=True)
            d0 = d0.to(tl.dtype)
            guide = tl if lvl < 2 else fea_l[lvl - 2]
            dscrpt = lrelu(getattr(self, f"tile_fea_dscrpt{name}")(
                torch.cat([cmin, guide], -1)))
            zeros = torch.zeros_like(d0)
            hyps.append(torch.cat([d0, zeros, zeros, dscrpt], -1))
            costs.append(cost)
        return costs, hyps


class ResBlock(nn.Module):
    def __init__(self, features, dilation: int = 1):
        super().__init__()
        p = dilation if dilation > 1 else 1
        self.conv1 = Conv(features, features, 3, padding=p, dilation=dilation)
        self.conv2 = Conv(features, features, 3, padding=p, dilation=dilation)

    def forward(self, x):
        return lrelu(x + self.conv2(lrelu(self.conv1(x))))


class _CVEncoder(nn.Module):
    """unshuffled |fea_l| + tile-warp cost -> 16 ch (the `decrease` layer)."""

    def __init__(self):
        super().__init__()
        self.decrease = Conv(64, 16, 1)

    def forward(self, hyp3, fea_l, fea_r, fea_mag):
        cv = tile_warp_cost(hyp3.contiguous(), fea_l, fea_r)
        return lrelu(self.decrease(torch.cat([fea_mag, cv], -1)))


def _fea_mag(fea_l):
    return pixel_unshuffle(torch.sum(torch.abs(fea_l), -1, keepdim=True), 4)


def _relu_d(h):
    return torch.cat([F.relu(h[..., :1]), h[..., 1:]], -1)


class TileUpdate0(nn.Module):
    """Coarsest-level refinement."""

    def __init__(self):
        super().__init__()
        self.cv = _CVEncoder()
        self.conv0 = Conv(32, 32, 1)
        self.resblock0 = ResBlock(32)
        self.resblock1 = ResBlock(32)
        self.lastconv = Conv(32, 16, 3, padding=1)

    def forward(self, fea_l, fea_r, hyp):
        cv = self.cv(hyp[..., :3], fea_l, fea_r, _fea_mag(fea_l))
        x = lrelu(self.conv0(torch.cat([hyp, cv], -1)))
        x = self.resblock1(self.resblock0(x))
        return _relu_d(hyp + self.lastconv(x))


class TileUpdate(nn.Module):
    """Two-hypothesis refinement + confidence selection."""

    def __init__(self):
        super().__init__()
        self.cv = _CVEncoder()
        self.conv0 = Conv(64, 32, 1)
        self.resblock0 = ResBlock(32)
        self.resblock1 = ResBlock(32)
        self.lastconv = Conv(32, 34, 3, padding=1)

    def forward(self, fea_l, fea_r, hyp_cur, hyp_prev):
        """The refined hypothesis."""
        fea_mag = _fea_mag(fea_l)
        cv_cur = self.cv(hyp_cur[..., :3], fea_l, fea_r, fea_mag)
        hyp_up = hyp_upsample(hyp_prev, 2.0)
        cv_up = self.cv(hyp_up[..., :3], fea_l, fea_r, fea_mag)
        x = lrelu(self.conv0(torch.cat([hyp_cur, cv_cur, hyp_up, cv_up], -1)))
        out = self.lastconv(self.resblock1(self.resblock0(x)))
        conf = out[..., :2]
        upd_cur = _relu_d(hyp_cur + out[..., 18:34])
        upd_prev = _relu_d(hyp_up + out[..., 2:18])
        sel = (torch.argmax(conf, -1, keepdim=True) == 1).to(out.dtype)
        return sel * upd_cur + (1.0 - sel) * upd_prev


class PostTileUpdate(nn.Module):
    """Feature-guided refinement at/below tile size."""

    def __init__(self, cin, hid_c=32, out_c=16, resblk_num=4):
        super().__init__()
        self.resblk_num = resblk_num
        self.conv1_0 = Conv(cin, hid_c, 1)
        self.conv1_1 = Conv(hid_c, hid_c, 3, padding=1)
        for i in range(resblk_num):
            setattr(self, f"resblock{i}", ResBlock(hid_c, 3 if i == 1 else 1))
        self.lastconv = Conv(hid_c, out_c, 3, padding=1)

    def forward(self, fea_l, hyp):
        x = lrelu(self.conv1_0(torch.cat([fea_l, hyp], -1)))
        x = lrelu(self.conv1_1(x))
        for i in range(self.resblk_num):
            x = getattr(self, f"resblock{i}")(x)
        return _relu_d(hyp + self.lastconv(x))


class FinalTileUpdate(nn.Module):
    """Final per-pixel update; emits [d, dx, dy] with the previous
    disparity broadcast-added to all three (reference quirk)."""

    def __init__(self, cin, hid_c=16, resblk_num=2):
        super().__init__()
        self.resblk_num = resblk_num
        self.conv1_0 = Conv(cin, hid_c, 1)
        self.conv1_1 = Conv(hid_c, hid_c, 3, padding=1)
        for i in range(resblk_num):
            setattr(self, f"resblock{i}", ResBlock(hid_c))
        self.lastconv = Conv(hid_c, 3, 3, padding=1)

    def forward(self, fea_l, hyp):
        x = lrelu(self.conv1_0(torch.cat([fea_l, hyp], -1)))
        x = lrelu(self.conv1_1(x))
        for i in range(self.resblk_num):
            x = getattr(self, f"resblock{i}")(x)
        return F.relu(hyp[..., 0:1] + self.lastconv(x))


class TilePropagation(nn.Module):
    def __init__(self):
        super().__init__()
        self.tile_update0 = TileUpdate0()
        for i in range(1, 5):
            setattr(self, f"tile_update{i}", TileUpdate())
        self.tile_update4_1 = PostTileUpdate(FEA_CH[2] + 16)
        self.tile_update5 = PostTileUpdate(FEA_CH[3] + 16)
        self.tile_update6 = FinalTileUpdate(FEA_CH[4] + 16)

    def forward(self, fea_l, fea_r, init_hyps):
        """The final disparity."""
        h = self.tile_update0(fea_l[0], fea_r[0], init_hyps[0])
        for i in range(1, 5):
            h = getattr(self, f"tile_update{i}")(fea_l[i], fea_r[i], init_hyps[i], h)
        r1x = self.tile_update4_1(fea_l[2], h)
        r05x = self.tile_update5(fea_l[3], hyp_upsample(r1x, 1.0))
        r025x = self.tile_update6(fea_l[4], hyp_upsample(r05x, 1.0))
        return r025x[..., 0:1]


class HITNetStereo(nn.Module):
    """Stereo wrapper: the per-frame outputs dict of the eval branch."""

    def __init__(self, max_disp: int = 320):
        super().__init__()
        self.backbone = HITUNet()
        self.tile_init = TileInitialization(max_disp)
        self.tile_update = TilePropagation()

    def forward(self, left_img, right_img):
        B = left_img.shape[0]
        fea = self.backbone(torch.cat([left_img, right_img], 0))
        fea_l = [f[:B].contiguous() for f in fea]
        fea_r = [f[B:].contiguous() for f in fea]
        _, init_hyps = self.tile_init(fea_l, fea_r)
        return {
            "pred_disp": self.tile_update(fea_l, fea_r, init_hyps),
            "left_feat": fea_l[2],
            "right_feat": fea_r[2],
            "left_img": left_img,
        }
