"""Reference CODD checkpoints -> the port's ``state_dict``.

The reference publishes pretrained torch checkpoints of its estimator
(CODD's README).  ``codd_tpu/utils/port_weights.py`` converts their
tensors into flax layouts; the port's modules keep torch's layouts and
carry the flax module names (``utils/params.py``), so here the conversion
is a rename and every tensor passes through as it is:

* Conv2d / ConvTranspose2d ``weight`` and ``bias`` -> ``<path>.weight`` /
  ``<path>.bias`` (torch's (O, I, kh, kw) and (I, O, kh, kw) layouts are
  the port's);
* BatchNorm ``weight``, ``bias``, ``running_mean``, ``running_var`` ->
  the port's FrozenBatchNorm of the same names (``num_batches_tracked``
  is ignored).

The result equals ``utils/params.py:torch_state_dict_from_jax`` applied to
``codd_tpu``'s ``port_codd_checkpoint`` in bits.  The name tables are the
same ``(reference prefix, path[, kind])`` tables, built by the same
generators:

  HITNET_MAP  - stereo (reference model/stereo/hitnet/*)
  RAFT3D_MAP  - motion (reference model/motion/raft3d/raft3d.py:141-186,
                blocks/{extractor,gru}.py; mmseg HRNet cnet per
                configs/models/codd.py:44-74)
  FUSION_MAP  - fusion (reference model/fusion/fusion.py:42-146)

A reference checkpoint loads into the port as a plain ``state_dict`` file:

    sd = torch.load(path, map_location="cpu", weights_only=False)
    torch.save(port_codd_checkpoint(sd)["state_dict"], out)

then ``out`` goes to ``--load-from`` or to the inference CLI's checkpoint
argument.  An mmcv checkpoint's ``meta`` entry holds Python objects that
``weights_only=True`` refuses; load only files you trust that way.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["port_state_dict", "port_codd_checkpoint",
           "HITNET_MAP", "RAFT3D_MAP", "FUSION_MAP", "SUBMODULES"]


# ---------------------------------------------------------------------------
# stereo: HITNetMF
# ---------------------------------------------------------------------------


def _hitnet_backbone_map():
    m = [("backbone.conv1.0", "backbone/conv1/conv")]
    for ch in ["down1", "down2", "down3"]:
        m += [(f"backbone.{ch}.0", f"backbone/{ch}/c0/conv"),
              (f"backbone.{ch}.2", f"backbone/{ch}/c1/conv")]
    # down4: Sequential(conv_down, conv, lrelu, conv, lrelu)
    m += [("backbone.down4.0.0", "backbone/down4_0/c0/conv"),
          ("backbone.down4.0.2", "backbone/down4_0/c1/conv"),
          ("backbone.down4.1", "backbone/down4_1/conv"),
          ("backbone.down4.3", "backbone/down4_2/conv")]
    for up in ["up4", "up3", "up2", "up1"]:
        m += [(f"backbone.{up}.0", f"backbone/{up}/conv", "deconv")]
    for mg in ["merge4", "merge3", "merge2", "merge1"]:
        m += [(f"backbone.{mg}.0", f"backbone/{mg}/c0/conv"),
              (f"backbone.{mg}.2", f"backbone/{mg}/c1/conv"),
              (f"backbone.{mg}.4", f"backbone/{mg}/c2/conv")]
    return m


def _hitnet_init_map():
    m = []
    for lvl in ["1x", "2x", "4x", "8x", "16x"]:
        m += [(f"tile_init.tile_conv{lvl}.0", f"tile_init/tile_conv{lvl}/c0",
               "shared"),
              (f"tile_init.tile_conv{lvl}.2",
               f"tile_init/tile_conv{lvl}/c1/conv")]
        m += [(f"tile_init.tile_fea_dscrpt{lvl}.0",
               f"tile_init/tile_fea_dscrpt{lvl}/conv")]
    return m


def _resblock(prefix_t, path):
    return [(f"{prefix_t}.conv1.0.0", f"{path}/conv1/conv"),
            (f"{prefix_t}.conv2.0", f"{path}/conv2/conv")]


def _hitnet_prop_map():
    m = []
    # TileUpdate0
    m += [("tile_update.tile_update0.decrease.0",
           "tile_update/tile_update0/cv/decrease/conv"),
          ("tile_update.tile_update0.conv0.0",
           "tile_update/tile_update0/conv0/conv"),
          ("tile_update.tile_update0.lastconv",
           "tile_update/tile_update0/lastconv/conv")]
    for i in (0, 1):
        m += _resblock(f"tile_update.tile_update0.resblock{i}.0",
                       f"tile_update/tile_update0/resblock{i}")
    # TileUpdate 1..4
    for k in (1, 2, 3, 4):
        base_t = f"tile_update.tile_update{k}"
        base_p = f"tile_update/tile_update{k}"
        m += [(f"{base_t}.decrease.0", f"{base_p}/cv/decrease/conv"),
              (f"{base_t}.conv0.0", f"{base_p}/conv0/conv"),
              (f"{base_t}.lastconv", f"{base_p}/lastconv/conv")]
        for i in (0, 1):
            m += _resblock(f"{base_t}.resblock{i}.0", f"{base_p}/resblock{i}")
    # PostTileUpdate 4_1, 5 and FinalTileUpdate 6
    for name, nblocks in (("tile_update4_1", 4), ("tile_update5", 4),
                          ("tile_update6", 2)):
        base_t = f"tile_update.{name}"
        base_p = f"tile_update/{name}"
        m += [(f"{base_t}.conv1.0", f"{base_p}/conv1_0/conv"),
              (f"{base_t}.conv1.2", f"{base_p}/conv1_1/conv"),
              (f"{base_t}.lastconv", f"{base_p}/lastconv/conv")]
        for i in range(nblocks):
            m += _resblock(f"{base_t}.resblocks.{i}.0",
                           f"{base_p}/resblock{i}")
    return m


HITNET_MAP = _hitnet_backbone_map() + _hitnet_init_map() + _hitnet_prop_map()


# ---------------------------------------------------------------------------
# motion: RAFT3D (fnet + mmseg-HRNet cnet + ResizeConcatConv + update block)
# ---------------------------------------------------------------------------


def _fnet_map():
    """BasicEncoder, instance-norm variant (blocks/extractor.py:119-199):
    instance norm has no parameters, so only convs map."""
    m = [("fnet.conv1", "fnet/conv1/conv"),
         ("fnet.conv2", "fnet/conv2/conv")]
    for ln in ("layer1", "layer2", "layer3"):
        for b in (0, 1):
            t = f"fnet.{ln}.{b}"
            p = f"fnet/{ln}_{b}"
            m += [(f"{t}.conv1", f"{p}/conv1/conv"),
                  (f"{t}.conv2", f"{p}/conv2/conv")]
            if b == 0 and ln != "layer1":  # stride-2 blocks have downsample
                m += [(f"{t}.downsample.0", f"{p}/downsample/conv")]
    return m


def _convbn(t_conv, t_bn, base):
    """mmcv ConvModule-style conv + BN pair -> _ConvBN {conv/conv, bn}."""
    return [(t_conv, f"{base}/conv/conv"), (t_bn, f"{base}/bn", "bn")]


def _hrnet_map(tp="cnet.0", pp="cnet"):
    """mmseg HRNet-w18-small state-dict names (conv1/bn1 stem, layer1
    Bottlenecks, transition{s}, stage{s}.{m} with branches.{i}.{b}
    BasicBlocks and fuse_layers.{i}.{j})."""
    m = []
    m += _convbn(f"{tp}.conv1", f"{tp}.bn1", f"{pp}/stem1")
    m += _convbn(f"{tp}.conv2", f"{tp}.bn2", f"{pp}/stem2")
    # layer1: 2 bottlenecks, downsample on block 0 (64 -> 256)
    for b in (0, 1):
        t = f"{tp}.layer1.{b}"
        p = f"{pp}/layer1_{b}"
        for ci in (1, 2, 3):
            m += _convbn(f"{t}.conv{ci}", f"{t}.bn{ci}", f"{p}/c{ci}")
        if b == 0:
            m += _convbn(f"{t}.downsample.0", f"{t}.downsample.1", f"{p}/down")
    # transitions: (stage idx, branch idx, has nested Sequential)
    for s, i, nested in ((1, 0, False), (1, 1, True), (2, 2, True),
                         (3, 3, True)):
        t = f"{tp}.transition{s}.{i}" + (".0" if nested else "")
        m += _convbn(f"{t}.0", f"{t}.1", f"{pp}/trans{s}_{i}")
    # stages 2..4: {stage: (modules, branches)}
    stage_cfg = {2: (1, 2), 3: (3, 3), 4: (2, 4)}
    for s, (n_mod, n_br) in stage_cfg.items():
        for mm in range(n_mod):
            t = f"{tp}.stage{s}.{mm}"
            p = f"{pp}/stage{s}_m{mm}"
            for i in range(n_br):
                for b in (0, 1):
                    tb = f"{t}.branches.{i}.{b}"
                    pb = f"{p}/branch{i}_blk{b}"
                    m += _convbn(f"{tb}.conv1", f"{tb}.bn1", f"{pb}/c1")
                    m += _convbn(f"{tb}.conv2", f"{tb}.bn2", f"{pb}/c2")
            for i in range(n_br):
                for j in range(n_br):
                    if j > i:  # 1x1 conv + bn (+ upsample, no params)
                        tf = f"{t}.fuse_layers.{i}.{j}"
                        m += _convbn(f"{tf}.0", f"{tf}.1", f"{p}/fuse{i}_{j}")
                    elif j < i:  # chain of stride-2 conv + bn
                        for st in range(i - j):
                            tf = f"{t}.fuse_layers.{i}.{j}.{st}"
                            m += _convbn(f"{tf}.0", f"{tf}.1",
                                         f"{p}/fuse{i}_{j}_{st}")
    return m


def _update_block_map():
    tp, pp = "update_block", "gn_iter/update_block"
    m = [(f"{tp}.corr_enc.0", f"{pp}/corr_enc0/conv"),
         (f"{tp}.corr_enc.2", f"{pp}/corr_enc1/conv"),
         (f"{tp}.corr_enc.4", f"{pp}/corr_enc2/conv"),
         (f"{tp}.flow_enc.0", f"{pp}/flow_enc0/conv"),
         (f"{tp}.flow_enc.2", f"{pp}/flow_enc1/conv")]
    for g in ("convz1", "convz2", "convr1", "convr2", "convq1", "convq2"):
        m += [(f"{tp}.gru.{g}", f"{pp}/gru/{g}/conv")]
    for head in ("ae", "delta", "weight", "mask"):
        m += [(f"{tp}.{head}.0", f"{pp}/{head}0/conv"),
              (f"{tp}.{head}.2", f"{pp}/{head}1/conv")]
    return m


RAFT3D_MAP = (_fnet_map() + _hrnet_map()
              + [("cnet.1.convs.0", "cnet_out/conv/conv")]
              + _update_block_map())


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------


FUSION_MAP = [
    ("key_layer.0", "key0/conv"),
    ("key_layer.2.conv1.0", "key_block/conv1/conv"),
    ("key_layer.2.conv2", "key_block/conv2/conv"),
    ("key_layer.4", "key1/conv"),
    ("conv_corr.0", "conv_corr0/conv"),
    ("conv_corr.2", "conv_corr1/conv"),
    ("conv_disp.0", "conv_disp0/conv"),
    ("conv_disp.2", "conv_disp1/conv"),
    ("motion_conv.0", "motion_conv/conv"),
    ("weight_head.0", "weight_head0/conv"),
    ("weight_head.1", "weight_head1/conv"),
    ("forget_head.0", "forget_head0/conv"),
    ("forget_head.1", "forget_head1/conv"),
    ("forget_head.2", "forget_head2/conv"),
    ("residual_conv.0", "residual_conv/conv"),
]

# (reference prefix, table, the port's module) of each submodule
SUBMODULES = (("stereo", HITNET_MAP, "stereo"),
              ("motion.raft3d", RAFT3D_MAP, "motion.raft3d"),
              ("fusion", FUSION_MAP, "fusion"))

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


# ---------------------------------------------------------------------------
# mechanics
# ---------------------------------------------------------------------------


def _tensor(v) -> torch.Tensor:
    """A reference tensor as the port keeps it: on the CPU, in f32."""
    t = v.detach() if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.to("cpu", torch.float32).contiguous()


def port_state_dict(state_dict: Mapping[str, Any], name_map,
                    dest_prefix: str = "stereo"
                    ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Apply a ``(reference prefix, path[, kind])`` table to a reference
    state_dict -> (the port's entries under ``dest_prefix``, the reference
    prefixes that the state_dict lacks).

    kinds: conv (default), deconv and shared (``weight`` and an optional
    ``bias``), bn (``weight``, ``bias``, ``running_mean``,
    ``running_var``).  A conv without a ``weight``, or a bn without a
    ``weight`` or a ``running_mean``, is missing."""
    out: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for entry in name_map:
        t_prefix, path = entry[0], entry[1]
        kind = entry[2] if len(entry) > 2 else "conv"
        needs = ("weight", "running_mean") if kind == "bn" else ("weight",)
        if any(state_dict.get(f"{t_prefix}.{k}") is None for k in needs):
            missing.append(t_prefix)
            continue
        base = ".".join(p for p in (dest_prefix, path.replace("/", "."))
                        if p)
        for leaf in (_BN_LEAVES if kind == "bn" else ("weight", "bias")):
            v = state_dict.get(f"{t_prefix}.{leaf}")
            if v is not None:
                out[f"{base}.{leaf}"] = _tensor(v)
    return out, missing


def _sub_dict(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def port_codd_checkpoint(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference estimator state_dict (or a checkpoint holding one under
    ``"state_dict"``) -> {"state_dict": the port's state_dict, "missing":
    [reference prefixes the file lacks], "hit_loss_kernels": {"convx",
    "convy"}}.

    The state_dict loads strictly into the port's CODD built from the same
    config; a stereo-only or a stereo + motion checkpoint into the model
    without the parts it lacks.  ``hit_loss_kernels`` (present where the
    file holds them) are the HITLoss plane-fit kernels as 9x9 numpy arrays
    (trainable in the reference, model/losses/hitnet.py:99-104: a
    checkpoint may carry drifted values)."""
    if "state_dict" in state_dict and not hasattr(
            state_dict["state_dict"], "shape"):
        state_dict = state_dict["state_dict"]
    sd: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for sub_prefix, name_map, dest in SUBMODULES:
        part, lost = port_state_dict(_sub_dict(state_dict, sub_prefix),
                                     name_map, dest)
        sd.update(part)
        missing.extend(f"{sub_prefix}.{k}" for k in lost)
    out: Dict[str, Any] = {"state_dict": sd, "missing": missing}
    kx = state_dict.get("stereo.loss.convx.weight")
    ky = state_dict.get("stereo.loss.convy.weight")
    if kx is not None and ky is not None:
        # conv weight (1, 1, 9, 9) -> the (9, 9) cross-correlation kernel
        out["hit_loss_kernels"] = {
            k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v))[0, 0] for k, v in (("convx", kx),
                                                       ("convy", ky))}
    return out
