"""Inference CLI of the port.

    python -m codd_torch.tools.inference CONFIG [CHECKPOINT] [--eval [mode]]
        [--show-dir D] [--num-frames N] [--out-csv F] [--split val|test]
        [--img-dir D] [--r-img-dir D] [--bf16] [--device cuda|cpu]
        [--options k=v ...]

``--eval`` prints the metric tables (and writes ``--out-csv``);
``--show-dir`` saves per-sequence ``<name>.disp.pred.npz`` files.
``--bf16`` rounds the weights to bf16 and computes in f32 on f32 frames,
as ``inference.py --bf16`` does (flax promotes its bf16 parameters
against the f32 frames; ``tools/bench.py --bf16`` casts the frames too).
The model runs on the CUDA card unless ``--device cpu`` is given, and the
command fails without a card otherwise.  CHECKPOINT is a ``torch.save``d
``state_dict`` or a training checkpoint's ``ckpt_<step>`` directory (omit
it for seeded random weights).
"""

from __future__ import annotations

import argparse
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run CODD inference (PyTorch)")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="torch state_dict file or ckpt_<step> directory "
                        "(omit for random weights)")
    p.add_argument("--eval", nargs="?", const="default", default=None,
                   choices=["default", "disp_only", "motion_only"],
                   help="compute metric tables; the optional mode selects "
                        "the table set")
    p.add_argument("--show-dir", default=None)
    p.add_argument("--num-frames", type=int, default=None,
                   help="cap the number of sequences")
    p.add_argument("--out-csv", default=None)
    p.add_argument("--split", choices=["val", "test"], default="test")
    p.add_argument("--img-dir", default=None,
                   help="run on a raw stereo image directory (no split file)")
    p.add_argument("--r-img-dir", default=None)
    p.add_argument("--bf16", action="store_true",
                   help="weights rounded to bfloat16, f32 compute")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--options", nargs="+", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from ..apis.inference import run_inference
    from ..config import load_config
    from ..data.datasets import StereoVideoDataset, build_test_dataset
    from ..data.pipelines import build_test_pipeline
    from ..models.builder import build_estimator
    from ..train.checkpoint import restore_params
    from ..utils.precision import round_floats

    cfg = load_config(args.config, args.options)
    try:
        model = build_estimator(cfg["model"], device=args.device)
    except RuntimeError as e:
        print(f"error: {e} (or run with --device cpu)", file=sys.stderr)
        return 1
    if args.checkpoint:
        restore_params(args.checkpoint, model)
    if args.bf16:
        round_floats(model, torch.bfloat16)

    if args.img_dir:  # needs no data section; reads intrinsics if given
        dcfg = dict((cfg.get("data") or {}).get(args.split) or {})
        dataset = StereoVideoDataset.from_dirs(
            args.img_dir, args.r_img_dir,
            intrinsics=dcfg.get("intrinsics"), calib=dcfg.get("calib"),
            pipeline=build_test_pipeline(dcfg.get("pad_divisor", 64)))
    else:
        dcfg = dict(cfg["data"][args.split])
        if args.num_frames is not None:
            dcfg["num_samples"] = args.num_frames
        dataset = build_test_dataset(dcfg)

    metrics = run_inference(model, dataset,
                            evaluate=bool(args.eval) and not args.show_dir,
                            show_dir=args.show_dir, out_csv=args.out_csv,
                            metric=args.eval or "default")
    if metrics:
        print({k: round(v, 4) for k, v in metrics.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
