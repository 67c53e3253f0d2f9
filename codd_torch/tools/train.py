"""Training CLI of the port (counterpart of ``train.py``).

    python -m codd_torch.tools.train CONFIG [--work-dir D] [--load-from C]
        [--resume-from C] [--seed N] [--max-steps N] [--options k=v ...]
        [--debug-nans] [--device cuda|cpu]

``--resume-from`` takes a ``ckpt_<step>`` directory and restores the
params, Adam's state, the step and the data stream's position;
``--load-from`` takes one (or a plain ``state_dict`` file) and restores
the weights only.  ``--debug-nans`` turns on
``torch.autograd.set_detect_anomaly``.  The model trains on the CUDA card
unless ``--device cpu`` is given, and the command fails without a card
otherwise.  The work dir is ``--work-dir``, else ``runtime.work_dir``,
else ``work_dirs/<config name>``.

Under torchrun (``tools/train_dist.sh``: ``torchrun --nproc_per_node=N -m
codd_torch.tools.train CONFIG ...``) each process joins the group
(``parallel.mesh.init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo
with ``--device cpu``) and trains on its rows of a global batch of
``data.train.batch_size`` x N.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a CODD estimator (PyTorch)")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--load-from", default=None,
                   help="checkpoint whose weights initialise the model")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint to resume (params, optimizer, step)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap the training steps")
    p.add_argument("--options", nargs="+", default=None,
                   help="dot-path config overrides, e.g. model.motion.iters=4")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from ..apis.train import train_estimator
    from ..config import load_config
    from ..models.builder import _resolve_device
    from ..parallel import mesh

    try:
        device = _resolve_device(args.device)
        if mesh.launched_by_torchrun():
            device = mesh.init_distributed(args.device)
            print(f"rank {mesh.process_index()} of {mesh.process_count()} "
                  f"on {device}, backend {torch.distributed.get_backend()}",
                  flush=True)
    except RuntimeError as e:
        print(f"error: {e} (or run with --device cpu)", file=sys.stderr)
        return 1
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    cfg = load_config(args.config, args.options)
    if args.seed is not None:
        cfg.setdefault("runtime", {})["seed"] = args.seed
    work_dir = (args.work_dir or cfg.get("runtime", {}).get("work_dir")
                or osp.join("work_dirs",
                            osp.splitext(osp.basename(args.config))[0]))
    try:
        train_estimator(cfg, work_dir, load_from=args.load_from,
                        resume_from=args.resume_from,
                        max_steps=args.max_steps, device=device)
    finally:
        if mesh.process_group_active():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
