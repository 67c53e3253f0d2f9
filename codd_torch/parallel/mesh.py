"""One process a device, joined by ``torch.distributed`` (counterpart of
``codd_tpu/parallel/mesh.py``, whose name the file keeps).

``codd_tpu`` trains one program over a 1-D ``data`` mesh: each process
feeds its shard of the batch, the parameters are replicated, and ``jit``
inserts the gradient all-reduce; multi-host runs call
``jax.distributed.initialize`` first.  The port runs one process a
device, started by ``torchrun`` (``tools/train_dist.sh``), and does by
hand what ``jit`` does there:

* ``init_distributed`` joins the group that torchrun's ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` describe: NCCL for the
  card (one rank a GPU; NCCL refuses two ranks on one), gloo for the CPU,
  with a finite timeout, and a gloo group beside an NCCL one for the
  collectives on CPU tensors (the rows of an evaluation, the data
  stream's state);
* ``all_reduce_grads`` sums the gradients over the processes in one flat
  f32 buffer, in the order of the parameters' names;
* ``global_count``: ``codd_tpu``'s losses are sums over counts (of valid
  pixels, of elements) over the *global* batch.  Within ``counting(...)``
  each count a loss takes is recorded, summed over the processes in one
  all-reduce, and given back when the loss is taken again, so that each
  process's loss is its rows' share of the global loss, their sum is the
  global loss and the summed gradients are its gradient
  (``train/trainer.py``).  Outside it a count is itself: one process
  computes what it always did;
* ``broadcast_state`` gives every process rank 0's parameters and buffers;
* ``gather_rows`` / ``gather_objects`` collect arrays / objects from every
  process, on the CPU.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_distributed", "launched_by_torchrun", "process_group_active",
           "process_index",
           "process_count", "all_reduce_grads", "all_reduce_sum",
           "broadcast_state", "gather_rows", "gather_objects", "counting",
           "global_count", "global_mean", "TIMEOUT"]

# a collective that waits longer than this fails the run instead of
# hanging it
TIMEOUT = datetime.timedelta(minutes=10)
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")
_CPU_GROUP: Optional[Any] = None


def launched_by_torchrun() -> bool:
    """Whether torchrun (``torch.distributed.run``) started this process."""
    return all(v in os.environ for v in _TORCHRUN_VARS)


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this process's device: ``cuda:LOCAL_RANK``, or the CPU for
    ``device="cpu"``.  The backend is NCCL for the card and gloo for the
    CPU; ``backend="gloo"`` on the card runs several ranks on one GPU
    (NCCL refuses that; a check on a one-card machine).  Raises where the
    environment is incomplete or the group does not form within
    ``timeout``: a process never goes on alone."""
    global _CPU_GROUP
    missing = [v for v in _TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: {missing} not set; start the "
                           "processes with torchrun")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA is not available")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)
    if dist.get_world_size() != world or dist.get_rank() != rank:
        raise RuntimeError(f"init_distributed: joined as {dist.get_rank()} "
                           f"of {dist.get_world_size()}, expected {rank} of "
                           f"{world}")
    _CPU_GROUP = (dist.new_group(backend="gloo", timeout=timeout)
                  if dist.get_backend() != "gloo" else None)
    return dev


def process_group_active() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if process_group_active() else 0


def process_count() -> int:
    """The number of processes; 1 without a group."""
    return dist.get_world_size() if process_group_active() else 1


def all_reduce_grads(params: Dict[str, torch.nn.Parameter]
                     ) -> Dict[str, torch.Tensor]:
    """Every trainable parameter's ``.grad`` (zero where it has none)
    summed over the processes: one all-reduce of one flat f32 buffer laid
    out in the order of ``params``' names, the same in every process.
    Returns name -> summed gradient, in that order."""
    names = [k for k, p in params.items() if p.requires_grad]
    flat = torch.cat([(params[k].grad if params[k].grad is not None
                       else torch.zeros_like(params[k])).reshape(-1).float()
                      for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, i = {}, 0
    for k in names:
        n = params[k].numel()
        out[k] = flat[i:i + n].view(params[k].shape).to(params[k].dtype)
        i += n
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to rank 0's, in
    place (after a build or a load, so that every process starts alike)."""
    for t in module.state_dict().values():
        dist.broadcast(t, src=0)


def gather_rows(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` (the same shape everywhere), stacked by
    rank: (world, *arr.shape), through CPU tensors."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=_CPU_GROUP)
    return np.stack([o.numpy() for o in out])


def gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable ``obj``, by rank, through the CPU."""
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj, group=_CPU_GROUP)
    return out


# ---------------------------------------------------------------------------
# the losses' counts over the global batch
# ---------------------------------------------------------------------------

class _Counts:
    def __init__(self, given: Optional[torch.Tensor]):
        self.given = given
        self.seen: List[torch.Tensor] = []

    def take(self, c: torch.Tensor) -> torch.Tensor:
        i = len(self.seen)
        self.seen.append(c.detach().reshape(()).double())
        if self.given is None:
            return c
        if i >= self.given.numel():
            raise RuntimeError("global_count: the loss took more counts than "
                               "were summed")
        return self.given[i].to(device=c.device, dtype=c.dtype)


_COUNTS: Optional[_Counts] = None


@contextlib.contextmanager
def counting(given: Optional[torch.Tensor] = None):
    """Within the block ``global_count`` records each count a loss takes
    (``given`` None; the block yields the record, whose ``seen`` lists
    them in order) or hands back ``given``'s entries in that order, the
    counts summed over the processes."""
    global _COUNTS
    prev, _COUNTS = _COUNTS, _Counts(given)
    try:
        yield _COUNTS
    finally:
        _COUNTS = prev


def global_count(c) -> torch.Tensor:
    """A loss term's count (a gradient-free tensor): itself outside
    ``counting``; within it recorded, or replaced by its sum over the
    processes."""
    if _COUNTS is None:
        return c
    return _COUNTS.take(torch.as_tensor(c))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)``; within ``counting`` the sum of ``x`` over the
    number of elements summed over the processes."""
    if _COUNTS is None:
        return torch.mean(x)
    return torch.sum(x) / global_count(torch.tensor(
        float(x.numel()), dtype=x.dtype, device=x.device))
