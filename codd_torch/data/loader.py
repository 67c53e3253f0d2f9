"""Host-side batching, threaded prefetch, and the move to the device (the
port's own copy of ``codd_tpu/data/loader.py``, with ``_device_batch`` of
``codd_tpu/apis/train.py`` as ``to_device``).

Batches are drawn in order by one worker thread, not by DataLoader
worker processes: one thread drawing in order keeps the augmentation
draws equal to ``codd_tpu``'s.  Decoding releases the GIL (``zlib`` and
the native PNG codec), numpy's augmentations mostly do not.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

__all__ = ["batch_iterator", "Prefetcher", "collate", "to_device"]


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack clip samples into batch arrays; model-facing key names."""
    out: Dict[str, Any] = {}
    keys = samples[0].keys()
    rename = {"imgs": "l_img", "r_imgs": "r_img"}
    for k in keys:
        if k == "meta":
            out["meta"] = [s["meta"] for s in samples]
            intr = samples[0]["meta"].get("intrinsics")
            if intr is not None:
                out["intrinsics"] = np.stack(
                    [np.asarray(s["meta"]["intrinsics"], np.float32)
                     for s in samples])
        else:
            out[rename.get(k, k)] = np.stack([s[k] for s in samples])
    return out


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    host_id: int = 0,
    num_hosts: int = 1,
    epochs: Optional[int] = None,
    skip: int = 0,
) -> Iterator[Dict[str, Any]]:
    """Yield collated batches; indices are host-sharded then batched.
    ``skip`` passes over that many batches of the stream without loading
    them (a resumed run; the epochs' permutations are drawn as before)."""
    epoch = 0
    rng = np.random.default_rng(seed)
    while epochs is None or epoch < epochs:
        idx = np.arange(len(dataset))
        if shuffle:
            idx = rng.permutation(idx)
        idx = idx[host_id::num_hosts]
        stop = len(idx) - (len(idx) % batch_size if drop_last else 0)
        if stop <= 0:
            raise ValueError(f"batch_iterator: {len(idx)} samples on host "
                             f"{host_id} make no batch of {batch_size}")
        for i in range(0, stop, batch_size):
            chunk = idx[i:i + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            if skip:
                skip -= 1
                continue
            yield collate([dataset[int(j)] for j in chunk])
        epoch += 1


PREFETCH_DEPTH = 2


class Prefetcher:
    """One background thread drawing ``it`` in order into a queue of
    ``PREFETCH_DEPTH`` items; an error of the iterator is raised in the
    consumer.  ``close()`` stops the thread."""

    def __init__(self, it: Iterator):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = next(self._it)
            except StopIteration:
                self._put(self._done)
                return
            except Exception as e:  # surface loader errors to the consumer
                self._put(e)
                return
            self._put(item)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated batch -> tensors on ``device``: ``meta`` dropped,
    floating arrays as float32 (as ``jnp.asarray`` makes them), and for a
    CUDA device a copy into pinned host memory, then a ``non_blocking``
    copy on the card."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k == "meta":
            continue
        v = np.asarray(v)
        if v.dtype.kind == "f" and v.dtype != np.float32:
            v = v.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out
