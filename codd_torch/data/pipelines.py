"""Pipeline builders from config dicts (train/test recipes; the port's own
copy of ``codd_tpu/data/pipelines.py``), and the state of a training
pipeline's random generators, which a checkpoint keeps so that a resumed
run draws what the uninterrupted run would have drawn."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .transforms import (
    Normalize, Pad, PhotoMetricDistortion, RandomCrop, RandomOcclude,
    RandomShiftRotate, StereoPhotoMetricDistortion,
)

__all__ = ["build_train_pipeline", "build_test_pipeline",
           "pipeline_rng_state", "set_pipeline_rng_state"]


def build_train_pipeline(aug: Optional[Dict[str, Any]], seed: int = 0) -> List:
    """Training recipe: crop -> photometric -> normalize [-> pad] plus the
    optional right-image perturbations (the train_pipeline layouts of
    configs/datasets/*.py), all drawing from one ``default_rng(seed)``."""
    aug = aug or {}
    rng = np.random.default_rng(seed)
    pipe: List = []
    if aug.get("crop_size"):
        pipe.append(RandomCrop(tuple(aug["crop_size"]), rng=rng))
    if aug.get("stereo_photometric"):
        pipe.append(StereoPhotoMetricDistortion(rng=rng))
    elif aug.get("photometric", True):
        pipe.append(PhotoMetricDistortion(asym=bool(aug.get("asym", False)),
                                          rng=rng))
    if aug.get("shift_rotate"):
        pipe.append(RandomShiftRotate(rng=rng))
    if aug.get("occlude"):
        pipe.append(RandomOcclude(rng=rng))
    pipe.append(Normalize())
    if aug.get("pad_size"):
        pipe.append(Pad(size=tuple(aug["pad_size"])))
    elif aug.get("pad_divisor"):
        pipe.append(Pad(size_divisor=int(aug["pad_divisor"])))
    return pipe


def build_test_pipeline(pad_divisor: int = 64) -> List:
    return [Normalize(), Pad(size_divisor=pad_divisor)]


def pipeline_rng_state(pipeline: Sequence) -> Dict[str, Any]:
    """The state of every generator the transforms draw from: ``states``,
    one a distinct generator, and ``which``, a transform's index into it
    (-1 for a transform without ``rng``), since transforms may share a
    generator or stop sharing it (``PhotoMetricDistortion``)."""
    gens: List[np.random.Generator] = []
    which: List[int] = []
    for t in pipeline:
        g = getattr(t, "rng", None)
        if g is None:
            which.append(-1)
            continue
        j = next((i for i, h in enumerate(gens) if h is g), len(gens))
        if j == len(gens):
            gens.append(g)
        which.append(j)
    return {"which": which, "states": [g.bit_generator.state for g in gens]}


def set_pipeline_rng_state(pipeline: Sequence, state: Dict[str, Any]) -> None:
    """Give the transforms of ``pipeline`` (built as the one that
    ``state`` was taken from) generators in that state, shared as they
    were shared then."""
    if len(state["which"]) != len(pipeline):
        raise ValueError(f"pipeline of {len(pipeline)} transforms, state of "
                         f"{len(state['which'])}")
    gens = []
    for s in state["states"]:
        g = np.random.default_rng()
        g.bit_generator.state = s
        gens.append(g)
    for t, j in zip(pipeline, state["which"]):
        if (j < 0) != (getattr(t, "rng", None) is None):
            raise ValueError(f"{type(t).__name__}: state does not match the "
                             "pipeline")
        if j >= 0:
            t.rng = gens[j]
