"""Slab dispatch: how the port's chunked and sharded engines run their
slabs on their devices.

`build_kernel` validates a grid and builds the placement-score library
before any slab or chunk runs (`core.resilience`'s executor and the
sharded engines of `core.sweep` / `core.mc_sweep`); `run_slabs` runs
the slabs of one chunk on their devices; `devices_name` is what a
sharded result's `device` field records.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..device import device_name
from ..kernels.placement_score.kernel import LIBRARY as SCORE_LIBRARY


def build_kernel(axes, devices: Sequence[torch.device],
                 interpret: bool) -> None:
    """Validate `axes`, then build (or load) the placement-score library
    when a slab on one of `devices` will launch it, before any batch
    assembly, chunk or slab: a missing `nvcc` or a compile error
    raises here (never as a chunk quarantined as a crash)."""
    axes.validate()
    if not interpret and any(d.type == "cuda" for d in devices):
        SCORE_LIBRARY.library()


def run_slabs(jobs: Sequence[Tuple[torch.device, Callable]]) -> list:
    """Runs the slabs of one chunk, each (device, fn) of `jobs`, in turn
    on the calling thread, and returns their results in order; an error
    in a slab propagates.  A host thread per slab took 0.97–1.41× the
    wall in turn on one H100 and 2.3–4.0× on four (`PERF.md` §6): the
    slabs' host-bound loops contend for one GIL.  A process per
    card is the way to overlap them (ROADMAP queue 1)."""
    return [fn() for _, fn in jobs]


def devices_name(devices: Sequence[torch.device]) -> str:
    """What a sharded result's `device` field records: the distinct
    devices' names, in order."""
    return ", ".join(dict.fromkeys(device_name(d) for d in devices))
