"""CUDA placement-score kernel for Hopper: build, bind and launch.

Replaces the Pallas TPU kernel `placement_score`
(src/repro/kernels/placement_score/kernel.py:73, body `_score_kernel`,
wrapper `ops.score_rows`).  The source is `csrc/placement_score.cu`:

* one thread per (configuration, row), one launch per event step for the
  whole sweep batch; the block gathers its rows' feed line-up loads
  itself, which fuses the gather `repro`'s wrapper left to XLA;
* bound by bytes (~40 B of row data and 5 B of output per row, the
  [N, X] line-up arrays stay in L2); the design reads each row once,
  coalesced, and writes nothing else;
* built with ``-fmad=false``, IEEE division and no fast math, so it
  agrees with `ref.reference_score` bitwise on `feas` and on the score at
  feasible rows.

The library is compiled with `nvcc` at first use (see `..nvcc`) and
loaded with `ctypes`.  `placement_score.launches` counts launches, under
a lock, so that launches from several host threads count exactly.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..nvcc import KernelLibrary

_MAX_CONFIGS = 65535          # grid.y limit
_COUNT_LOCK = threading.Lock()


def _bind(lib):
    fn = lib.placement_score_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 14
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("placement_score", "placement_score.cu",
                        ("-fmad=false",), _bind)


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"placement_score: `{name}` is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"placement_score: `{name}` is {x.dtype}, "
                        f"expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"placement_score: `{name}` has shape "
                         f"{tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"placement_score: `{name}` is not contiguous")


def placement_score(row_feeds, row_nfeeds, row_cap, row_load, lineup_ha,
                    lineup_tot, lineup_cap, p_dep, ha_frac, is_ha, is_block):
    """Launch the kernel on CUDA tensors (shapes as in
    `ref.reference_score`).  Returns (feas [N, R] bool, score [N, R]
    float32) on the current stream, without synchronising."""
    device = row_feeds.device
    if device.type != "cuda":
        raise ValueError("placement_score: the CUDA kernel takes CUDA "
                         f"tensors, got {device}")
    N, R, F = row_feeds.shape
    X = lineup_cap.shape[-1]
    if F != 4:
        raise ValueError(f"placement_score: row_feeds has {F} feeds per "
                         "row, expected 4 (MAX_FEEDS)")
    if not 1 <= N <= _MAX_CONFIGS or R < 1 or X < 1:
        raise ValueError(f"placement_score: unsupported sizes N={N}, R={R}, "
                         f"X={X}")
    f32, i32 = torch.float32, torch.int32
    for name, x, dt, shape in (
            ("row_feeds", row_feeds, i32, (N, R, 4)),
            ("row_nfeeds", row_nfeeds, i32, (N, R)),
            ("row_cap", row_cap, f32, (N, R, 4)),
            ("row_load", row_load, f32, (N, R, 4)),
            ("lineup_ha", lineup_ha, f32, (N, X)),
            ("lineup_tot", lineup_tot, f32, (N, X)),
            ("lineup_cap", lineup_cap, f32, (N, X)),
            ("p_dep", p_dep, f32, (N,)),
            ("ha_frac", ha_frac, f32, (N,)),
            ("is_ha", is_ha, torch.bool, (N,)),
            ("is_block", is_block, torch.bool, (N,))):
        _check(name, x, dt, shape, device)
    feas = torch.empty((N, R), dtype=torch.bool, device=device)
    score = torch.empty((N, R), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = LIBRARY.library().placement_score_launch(
            N, R, X, row_feeds.data_ptr(), row_nfeeds.data_ptr(),
            row_cap.data_ptr(), row_load.data_ptr(), lineup_ha.data_ptr(),
            lineup_tot.data_ptr(), lineup_cap.data_ptr(), p_dep.data_ptr(),
            ha_frac.data_ptr(), is_ha.data_ptr(), is_block.data_ptr(),
            feas.data_ptr(), score.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"placement_score: launch failed with CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        placement_score.launches += 1
    return feas, score


placement_score.launches = 0
