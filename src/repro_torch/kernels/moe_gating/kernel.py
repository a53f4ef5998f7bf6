"""CUDA MoE router gating kernel for Hopper: check, build and launch.

Replaces the Pallas TPU kernel `gating_topk`
(src/repro/kernels/moe_gating/kernel.py:41, body `_gating_kernel`,
wrapper `ops.fused_gating`).  The source is `csrc/moe_gating.cu`:

* one thread per token row; a block stages its rows' logits in shared
  memory with coalesced loads (at an odd row stride, free of bank
  conflicts) and each thread then takes its row through the softmax, the
  k argmax passes and the renormalisation on chip;
* bound by bytes (N·E·4 in, N·k·8 out), which at the router's sizes is
  below the launch's own cost;
* built with ``-fmad=false``, IEEE division and no fast math, summing in
  `ref.reference_gating`'s order, so gates and ids are bitwise the plain
  version's.

The TPU kernel's wrapper pads N to its block; this kernel masks the
ragged last block itself.  `gating_topk.launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..nvcc import KernelLibrary

MAX_EXPERTS = 256
MAX_TOP_K = 8
_MAX_ROWS = 128                 # threads (token rows) per block
_SMEM_LIMIT = 48 * 1024         # dynamic shared memory without opting in


def _bind(lib):
    fn = lib.gating_topk_launch
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("moe_gating", "moe_gating.cu", ("-fmad=false",),
                        _bind)


def check_sizes(E: int, top_k: int) -> None:
    """Raise for an expert count or k the kernel does not take; there is no
    fallback to the plain version."""
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"gating_topk: {E} experts; the kernel takes 1 to "
                         f"{MAX_EXPERTS}")
    if not 1 <= top_k <= min(MAX_TOP_K, E):
        raise ValueError(f"gating_topk: top_k {top_k}; the kernel takes 1 to "
                         f"min({MAX_TOP_K}, E = {E})")


def launch_shape(N: int, E: int):
    """(rows per block, row stride in floats): the stride is odd, so a
    warp's threads reading one column of their rows hit distinct banks,
    and rows · stride floats fit the shared memory a launch may take."""
    stride = E | 1
    rows = _MAX_ROWS
    while rows * stride * 4 > _SMEM_LIMIT:
        rows //= 2
    return min(rows, 32 * -(-N // 32)), stride


def gating_topk(logits, top_k: int):
    """Launch the kernel on a CUDA tensor: logits [N, E] float32,
    contiguous.  Returns (gate [N, k] float32, idx [N, k] int32) on the
    current stream, without synchronising."""
    device = logits.device
    if device.type != "cuda":
        raise ValueError("gating_topk: the CUDA kernel takes CUDA tensors, "
                         f"got {device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"gating_topk: logits are {logits.dtype}; the kernel "
                        "takes float32 (ops.fused_gating casts narrower "
                        "types)")
    if logits.dim() != 2 or logits.shape[0] < 1:
        raise ValueError(f"gating_topk: logits of shape "
                         f"{tuple(logits.shape)}, expected [N >= 1, E]")
    if not logits.is_contiguous():
        raise ValueError("gating_topk: logits are not contiguous")
    N, E = logits.shape
    check_sizes(E, top_k)
    rows, stride = launch_shape(N, E)
    gate = torch.empty((N, top_k), dtype=torch.float32, device=device)
    idx = torch.empty((N, top_k), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = LIBRARY.library().gating_topk_launch(
            N, E, top_k, rows, stride, logits.data_ptr(), gate.data_ptr(),
            idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gating_topk: launch failed with CUDA error {err}")
    gating_topk.launches += 1
    return gate, idx


gating_topk.launches = 0
