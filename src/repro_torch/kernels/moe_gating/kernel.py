"""CUDA MoE router gating kernel for Hopper: check, build and launch.

Replaces the Pallas TPU kernel `gating_topk`
(src/repro/kernels/moe_gating/kernel.py:41, body `_gating_kernel`,
wrapper `ops.fused_gating`).  The source is `csrc/moe_gating.cu`:

* one warp per token row, a few warps per block and enough blocks to
  spread the main path's rows over every SM (a grid-stride loop past
  that); lane l holds columns l, l + 32, ... in registers, loaded
  straight from device memory, with no shared memory;
* the row max and the top-k selection by warp reductions (`redux.sync`
  on order-preserving keys, NaN ranked above every number as
  `torch.argmax` ranks it), the sum by each lane's columns in index
  order and then an XOR butterfly over the lanes;
* bound by bytes (N·E·4 in, N·k·8 out), which at the router's sizes is
  below the launch's own cost;
* built with ``-fmad=false``, IEEE division and no fast math, summing in
  `ref.reference_gating`'s order, so gates and ids are bitwise the plain
  version's.

The TPU kernel's wrapper pads N to its block; this kernel takes any N.
`gating_topk.launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..nvcc import KernelLibrary

MAX_EXPERTS = 256
MAX_TOP_K = 8
WARPS = 4                       # token rows (warps) per block
# a grid of up to 16 blocks of WARPS warps per SM of the H100's 132, the
# 64 warps an SM can hold; more rows than that take the grid-stride loop
MAX_BLOCKS = 16 * 132


def _bind(lib):
    fn = lib.gating_topk_launch
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
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
    """(warps per block, blocks, columns per lane): a warp per token row,
    WARPS rows per block, at most MAX_BLOCKS blocks; lane l of a warp
    holds columns l, l + 32, ..., ceil(E / 32) of them."""
    return WARPS, min(-(-N // WARPS), MAX_BLOCKS), -(-E // 32)


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
    warps, blocks, cols = launch_shape(N, E)
    gate = torch.empty((N, top_k), dtype=torch.float32, device=device)
    idx = torch.empty((N, top_k), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = LIBRARY.library().gating_topk_launch(
            N, E, top_k, cols, warps, blocks, logits.data_ptr(),
            gate.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gating_topk: launch failed with CUDA error {err}")
    gating_topk.launches += 1
    return gate, idx


gating_topk.launches = 0
