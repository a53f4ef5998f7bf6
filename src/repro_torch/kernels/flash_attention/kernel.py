"""CUDA flash attention forward for Hopper: check, build and launch.

Replaces the Pallas TPU kernel `flash_attention_bhsd`
(src/repro/kernels/flash_attention/kernel.py:67, body `_flash_kernel`).
The source is `csrc/flash_attention.cu`, one kernel per type:

* bfloat16 (the scoring path): wgmma on the tensor cores with float32
  sums; per (64 query rows, K/V head, batch) a block whose warpgroups take
  two query heads of the GQA group, K/V loaded once for both by TMA in
  tiles of `ref.KEY_TILE` keys through a 2-stage mbarrier ring, whatever
  `block_k` is.  It rounds p to bf16 before P·V, which the reference
  kernel does not: `ref.rounded_flash_bhsd` is its plain version.
* float32: the CUDA cores, the online-softmax update once per `block_k`
  keys as in the TPU kernel, so it differs from `ref.reference_flash_bhsd`
  only in the order of the sums inside a tile.

Both are bound by operations, not bytes.  The TMA tensor maps are encoded
in the library's C launch function (`cuTensorMapEncodeTiled`, fetched
through `cudaGetDriverEntryPoint`: no `-lcuda`).  There is no backward
kernel: the TPU kernel has none.  `flash_attention_bhsd.launches` counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..nvcc import KernelLibrary

HEAD_DIMS = (16, 32, 64, 128)
MAX_BLOCK = 128
_MAX_GRID_YZ = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_int] * 10 + [ctypes.c_float] + \
        [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("flash_attention", "flash_attention.cu", (), _bind)


def check_shapes(hd: int, block_k: int, dtype) -> None:
    """Raise for a head dim, block or type the kernel does not take; there
    is no fallback to the plain version.  Shared memory is fixed by hd
    (at hd 128: float32 ~99 KB, two blocks per SM; bf16 ~161 KB, one), so
    every head dim taken fits."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention_bhsd: q, k and v are {dtype}; the "
                        "kernel takes float32 or bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bhsd: head dim {hd} is not "
                         f"supported; the kernel takes {HEAD_DIMS}")
    if not (8 <= block_k <= MAX_BLOCK and block_k & (block_k - 1) == 0):
        raise ValueError(f"flash_attention_bhsd: block_k {block_k} is not a "
                         f"power of two in [8, {MAX_BLOCK}]")


def flash_attention_bhsd(q, k, v, *, causal: bool = True, kv_len: int,
                         block_q: int = 128, block_k: int = 128):
    """Launch the kernel on CUDA tensors: q [B,H,Sq,hd], k and v
    [B,Hk,Skv,hd] in q's type (float32 or bfloat16), contiguous, Sq and
    Skv padded to `block_q` and `block_k`; keys at or past `kv_len` are
    masked.  Returns o [B,H,Sq,hd] in q's type, on the current stream,
    without synchronising."""
    device = q.device
    if device.type != "cuda":
        raise ValueError("flash_attention_bhsd: the CUDA kernel takes CUDA "
                         f"tensors, got {device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention_bhsd: q, k and v must be "
                         "[B, H, S, hd]")
    B, H, Sq, hd = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    check_shapes(hd, block_k, q.dtype)
    if Hk < 1 or H % Hk or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention_bhsd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair")
    if Sq % block_q or Skv % block_k:
        raise ValueError(f"flash_attention_bhsd: Sq {Sq} and Skv {Skv} must "
                         f"be multiples of the blocks {block_q}, {block_k}; "
                         "ops.flash_attention pads them")
    if not (1 <= B <= _MAX_GRID_YZ and 1 <= H <= _MAX_GRID_YZ):
        raise ValueError(f"flash_attention_bhsd: unsupported batch {B} or "
                         f"head count {H}")
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"flash_attention_bhsd: kv_len {kv_len} outside "
                         f"[1, {Skv}]")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != device or x.dtype != q.dtype:
            raise ValueError(f"flash_attention_bhsd: `{name}` is {x.dtype} "
                             f"on {x.device}, expected {q.dtype} on {device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bhsd: `{name}` is not "
                             "contiguous and 16-byte aligned")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention_bhsd: v {tuple(v.shape)} is not "
                         f"k's shape {tuple(k.shape)}")
    o = torch.empty_like(q)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = LIBRARY.library().flash_attention_launch(
            _DTYPES[q.dtype], B, H, Hk, Sq, Skv, hd, kv_len, int(causal),
            block_k, 1.0 / hd ** 0.5, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bhsd: launch failed with CUDA "
                           f"error {err}")
    flash_attention_bhsd.launches += 1
    return o


flash_attention_bhsd.launches = 0
