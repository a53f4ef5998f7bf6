"""CUDA SSD intra-chunk kernels for Hopper: check, build and launch.

Replaces the Pallas TPU kernel `ssd_intra_chunk`
(src/repro/kernels/ssd_scan/kernel.py:52, body `_ssd_kernel`, wrapper
`ops.ssd_scan`).  The source is `csrc/ssd_scan.cu`; both kernels return
the chunk-local prefix sums beside y, h and a, and take the prefix sum
serially in the plain versions' order.  Which one runs is fixed by dtype
and shape (`uses_tensor_cores`):

* bfloat16 with hd in {16, 32, 64, 128}, st in {16, 32, 64, 128, 256}
  and tiles that fit in shared memory (the Mamba2 serving path): wgmma
  on the tensor cores, tiles by TMA, one block per (5 heads, chunk,
  batch).  W = (C·B)·decay and tail·xdt are split into bf16 hi and lo
  parts whose products add in float32; it is held to
  `ref.split_intra_chunk`, which makes the same roundings, within a
  derived bound (`chip_smoke.py`);
* float32, and bfloat16 at every other shape `check_shapes` admits: the
  CUDA cores, one block of 256 threads per (batch, chunk, head), built
  with ``-fmad=false`` and every sum in a fixed order, so it agrees with
  `ref.reference_intra_chunk` bitwise.

`ssd_intra_chunk.launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..nvcc import KernelLibrary

THREADS = 256
MAX_CHUNK = 256
MAX_PER_THREAD = 64
MAX_SMEM = 232448          # H100: 227 KiB of shared memory per block
HEADS_PER_BLOCK = 5        # tensor-core kernel (`tc::kHeads`)
_MAX_GRID_YZ = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.ssd_intra_chunk_launch
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    fn = lib.ssd_intra_chunk_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    fn = lib.ssd_intra_chunk_uses_tensor_cores
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("ssd_scan", "ssd_scan.cu", ("-fmad=false",), _bind)


def smem_bytes(Q: int, hd: int, st: int, elem: int) -> int:
    """Shared memory of one CUDA-core block (mirrors `smem_bytes` in the
    source): prefix sums, tails and the padded 32-key W tile in float32,
    then xdt and the padded B and C rows in the input type."""
    return Q * (2 + 33) * 4 + Q * (hd + 2 * (st + 4 // elem)) * elem


def tc_smem_bytes(Q: int, hd: int, st: int, stages: int) -> int:
    """Shared memory of one tensor-core block (mirrors `tc::Smem`): the C
    and B tiles and `stages` xdt tiles in bf16 over the chunk padded to
    a multiple of 64, prefix sums and tails of 5 heads, the mbarriers
    and 1024 bytes to align the tiles."""
    Qp = -(-Q // 64) * 64
    return (4 * Qp * st + stages * 2 * Qp * hd + 2 * HEADS_PER_BLOCK * Qp * 4
            + 8 * (1 + 2 * HEADS_PER_BLOCK) + 1024)


def uses_tensor_cores(Q: int, hd: int, st: int, dtype) -> bool:
    """Whether inputs of this type and these sizes run on the tensor-core
    kernel (mirrors `tc_takes` in the source); the CUDA-core kernel takes
    the rest."""
    return (dtype == torch.bfloat16 and hd in (16, 32, 64, 128)
            and st in (16, 32, 64, 128, 256) and 1 <= Q <= MAX_CHUNK
            and tc_smem_bytes(Q, hd, st, 1) <= MAX_SMEM)


def check_shapes(Q: int, hd: int, st: int, dtype) -> None:
    """Raise `ValueError` for a chunk, head or state size the kernels do
    not take; there is no fallback to the plain version."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_intra_chunk: xdt, b and c are {dtype}; the "
                        "kernel takes float32 or bfloat16")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"ssd_intra_chunk: chunk {Q} is not supported; the "
                         f"kernel takes 1 <= chunk <= {MAX_CHUNK}")
    for name, n in (("ssm_headdim", hd), ("ssm_state", st)):
        if n < 1 or THREADS % n:
            raise ValueError(f"ssd_intra_chunk: {name} {n} must divide "
                             f"{THREADS}")
    per_thread = -(-max(Q * hd, hd * st) // THREADS)
    if per_thread > MAX_PER_THREAD:
        raise ValueError(
            f"ssd_intra_chunk: chunk {Q}, head dim {hd}, state {st} give "
            f"{per_thread} outputs per thread, above {MAX_PER_THREAD}")
    smem = smem_bytes(Q, hd, st, dtype.itemsize)
    if smem > MAX_SMEM:
        raise ValueError(
            f"ssd_intra_chunk: chunk {Q}, head dim {hd}, state {st} in "
            f"{dtype} need {smem} B of shared memory per block, above "
            f"{MAX_SMEM}")


def ssd_intra_chunk(xdt, log_a, b, c, chunk):
    """Launch a kernel on CUDA tensors: xdt [B,S,nh,hd], log_a [B,S,nh]
    float32, b and c [B,S,st], with xdt, b and c float32 or bfloat16 and
    S a multiple of `chunk`.  Returns (y_intra [B,S,nh,hd], h_chunk
    [B,nC,nh,hd,st], a_chunk [B,nC,nh], acum [B,S,nh]: the chunk-local
    prefix sums of log_a), float32, on the current stream, without
    synchronising."""
    device = xdt.device
    if device.type != "cuda":
        raise ValueError("ssd_intra_chunk: the CUDA kernel takes CUDA "
                         f"tensors, got {device}")
    B, S, nh, hd = xdt.shape
    st = b.shape[-1]
    Q = chunk
    check_shapes(Q, hd, st, xdt.dtype)
    if S % Q:
        raise ValueError(f"ssd_intra_chunk: sequence {S} is not a multiple "
                         f"of the chunk {Q}; ops.ssd_scan pads it")
    nC = S // Q
    if not (1 <= B <= _MAX_GRID_YZ and 1 <= nC <= _MAX_GRID_YZ):
        raise ValueError(f"ssd_intra_chunk: unsupported batch {B} or "
                         f"chunk count {nC}")
    for name, x, dtype, shape in (
            ("log_a", log_a, torch.float32, (B, S, nh)),
            ("b", b, xdt.dtype, (B, S, st)),
            ("c", c, xdt.dtype, (B, S, st))):
        if x.device != device or x.dtype != dtype or \
                tuple(x.shape) != shape:
            raise ValueError(
                f"ssd_intra_chunk: `{name}` is {x.dtype} {tuple(x.shape)} on "
                f"{x.device}, expected {dtype} {shape} on {device}")
    for name, x in (("xdt", xdt), ("log_a", log_a), ("b", b), ("c", c)):
        if not x.is_contiguous():
            raise ValueError(f"ssd_intra_chunk: `{name}` is not contiguous")
    f32 = torch.float32
    y = torch.empty((B, S, nh, hd), dtype=f32, device=device)
    h = torch.empty((B, nC, nh, hd, st), dtype=f32, device=device)
    a = torch.empty((B, nC, nh), dtype=f32, device=device)
    acum = torch.empty((B, S, nh), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = LIBRARY.library().ssd_intra_chunk_launch(
            _DTYPES[xdt.dtype], B, S, nh, hd, st, Q, xdt.data_ptr(),
            log_a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            h.data_ptr(), a.data_ptr(), acum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk: launch failed with CUDA "
                           f"error {err}")
    ssd_intra_chunk.launches += 1
    return y, h, a, acum


ssd_intra_chunk.launches = 0
