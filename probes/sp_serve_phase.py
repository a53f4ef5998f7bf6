"""On the card: chip_smoke's sp_serve_path alone: Mamba2-2.7B and
Jamba's period served over four gloo ranks on card 0 under
sequence_parallel_rules on (1, 2, 2), the smoke checks (card against CPU
ranks), then ssd_scan at a "data" rank's shapes and gating_topk at
Jamba's router shapes.  Run from the repository's root:
`python3 probes/sp_serve_phase.py`."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

if __name__ == "__main__":
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import kernel as flash_ker
    from repro_torch.kernels.moe_gating import kernel as gating_ker
    from repro_torch.kernels.nvcc import build_all
    from repro_torch.kernels.ssd_scan import kernel as ssd_ker
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    build_all((ssd_ker.LIBRARY, flash_ker.LIBRARY, gating_ker.LIBRARY))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timings = {}
    t0 = time.perf_counter()
    print(cs.sp_serve_path(timings), flush=True)
    print(timings, f"{time.perf_counter() - t0:.1f} s", flush=True)
