"""On the card: the serving-over-ranks card tests (unless `--no-tests`),
then chip_smoke's tp_serve_path alone: Mamba2-2.7B, Qwen3-1.7B under
decode_32k's layout and granite-moe served over ranks, Mamba2's train
steps over them, the smoke checks, and ssd_scan and gating_topk at a
rank's shapes."""
import os
import subprocess
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
    tests = [] if "--no-tests" in sys.argv else [
        "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
        "tests/test_torch_cuda.py", "-k", "tp_serve or ranks_head_block"]
    r = subprocess.run([sys.executable] + (tests or ["-c", "pass"]),
                       cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"},
                       capture_output=True, text=True)
    print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
    print(f"build and card tests {time.perf_counter() - t0:.1f} s, rc "
          f"{r.returncode}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timings = {}
    t0 = time.perf_counter()
    print(cs.tp_serve_path(timings), flush=True)
    print(timings, f"{time.perf_counter() - t0:.1f} s", flush=True)
