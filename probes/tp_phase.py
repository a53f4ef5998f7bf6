"""On the card: the tensor-parallel card tests (unless `--no-tests`), then
chip_smoke's tp_train_path, flash at a rank's shape (H 8, Hk 4) and
the kernels at the path's per-rank shapes (`tp_kernel_checks`) alone."""
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
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    build_all((flash_ker.LIBRARY, gating_ker.LIBRARY))
    tests = [] if "--no-tests" in sys.argv else [
        "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
        "tests/test_torch_cuda.py", "-k", "tp_ or gloo"]
    r = subprocess.run([sys.executable] + (tests or ["-c", "pass"]),
                       cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"},
                       capture_output=True, text=True)
    print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
    print(f"build and card tests {time.perf_counter() - t0:.1f} s, rc "
          f"{r.returncode}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    timings = {}
    t0 = time.perf_counter()
    print(cs.tp_train_path(timings), flush=True)
    print(cs.flash_zoo_shape(torch.device("cuda", 0), 8, 4, seed=17))
    print(cs.tp_kernel_checks(torch.device("cuda", 0)))
    print(timings, f"{time.perf_counter() - t0:.1f} s", flush=True)
