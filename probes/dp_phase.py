"""On the card: its multi-rank test and train steps, then chip_smoke's
dp_train_path alone."""
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
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest",
                        "-p", "no:cacheprovider", "tests/test_torch_cuda.py",
                        "-k", "gloo or train_steps"], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src"},
                       capture_output=True, text=True)
    print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
    print(f"card tests {time.perf_counter() - t0:.1f} s, rc {r.returncode}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    timings = {}
    t0 = time.perf_counter()
    cs.dp_train_path(timings)
    print(timings, f"{time.perf_counter() - t0:.1f} s", flush=True)
