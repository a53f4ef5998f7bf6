"""On four cards: chip_smoke's dp_train_path with only the
NCCL layout, one rank per card."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

if __name__ == "__main__":
    import torch
    import chip_smoke as cs
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.dp_layouts = lambda: [("nccl", "cuda", torch.cuda.device_count())]
    timings = {}
    t0 = time.perf_counter()
    cs.dp_train_path(timings)
    print(timings, f"{time.perf_counter() - t0:.1f} s", flush=True)
