"""Serving launcher: the continuous-batching engine over a model.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m [--full] [--device cuda|cpu] \
        --requests 12 --slots 4

The flags are the reference launcher's (`repro.launch.serve`) plus
`--device` (default ``cuda``); `--arch` takes ``granite-moe-1b-a400m``
(the default, as the reference launcher's) or any other architecture
(`configs.base.PORTED`) the engine serves: ``qwen2-vl-2b`` on text
prompts; ``whisper-small`` raises `ValueError`, since the engine passes
no frames (the reference's fails at its first prefill).  The model runs
with ``use_flash_kernel=True``:
the SSD scan of the Mamba layers and the MoE router's gating go through
their CUDA kernels on the card and through the kernels' plain versions
on the CPU; the attention of prefill and decode is the plain one, as the
reference's.
Weights are random, drawn from a generator seeded with 0 on the
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs.base import get_config, get_smoke_config
from ..device import resolve_device
from ..models.api import build_model
from ..serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the synthetic request stream")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    device = resolve_device(args.device)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, batch_slots=args.slots,
                         max_seq=args.max_seq, prompt_len=args.prompt_len)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        engine.submit(Request(
            rid, rng.integers(0, cfg.vocab, size=args.prompt_len),
            max_new_tokens=args.max_new))
    t0 = time.time()
    steps = engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"arch={cfg.name} device={device} requests={args.requests} "
          f"slots={args.slots} engine_steps={steps} "
          f"prefills={engine.stats['prefills']} "
          f"decode_steps={engine.stats['decode_steps']} "
          f"tokens={engine.stats['tokens']} "
          f"tok/s={engine.stats['tokens']/dt:,.0f}")
    return engine.stats


if __name__ == "__main__":
    main()
