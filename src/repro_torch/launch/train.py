"""Training launcher: data pipeline → train step → checkpointed,
supervised loop (straggler detection + restart-on-failure).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        [--full] [--device cuda|cpu] --steps 50 --batch 8 --seq 256

The flags are the reference launcher's (`repro.launch.train`) plus
`--device` (default ``cuda``, which raises without a card).  `--arch`
takes the decoder-only architectures (`configs.base.PORTED`;
``qwen3-1.7b`` the default), which train on the pipeline's tokens (the
VLM without a vision prefix, as the reference's launcher trains it);
``whisper-small`` raises `ValueError`, since its loss needs frames,
which neither launcher feeds.  Parameters are drawn in
bfloat16 from a generator seeded with 0 on the device; the model trains
with its kernels off (`use_flash_kernel=False`), as the reference
trains.  `--resume` restores `(params, AdamWState)` from the latest
committed checkpoint onto the device and restarts the pipeline at the
restored step; checkpoints are `repro`'s on-disk format, so either
package resumes the other's.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import get_config, get_smoke_config
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..device import resolve_device
from ..models.api import build_model
from ..optim import adamw
from ..runtime.fault import Supervisor
from ..train.step import make_train_step


def build_trainer(cfg, batch: int, seq: int, lr: float = 3e-4,
                  accum_steps: int = 1, device="cuda"):
    """(model, opt_cfg, step_fn) on `device`; `batch` and `seq` are the
    reference's arguments, which the step does not read."""
    model = build_model(cfg, device)
    opt_cfg = adamw.AdamWConfig(lr=lr)
    step_fn = make_train_step(model, opt_cfg, accum_steps=accum_steps)
    return model, opt_cfg, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: the launcher feeds tokens only, and "
                         "the encoder-decoder's loss needs frames")
    device = resolve_device(args.device)
    model, opt_cfg, step_fn = build_trainer(cfg, args.batch, args.seq,
                                            args.lr, args.accum, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = adamw.init(params)
    print(f"arch={cfg.name} params={model.n_params():,} device={device}")

    pipe = TokenPipeline(PipelineConfig(args.batch, args.seq, cfg.vocab))
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        (params, opt_state), start = ckpt.restore((params, opt_state),
                                                  device=device)
        pipe.load_state_dict({"step": start})
        print(f"resumed from step {start}")

    def one_step(state, step):
        p, o = state
        batch = {"tokens": torch.as_tensor(pipe._batch_at(step),
                                           device=device)}
        p, o, metrics = step_fn(p, o, batch)
        return (p, o), metrics

    sup = Supervisor(
        step_fn=one_step,
        save_fn=lambda s, st: ckpt.save(s, st),
        restore_fn=lambda: ckpt.restore((params, opt_state), device=device),
        checkpoint_every=args.ckpt_every)

    t0 = time.time()
    (params, opt_state), step, history, restarts = sup.run(
        (params, opt_state), start, args.steps)
    ckpt.wait()
    losses = [float(h["loss"]) for h in history]
    dt = time.time() - t0
    toks = args.batch * args.seq * len(history)
    print(f"steps={step} loss[first..last]={losses[0]:.3f}..{losses[-1]:.3f}"
          f" tokens/s={toks/dt:,.0f} restarts={restarts}"
          f" stragglers={len(sup.straggler.events)}")
    return losses


if __name__ == "__main__":
    main()
