"""Batched serving engine: continuous batching over fixed decode slots
(port of `repro.serve.engine`, with its semantics).

Requests claim a free slot and are prefilled one at a time, their
prompts truncated or left-padded with zeros to `prompt_len`; the
single-row caches are copied into the slot along the batch axis of the
stacked caches, leaf by leaf (any cache tree: a NamedTuple, or the
hybrid's dict of them).  The first token is the argmax of the prefill logits.
Each step then decodes every slot one token with one shared position;
finished slots (max_new_tokens, EOS or max_seq − 1) free immediately.
The decode step runs eagerly.  Prefill passes the prompt's tokens only,
as the reference's engine does: the VLM serves text prompts, and the
encoder-decoder (audio), whose prefill needs frames, is refused at
construction.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models.api import Model


def _cache_pairs(full, one):
    """(slot leaf, prefill leaf) pairs of two cache trees of one structure
    (a cache NamedTuple, or the hybrid's dict of them), leaf by leaf, as
    the reference's `jax.tree.map` pairs them."""
    if isinstance(full, torch.Tensor):
        yield full, one
    elif isinstance(full, dict):
        if full.keys() != one.keys():
            raise ValueError(f"cache trees differ: {sorted(full)} and "
                             f"{sorted(one)}")
        for k in full:
            yield from _cache_pairs(full[k], one[k])
    else:
        if len(full) != len(one):
            raise ValueError("cache trees differ in length")
        for a, b in zip(full, one):
            yield from _cache_pairs(a, b)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = field(default_factory=list)
    done: bool = False
    t_submit: float = field(default_factory=time.time)
    t_first: Optional[float] = None
    t_done: Optional[float] = None


class ServeEngine:
    def __init__(self, model: Model, params, batch_slots: int = 4,
                 max_seq: int = 128, prompt_len: int = 16):
        if model.cfg.family == "audio":
            raise ValueError(
                f"{model.cfg.name}: the engine passes no frames to prefill "
                "(only tokens, as the reference's engine), and the "
                "encoder-decoder's prefill needs them; drive it through "
                "Model.prefill and Model.decode_step")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.device = model.device
        self.B = batch_slots
        self.max_seq = max_seq
        # slots share a position counter, so prompts are padded/truncated
        # to a fixed prefill length
        self.prompt_len = prompt_len
        self.caches = model.init_caches(batch_slots, max_seq)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self._queue: List[Request] = []
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0}

    # --- admission ---
    def submit(self, req: Request):
        self._queue.append(req)

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self):
        """Prefill queued requests into free slots, one request at a
        time."""
        for slot in self._free_slots():
            if not self._queue:
                break
            req = self._queue.pop(0)
            S = self.prompt_len
            prompt = np.asarray(req.prompt, np.int32)[-S:]
            if len(prompt) < S:
                prompt = np.concatenate(
                    [np.zeros(S - len(prompt), np.int32), prompt])
            tokens = torch.as_tensor(prompt, dtype=torch.int64,
                                     device=self.device)[None]
            logits, caches1 = self.model.prefill(self.params,
                                                 {"tokens": tokens},
                                                 self.max_seq)
            # copy the single-row prefill caches into this slot
            for full, one in _cache_pairs(self.caches, caches1):
                full[:, slot] = one[:, 0].to(full.dtype)
            tok = int(torch.argmax(logits[0]))
            req.output.append(tok)
            req.t_first = time.time()
            self.slot_req[slot] = req
            self.slot_pos[slot] = S
            self.stats["prefills"] += 1
            self.stats["tokens"] += S

    # --- decode ---
    def _live(self):
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def step(self):
        """One engine step: admit, then decode all live slots one token."""
        self._admit()
        live = self._live()
        if not live:
            return False
        tokens = np.zeros((self.B, 1), np.int64)
        for i in live:
            tokens[i, 0] = self.slot_req[i].output[-1]
        pos = int(self.slot_pos[live].max())
        logits, self.caches = self.model.decode_step(
            self.params, torch.as_tensor(tokens, device=self.device), pos,
            self.caches)
        self.stats["decode_steps"] += 1
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for i in live:
            req = self.slot_req[i]
            req.output.append(int(nxt[i]))
            self.slot_pos[i] += 1
            self.stats["tokens"] += 1
            if (len(req.output) >= req.max_new_tokens
                    or (req.eos_id is not None and nxt[i] == req.eos_id)
                    or self.slot_pos[i] >= self.max_seq - 1):
                req.done = True
                req.t_done = time.time()
                self.slot_req[i] = None
        return True

    def run_until_drained(self, max_steps: int = 10_000):
        steps = 0
        while (self._queue or self._live()) and steps < max_steps:
            self.step()
            steps += 1
        return steps

    def throughput_tokens_per_s(self, t0: float) -> float:
        return self.stats["tokens"] / max(time.time() - t0, 1e-9)
