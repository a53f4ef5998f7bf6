"""HLO-calibrated throughput model (beyond-paper; DESIGN.md §2): the
artifact reader.

The counterpart of `repro.core.calibration`.  The paper's Appendix-A
per-token costs are first-order analytic estimates.  This module turns a
dry-run artifact, which records per-device FLOPs, HBM bytes and
collective bytes of one compiled serving step (`repro.launch.dryrun`
writes them), into a `CostScale`, so the fleet/payoff studies run on
measured numbers instead of closed forms.  What the port itself writes
into this schema is ROADMAP queue 1, item 12; this module only reads it.

Dry-run artifact schema (JSON, one file per cell):
    {
      "arch": str, "shape": str, "mesh": str, "n_devices": int,
      "flops_per_device": float,
      "bytes_per_device": float,
      "collective_bytes_per_device": float,
      "batch": int, "seq": int, "step": "train"|"prefill"|"decode",
    }
"""
from __future__ import annotations

import json
import os
from typing import Dict

from . import throughput as tp


def load_artifact(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def tokens_in_step(art: Dict) -> float:
    if art["step"] == "decode":
        return float(art["batch"])          # one new token per sequence
    return float(art["batch"]) * float(art["seq"])


def cost_scale_from_dryrun(art: Dict, model: tp.MoEModel,
                           phase: str = "dec") -> tp.CostScale:
    """CostScale multipliers = measured per-token cost / analytic cost.

    The measured numerator is global (per-device × n_devices) per token of
    the compiled step; the analytic denominator is the paper's Eq. 6–11
    estimate for the same phase, with the communication term at a fixed
    TP degree of 8.  A multiplier > 1 means the compiled system does more
    work than the first-order model assumes (e.g. remat, dispatch
    overhead); < 1 means the model over-counts.
    """
    n_tok = tokens_in_step(art)
    n_dev = float(art["n_devices"])
    flops_tok = art["flops_per_device"] * n_dev / n_tok
    bytes_tok = art["bytes_per_device"] * n_dev / n_tok
    coll_tok = art["collective_bytes_per_device"] * n_dev / n_tok

    if phase == "pre":
        c_ref = float(tp.c_prefill(model, model.S))
        m_ref = float(tp.m_prefill(model, model.S))
    else:
        c_ref = float(tp.c_decode(model, model.S))
        m_ref = float(tp.m_decode(model, model.S))
    n_ref = float(tp.n_tp(model, 8) + tp.n_ep(model))

    return tp.CostScale(
        compute=max(flops_tok / c_ref, 1e-6),
        memory=max(bytes_tok / m_ref, 1e-6),
        comm=max(coll_tok / n_ref, 1e-6),
    )


def calibrated_scales(dryrun_dir: str, model: tp.MoEModel,
                      step: str = "decode") -> Dict[str, tp.CostScale]:
    """Scan a dry-run artifact directory → {cell_name: CostScale}."""
    out = {}
    if not os.path.isdir(dryrun_dir):
        return out
    for fn in sorted(os.listdir(dryrun_dir)):
        if not fn.endswith(".json"):
            continue
        art = load_artifact(os.path.join(dryrun_dir, fn))
        if art.get("step") != step:
            continue
        phase = "pre" if step == "prefill" else "dec"
        out[fn[:-5]] = cost_scale_from_dryrun(art, model, phase)
    return out
