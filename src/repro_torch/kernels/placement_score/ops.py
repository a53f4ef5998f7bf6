"""`score_rows`: the placement path's entry to the placement-score kernel.

Float32 contract, as in `repro`: the kernel computes in float32, so a
float64 input raises `TypeError` instead of being cast quietly.  Tensors
on the CPU take the plain version (`ref.reference_score`); tensors on a
CUDA device launch the kernel, or raise if it cannot be built or
launched.  `interpret=True` asks for the plain version on whatever device
the tensors are on: the comparison on the card uses it.
"""
from __future__ import annotations

import torch

from .kernel import placement_score
from .ref import reference_score

_FLOAT_ARGS = ("row_cap", "row_load", "lineup_ha", "lineup_tot",
               "lineup_cap", "p_dep", "ha_frac")


def score_rows(row_feeds, row_nfeeds, row_cap, row_load, lineup_ha,
               lineup_tot, lineup_cap, p_dep, ha_frac, is_ha, is_block,
               interpret: bool = False):
    """Returns (feas [N, R] bool, score [N, R] float32; infeasible rows
    score `BIG`).  Shapes as in `ref.reference_score`."""
    args = (row_feeds, row_nfeeds, row_cap, row_load, lineup_ha, lineup_tot,
            lineup_cap, p_dep, ha_frac, is_ha, is_block)
    for name, x in zip(_FLOAT_ARGS, args[2:9]):
        if x.dtype == torch.float64:
            raise TypeError(
                f"score_rows: `{name}` is float64; the placement-score "
                "kernel computes in float32. Cast inputs to float32 "
                "explicitly before calling.")
    if interpret or row_feeds.device.type == "cpu":
        return reference_score(*args)
    return placement_score(*args)
