"""The comparison that decides ``correct``. The configuration's check
(``benchmark/checks/<check>.py``) judges a sample of what the window's
timed path produced by a plain reference and returns its numbers; each is
compared with its limit in ``benchmark/limits/<cell>.json``. A number over
its limit, not finite, or missing is not correct.
"""

from __future__ import annotations

import math


def judge(cell, steps, seed: int, device) -> dict:
    """``{"numbers", "attempted", "failed", "detail"}`` of the cell's
    check, once the window has closed."""
    return cell.check().judge(cell.cfg, cell.traffic, steps, seed, device)


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})`` over every limit."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k, math.nan)
        out[k] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok, out
