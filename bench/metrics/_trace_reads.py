"""Readings of a traced window shared by several metrics."""
from __future__ import annotations

from . import _counts


def idle_pct(obs):
    """Percent of the traced window in which no operation ran on the card;
    None without a trace or without device work in it."""
    tr = obs.get("trace")
    if tr is None or not tr.found or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def dag_roofline_pct(obs, cls: str, kernel: str):
    """Percent of its bound that the class's kernel reached: the bound of one
    chunk at the configuration's shape over the kernel's mean device time in
    the traced window; None where it did not run there."""
    tr = obs.get("trace")
    if tr is None or not tr.found:
        return None
    n, seconds = tr.kernels(kernel)
    if n == 0 or seconds <= 0:
        return None
    op = obs["config"]["operands"][cls]
    return 100.0 * _counts.dag_chunk_bound_s(cls, op["shape"], op["dtype"]) \
        / (seconds / n)
