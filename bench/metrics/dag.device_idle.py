"""Percent of the traced window (the last ``trace_seconds`` of the measured
one) in which no kernel, copy or fill ran on the card."""
import importlib

UNIT, MOVES, SOURCE, LAYER = "%", "taos_per_s", "device_trace", "device"


def read(obs):
    return importlib.import_module("bench.metrics._trace_reads").idle_pct(obs)
