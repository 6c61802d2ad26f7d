"""Percent of its roofline that the copy kernel (``copy_vec16``)
reached in the traced window: one chunk's bound at the configuration's
shape (``_counts.dag_chunk_bound_s``) over the kernel's mean device
time."""
import importlib

UNIT, MOVES, SOURCE, LAYER = "%", "taos_per_s", "device_trace", "kernels"


def read(obs):
    return importlib.import_module("bench.metrics._trace_reads") \
        .dag_roofline_pct(obs, "copy", "copy_vec16")
