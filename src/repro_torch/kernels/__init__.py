"""Hand-written Hopper kernels of the port, one per Pallas kernel, each with
its plain PyTorch version beside it.  Sources are in ``csrc/``; ``_build``
compiles them at first use."""
from . import copy_stream, flash_attention, matmul, rmsnorm, sort_bitonic

# kernel name (as in ``ops``) -> its launch counter
KERNELS = {"matmul": matmul.launches, "copy": copy_stream.launches,
           "triad": copy_stream.triad_launches,
           "sort_rows": sort_bitonic.launches,
           "rmsnorm": rmsnorm.launches,
           "flash_attention": flash_attention.launches}
# entry point -> (the kernel of ``KERNELS`` it belongs to, its launch
# counter): the two halves of a norm over a row split across ranks
ENTRY_POINTS = {"rmsnorm_sumsq": ("rmsnorm", rmsnorm.sumsq_launches),
                "rmsnorm_scale": ("rmsnorm", rmsnorm.scale_launches)}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since its counter was last reset."""
    return {name: counter.count for name, counter in KERNELS.items()}


def entry_launch_counts() -> dict[str, int]:
    """Launches of each entry point of ``ENTRY_POINTS`` since its counter
    was last reset."""
    return {name: counter.count for name, (_, counter)
            in ENTRY_POINTS.items()}


def reset_launch_counts() -> None:
    """Every counter of ``KERNELS`` and ``ENTRY_POINTS`` to 0."""
    for counter in (*KERNELS.values(),
                    *(c for _, c in ENTRY_POINTS.values())):
        counter.reset()
