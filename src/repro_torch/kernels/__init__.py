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


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since its counter was last reset."""
    return {name: counter.count for name, counter in KERNELS.items()}


def reset_launch_counts() -> None:
    for counter in KERNELS.values():
        counter.reset()
