"""Hand-written Hopper kernels of the port, one per Pallas kernel on a
ported path, each with its plain PyTorch version beside it.  Sources are in
``csrc/``; ``_build`` compiles them at first use."""
from . import copy_stream, flash_attention, matmul, sort_bitonic

# kernel name (as in ``ops``) -> the module holding its wrapper and counter
KERNELS = {"matmul": matmul, "copy": copy_stream, "sort_rows": sort_bitonic,
           "flash_attention": flash_attention}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since its counter was last reset."""
    return {name: mod.launches.count for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches.reset()
