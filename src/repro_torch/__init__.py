"""repro_torch: the PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

``core`` is a byte-identical copy of the framework-neutral scheduler
(``repro.core``), ``kernels`` holds the hand-written CUDA kernels with their
plain PyTorch versions, and ``mixed_mode`` runs the paper's mixed-mode DAG on
them.  The package imports neither JAX nor ``repro``.
"""
