"""Mixed-mode DAG on the threaded runtime with the port's hand-written CUDA
kernels.  Twin of ``examples/mixed_mode_dag.py``: ``repro_torch.mixed_mode``
at the paper's shapes (matmul, sort and copy TAOs, compute-bound,
data-reuse and memory-bound), under ``homogeneous`` and ``molding:weight``,
printing TAOs/s and what the PTT learned.

Run:  PYTHONPATH=src python -m repro_torch.examples.mixed_mode_dag \\
          [--device cpu --n-tasks 30]
"""
from ..mixed_mode import main

if __name__ == "__main__":
    main()
