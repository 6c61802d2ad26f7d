"""The paper's mixed-mode DAG on the threaded runtime, with the port's
hand-written CUDA kernels.  Twin of ``examples/mixed_mode_dag.py``.

A ``random_dag`` of matmul, sort and copy TAOs (the paper's compute-bound,
data-reuse and memory-bound classes, in equal thirds) runs on
``ThreadedRuntime`` over the 8-worker ``hikey960()`` spec.  Each TAO's
``ChunkedWork`` chunks call one kernel through ``kernels.ops``; the PTT
learns per-(leader, width) wall times and molding acts on them.

On the card every worker thread launches on a CUDA stream of its own and
synchronises it at the end of each chunk (``workers.on_own_stream``), so a
leader's wall time, which is what the PTT learns, covers the device work and
not only the launch.  On one card the BIG and LITTLE workers of
``hikey960()`` are labels on eight threads that share it: no core is slower.

Run:  PYTHONPATH=src python -m repro_torch.mixed_mode [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import (ChunkedWork, ThreadedRuntime, hikey960, make_policy,
                   random_dag)
from .kernels import ops
from .workers import ChunkLog, on_own_stream, resolve_device

# class -> chunk operand shape.  The example's shapes are launch-bound on an
# H100; at these each class keeps its bound there (PERF.md, "Cells").
PAPER_SHAPES = {"matmul": (2048, 2048), "sort": (1024, 4096),
                "copy": (16384, 1024)}
DTYPES = {"matmul": torch.bfloat16, "sort": torch.float32,
          "copy": torch.float32}
POLICIES = ("homogeneous", "molding:weight")
N_CHUNKS = 4  # chunks per TAO, as in the example
RUN_SPAN = "mixed_mode.run"  # profiler span around the runtime's run

# class -> the op one chunk runs on the class's operand (the example's)
CHUNK_OPS = {
    "matmul": lambda x: ops.matmul(x, x),
    "sort": ops.sort_rows,
    "copy": ops.copy,
}


def make_arrays(shapes=PAPER_SHAPES, seed: int = 0) -> dict[str, np.ndarray]:
    """One float32 standard-normal operand per class, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {cls: rng.standard_normal(shape, dtype=np.float32)
            for cls, shape in shapes.items()}


def operands_from_numpy(arrays: dict[str, np.ndarray],
                        device="cuda") -> dict[str, torch.Tensor]:
    """The payload operands on ``device`` in each class's dtype.  The slice's
    state is these operands: the JAX twin builds its own from the same numpy
    arrays (bf16 rounds to nearest even in both)."""
    dev = resolve_device(device)
    return {cls: torch.from_numpy(a).to(device=dev, dtype=DTYPES[cls])
            for cls, a in arrays.items()}


def bind_real_work(dag, operands: dict[str, torch.Tensor], *, device,
                   n_chunks: int = N_CHUNKS,
                   log: ChunkLog | None = None) -> None:
    """Give every TAO ``n_chunks`` chunks of its class's kernel.

    A chunk returns the op's output.  On the card it launches on the calling
    thread's own stream and returns once that stream has drained."""
    dev = resolve_device(device)
    calls = on_own_stream({cls: lambda i, op=CHUNK_OPS[cls], x=x: op(x)
                           for cls, x in operands.items()}, dev)
    for node in dag.nodes:
        fn = calls[node.type]
        node.work = ChunkedWork(fn if log is None else log.wrap(fn, node),
                                n_chunks=n_chunks)


def run(policy: str = "molding:weight", n_tasks: int = 3000,
        degree: float = 3.03, seed: int = 1, device="cuda", *,
        shapes=PAPER_SHAPES, timeout_s: float = 600.0,
        log: ChunkLog | None = None) -> dict:
    """Run one ``random_dag(n_tasks, degree, seed)`` under ``policy``.

    Returns ``ThreadedRuntime.run``'s result plus the learned PTT
    (``ptt``: class -> (workers, widths) seconds).  With a ``log``, every
    chunk execution and PTT update of the run is noted in it."""
    dev = resolve_device(device)
    operands = operands_from_numpy(make_arrays(shapes), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dag = random_dag(n_tasks=n_tasks, target_degree=degree, seed=seed)
    bind_real_work(dag, operands, device=dev, log=log)
    spec = hikey960()
    rt = ThreadedRuntime(spec, make_policy(policy), seed=0)
    if log is not None:
        log.watch(rt.core)
    with torch.profiler.record_function(RUN_SPAN):
        out = rt.run(dag, timeout_s=timeout_s)
    ptt = rt.core.ptt
    out.update(policy=policy, device=str(dev), widths=spec.widths,
               ptt={t: ptt.table(t).snapshot() for t in ptt.types()})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-tasks", type=int, default=3000)
    args = ap.parse_args(argv)
    for policy in POLICIES:
        out = run(policy, n_tasks=args.n_tasks, device=args.device)
        print(f"{policy:16s} {out['throughput_taos_per_s']:8.1f} TAOs/s "
              f"({out['completed']} TAOs, {out['elapsed_s']:.2f}s)")
        for cls, table in out["ptt"].items():
            times = [f"w{w}={table[0, i] * 1e3:.2f}ms"
                     for i, w in enumerate(out["widths"]) if table[0, i] > 0]
            if times:
                print(f"    PTT[{cls}] leader0: {', '.join(times)}")


if __name__ == "__main__":
    main()
