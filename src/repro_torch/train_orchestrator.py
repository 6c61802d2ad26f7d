"""Training on the XiTAO scheduler: a training step as a mixed-mode DAG of
microbatch tasks.  Twin of ``repro.core.train_orchestrator``; it lives
beside ``mixed_mode`` and ``workers`` because ``core/`` holds only the
byte-identical copy of the JAX package's framework-neutral modules.

One optimizer step with K microbatches becomes:

    fwdbwd(mb_0) ... fwdbwd(mb_{K-1})      (compute-bound, moldable)
            \\    |    /
             grad_reduce                    (BW-bound: the paper's copy class)
                 |
             opt_update                     (small)

Chained over steps.  ``build_training_dag``, ``training_kernel_models`` and
``simulate_training`` are the JAX module's neutral half, copied: the DAG
the simulator runs at fleet scale.  ``run_training_threaded`` runs the same
DAG on ``ThreadedRuntime`` with real grads: each fwdbwd TAO computes the
grads of its microbatch and adds them into a shared ``GradAccumulator``,
and opt_update averages them and applies the update.  On the card every
payload runs on its worker thread's own stream (``workers.on_own_stream``)
and returns once that stream has drained, so a TAO's kernels, its backward
included (the autograd engine runs it on the forward's stream), are done
before the TAO completes and the next TAO reads them.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from .core.dag import TaoDag
from .core.places import BIG, LITTLE, ClusterSpec
from .core.policies import Policy
from .core.runtime import ChunkedWork, ThreadedRuntime
from .core.simulator import KernelModel, SimResult, Simulator
from .workers import on_own_stream


def build_training_dag(n_steps: int, n_microbatches: int,
                       width_hint: int = 1) -> TaoDag:
    """Static DAG for ``n_steps`` optimizer steps (simulator payloads)."""
    dag = TaoDag()
    prev_opt = None
    for s in range(n_steps):
        mbs = []
        for m in range(n_microbatches):
            deps = [prev_opt] if prev_opt is not None else []
            mbs.append(dag.add_task("fwdbwd", width_hint=width_hint,
                                    work=1.0, deps=deps))
        red = dag.add_task("grad_reduce", width_hint=width_hint, work=1.0,
                           deps=mbs)
        prev_opt = dag.add_task("opt_update", width_hint=1, work=0.1,
                                deps=[red])
    return dag


def training_kernel_models() -> dict:
    return {
        "fwdbwd": KernelModel(            # compute-bound
            t_ref=0.020, speed={BIG: 2.4, LITTLE: 1.0},
            efficiency={1: 1.0, 2: 0.97, 4: 0.94, 8: 0.9}),
        "grad_reduce": KernelModel(       # BW-bound (copy class)
            t_ref=0.008, speed={BIG: 1.5, LITTLE: 1.0},
            efficiency={1: 1.0, 2: 0.7, 4: 0.4, 8: 0.22},
            stream=True, bw_cap={BIG: 2.0, LITTLE: 2.5}),
        "opt_update": KernelModel(        # small, BW-ish
            t_ref=0.002, speed={BIG: 1.5, LITTLE: 1.0},
            efficiency={1: 1.0, 2: 0.6, 4: 0.35, 8: 0.2}),
    }


def simulate_training(n_steps: int, n_microbatches: int, spec: ClusterSpec,
                      policy: Policy, width_hint: int = 1,
                      seed: int = 0) -> SimResult:
    dag = build_training_dag(n_steps, n_microbatches, width_hint=width_hint)
    sim = Simulator(spec, policy, kernel_models=training_kernel_models(),
                    seed=seed)
    return sim.run(dag)


# ---------------------------------------------------------------------------
# real threaded execution
# ---------------------------------------------------------------------------
class GradAccumulator:
    """Lock-guarded fp32 grad accumulation shared by fwdbwd TAOs."""

    def __init__(self, like: dict):
        self._zero = {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in like.items()}
        self.buf = self._zero
        self.count = 0
        self.lock = threading.Lock()

    def add(self, grads: dict) -> None:
        with self.lock:
            buf = {k: a + grads[k].float() for k, a in self.buf.items()}
            # the next add may run on another thread's stream: it must read
            # a finished sum, and the sum it replaces must be read before
            # the allocator can hand that memory out again
            first = next(iter(buf.values()))
            if first.is_cuda:
                torch.cuda.current_stream(first.device).synchronize()
            self.buf = buf
            self.count += 1

    def drain(self) -> tuple[dict, int]:
        with self.lock:
            out, n = self.buf, self.count
            self.buf = self._zero
            self.count = 0
        return out, n


def run_training_threaded(
    spec: ClusterSpec,
    policy: Policy,
    params: dict,
    opt_state: Any,
    grad_fn: Callable[[dict, dict], tuple[dict, dict]],  # (params, batch) -> (grads, metrics)
    update_fn: Callable[[dict, dict, Any], tuple[dict, Any]],  # (params, grads, opt) -> (params, opt)
    batches: list,                                    # [step][microbatch]
    seed: int = 0,
    timeout_s: float = 600.0,
) -> dict:
    """Executes the training DAG with real grads on the params' device;
    returns ``ThreadedRuntime.run``'s stats with the final ``params`` and
    ``opt``, the microbatches' ``losses`` in completion order, and the
    learned PTT (``ptt``: TAO type -> (workers, widths) seconds, and
    ``widths``)."""
    state = {"params": params, "opt": opt_state, "losses": []}
    acc = GradAccumulator(params)
    state_lock = threading.Lock()
    device = next(iter(params.values())).device
    # ``state`` is the run's only holder, so the first update can free the
    # initial state where the caller let go of it too
    del params, opt_state

    payloads = {}
    for s, step_batches in enumerate(batches):
        for m, mb in enumerate(step_batches):
            def fwdbwd(i, mb=mb):
                with state_lock:
                    p = state["params"]
                grads, metrics = grad_fn(p, mb)
                acc.add(grads)
                if "loss" in metrics:
                    loss = float(metrics["loss"])
                    with state_lock:
                        state["losses"].append(loss)
            payloads["fwdbwd", s, m] = fwdbwd

        def reduce_and_update(i):
            grads, n = acc.drain()
            grads = {k: g / max(n, 1) for k, g in grads.items()}
            with state_lock:
                state["params"], state["opt"] = update_fn(
                    state["params"], grads, state["opt"])
        payloads["opt_update", s] = reduce_and_update
    payloads = on_own_stream(payloads, device)

    dag = TaoDag()
    prev_opt = None
    for s, step_batches in enumerate(batches):
        deps = [prev_opt] if prev_opt is not None else []
        mb_taos = [dag.add_task("fwdbwd", deps=deps, work=ChunkedWork(
            payloads["fwdbwd", s, m], 1)) for m in range(len(step_batches))]
        red = dag.add_task("grad_reduce", work=ChunkedWork(lambda i: None, 1),
                           deps=mb_taos)
        prev_opt = dag.add_task("opt_update", deps=[red], work=ChunkedWork(
            payloads["opt_update", s], 1))

    rt = ThreadedRuntime(spec, policy, seed=seed)
    try:
        stats = rt.run(dag, timeout_s=timeout_s)
    finally:
        # the TAOs reference each other (parents, children), so the
        # payloads, and through them the state and the accumulator's
        # buffers, would stay on the card until the cyclic collector ran
        for node in dag.nodes:
            node.work = None
    ptt = rt.core.ptt
    stats.update(losses=state["losses"], params=state["params"],
                 opt=state["opt"], widths=spec.widths,
                 ptt={t: ptt.table(t).snapshot() for t in ptt.types()})
    return stats
