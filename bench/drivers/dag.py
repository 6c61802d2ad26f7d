"""Driver of the ``paper-dag`` configurations: the paper's mixed-mode DAG
experiment, a closed loop of random DAGs on the program's ``ThreadedRuntime``
with the program's kernels as the TAOs' chunks.

Set-up builds one runtime (its PTT then stays learned for the whole run) and
runs one DAG on it.  The window runs DAG 0, 1, ... one at a time, each bound
by the program's ``mixed_mode.bind_real_work``, until ``seconds`` have
passed; the DAG in flight then runs to its end.  Each DAG has operands of
its own, drawn from (seed, k) into the same buffers before it starts, so an
answer left over from an earlier DAG is a wrong one.  ``taos_per_s`` counts
the TAOs committed inside the window over its seconds.

Every chunk notes itself (``ChunkRecord``), so the check can see that each
chunk of every DAG ran exactly once; for each DAG one chunk of one TAO of
each class, drawn from the seed, keeps its output, which is judged once the
window has closed against ``bench/reference/dag_ops.py`` on that DAG's
operands, drawn again.  A traced run also notes every PTT update (the
program's ``workers.ChunkLog``), which its per-layer metrics read.
"""
from __future__ import annotations

import collections
import random
import time

import torch

from ..harness import traffic, weights
from ..reference import dag_ops


class ChunkRecord:
    """What each chunk of the DAG in flight did, at a few hundred
    nanoseconds a chunk: (TAO id, chunk) appended to ``ran``, and the
    outputs of the chunks named in ``keep`` appended to ``kept`` as (DAG,
    class, output); each append is atomic under the interpreter lock.  In a
    traced run it wraps the program's ``workers.ChunkLog`` (``ptt``), which
    notes every chunk per thread and every PTT update; an untraced run
    leaves that cost out of its window."""

    def __init__(self, ptt=None):
        self.ran: list = []
        self.keep: set = set()
        self.kept: list = []
        self.dag = None
        self.ptt = ptt

    def wrap(self, chunk_fn, tao):
        inner = chunk_fn if self.ptt is None else self.ptt.wrap(chunk_fn, tao)
        tid, cls, ran, keep, kept = tao.id, tao.type, self.ran, self.keep, \
            self.kept
        k = self.dag

        def recorded(i):
            out = inner(i)
            ran.append((tid, i))
            if (tid, i) in keep:
                kept.append((k, cls, out))
            return out
        return recorded

    def take_runs(self) -> list:
        ran, self.ran = self.ran, []
        return ran


def _sample(dag, seed: int, k, n_chunks: int) -> set:
    """(TAO id, chunk) of one TAO of each class of ``dag``, drawn from the
    seed."""
    rng = random.Random(traffic.sub_seed(seed, "sample", k))
    by_cls: dict = {}
    for t in dag.nodes:
        by_cls.setdefault(t.type, []).append(t.id)
    return {(rng.choice(ids), rng.randrange(n_chunks))
            for _, ids in sorted(by_cls.items())}


def _runs_off(ran: list, dag, n_chunks: int) -> int:
    """Chunks of ``dag`` that did not run exactly once."""
    want = {(t.id, i) for t in dag.nodes for i in range(n_chunks)}
    got = collections.Counter(ran)
    return sum(1 for key in want if got[key] != 1) + \
        sum(1 for key in got if key not in want)


def _aliased(kept: list, operands: dict) -> int:
    """Kept outputs whose storage is an operand's or another kept output's:
    a chunk that handed back its input, or an answer it had stored, in
    place of one it computed."""
    seen = {x.untyped_storage().data_ptr() for x in operands.values()}
    n = 0
    for _, _, out in kept:
        ptr = out.untyped_storage().data_ptr()
        n += ptr in seen
        seen.add(ptr)
    return n


def run(r) -> dict:
    from repro_torch import core, mixed_mode
    from repro_torch.kernels import _build

    from ..harness.trace import Tracer, prepare

    cfg, mix, dev = r.config, r.mix, r.device
    if mix["kind"] != "closed_dag":
        raise ValueError(f"the dag driver runs closed_dag traffic, not "
                         f"{mix['kind']}")
    t_driver = time.perf_counter()
    n_chunks = cfg["chunks_per_tao"]
    operands = {cls: torch.empty(spec["shape"],
                                 dtype=weights.DTYPES[spec["dtype"]],
                                 device=dev)
                for cls, spec in cfg["operands"].items()}

    def draw(k):
        """The operands of DAG k, drawn into the same buffers."""
        for cls, x in operands.items():
            weights.fill_normal(x, traffic.sub_seed(r.seed, "operand", cls,
                                                    k))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    make_dag = traffic.closed_dag(mix, r.seed)
    rt = core.ThreadedRuntime(getattr(core, cfg["cluster"])(),
                              core.make_policy(cfg["policy"]), seed=0)
    ptt = None
    if r.trace:
        from repro_torch.workers import ChunkLog
        ptt = ChunkLog()
        ptt.watch(rt.core)
    log = ChunkRecord(ptt)
    commits: list = []
    commit = rt.core.commit_and_wakeup

    def counted(tao):
        out = commit(tao)
        commits.append(time.perf_counter())
        return out
    rt.core.commit_and_wakeup = counted

    def run_dag(k, timeout_s):
        """DAG k on its operands, drawn by the caller."""
        dag = make_dag(k)
        # the chunks to keep, named before the binding that reads them
        log.keep, log.dag = _sample(dag, r.seed, k, n_chunks), k
        mixed_mode.bind_real_work(dag, operands, device=dev,
                                  n_chunks=n_chunks, log=log)
        try:
            done = rt.run(dag, timeout_s=timeout_s)["completed"]
        except TimeoutError:
            done = rt.core.completed
        return len(dag), done, _runs_off(log.take_runs(), dag, n_chunks)

    # set-up: one DAG warms the kernels (building them in a checkout's first
    # run), the streams and the PTT
    draw("warm")
    t_inputs = time.perf_counter()
    n_warm, done_warm, off_warm = run_dag("warm", mix["drain_s"] + 600)
    if done_warm != n_warm or off_warm:
        raise RuntimeError(f"the warm-up DAG ran {done_warm}/{n_warm} TAOs, "
                           f"{off_warm} chunks not once")
    if r.trace:
        prepare()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if ptt is not None:
        ptt.records.clear()
    log.kept.clear()
    commits.clear()
    t0 = time.perf_counter()
    setup_s = t0 - r.t_start
    build_s = _build.build_seconds
    setup = {"built": build_s is not None,
             "start_s": t_driver - r.t_start,
             "inputs_s": t_inputs - t_driver,
             "warm_s": t0 - t_inputs,
             "build_s": build_s or 0.0}

    t_end = t0 + r.seconds
    tracer = Tracer(t_end - mix["trace_seconds"], mix["trace_seconds"]) \
        .start() if r.trace else None
    attempted = done = off = k = 0
    while time.perf_counter() < t_end:
        draw(k)
        n, d, o = run_dag(k, max(0.0, t_end - time.perf_counter())
                          + mix["drain_s"])
        attempted, done, off, k = attempted + n, done + d, off + o, k + 1
        if d < n:
            break
    in_window = sum(1 for t in commits if t <= t_end)
    trace = tracer.result() if tracer is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    records = list(ptt.records) if ptt is not None else None

    checks = {"chunks_not_run_once": (float(off), 0.0),
              "taos_not_completed": (float(attempted - done), 0.0),
              "outputs_aliased": (float(_aliased(log.kept, operands)), 0.0)}
    limits = cfg["limits"]
    judged = {"matmul": "matmul_err", "sort": "sort_mismatch",
              "copy": "copy_mismatch"}
    worst, ctl = {}, {}
    for kd in sorted({kd for kd, _, _ in log.kept}):
        draw(kd)
        for cls in sorted(operands):
            outs = [o for kk, c, o in log.kept if kk == kd and c == cls]
            if not outs:
                continue
            ref = dag_ops.reference(cls, operands[cls])
            name = judged[cls]
            worst[name] = max([worst.get(name, 0.0)] +
                              [dag_ops.error(cls, o, ref) for o in outs])
            if r.control:
                ctl[name] = max(ctl.get(name, 0.0), dag_ops.error(
                    cls, dag_ops.control(cls, operands[cls]), ref))
            del ref
    for name in judged.values():   # a class whose chunks kept nothing
        checks[name] = (worst.get(name, float("inf")), float(limits[name]))
    kept = collections.Counter(cls for _, cls, _ in log.kept)
    return {"setup_s": setup_s, "setup": setup, "attempted": attempted,
            "failed": attempted - done, "checks": checks,
            "control_checks": {n: (v, float(limits[n]))
                               for n, v in ctl.items()},
            "memory_peak_bytes": peak,
            "trace": trace, "config": cfg, "mix": mix,
            "taos_per_s": in_window / r.seconds, "dags": k,
            "ptt_records": records, "kept": dict(kept)}
