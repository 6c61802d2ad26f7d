"""Serving on the XiTAO scheduler: the multi-tenant control plane end to end.

Each request phase is a TAO:

  * ``prefill``  — compute-bound (the paper's *matmul* class): wide slices
                   pay off, and big/fast device groups pay off.
  * ``decode``   — memory-BW-bound (the paper's *copy* class): extra width
                   buys little; efficient (LITTLE) groups are nearly as good.

A request trace becomes a *workload*: every request is one tenant-labelled
``DagArrival`` (prefill -> chained decode bursts) entering the system at its
own arrival time, so the whole multi-tenant control plane applies unchanged —
admission gates rate-limit/reject per tenant, preemption controllers displace
running work at chunk boundaries, molding picks slice widths by load, and the
per-request *sojourn* (completion minus arrival — the latency a user actually
observes) falls out of the ``DagStats`` accounting both vehicles share.
The paper's machinery does the rest **online**: the PTT learns the two
phases' (class, width) profiles, weight-based scheduling discovers that
prefill belongs on big slices and decode on LITTLE ones (= disaggregated
prefill/decode placement, learned rather than configured).

Two execution vehicles, same workload:
  * ``simulate_serving`` — calibrated simulator (fleet scale, used by
    benchmarks); TAO.work is a unit-work multiplier (prompt/gen length) fed
    to :func:`serving_kernel_models`.
  * ``run_serving_threaded`` — real jitted prefill/decode on worker threads
    (tiny models / Pallas-class kernels, see ``repro.launch.zoo``), bound
    lazily per admitted request via ``DagArrival.bind``.  Here the PTT rows
    are *measured* wall-clock kernel times, not modeled ones — the threaded
    vehicle closes the sim<->real loop.

Both return a :class:`ServeStats` whose latencies are per-request sojourns
keyed by request id, with per-tenant token throughput and the (class, width)
profiles the PTT ended up learning.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Iterable, Sequence

from .dag import TAO, DataFootprint, TaoDag
from .places import BIG, LITTLE, ClusterSpec
from .policies import Policy
from .runtime import ChunkedWork, ThreadedRuntime
from .simulator import KernelModel, Simulator
from .workload import Workload, WorkloadResult, percentile


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    id: int
    prompt_len: int
    gen_len: int
    # stream position + admission namespace: requests of one tenant share an
    # admission bucket/SLO and a model flavor in the tenant zoo
    arrival: float = 0.0
    tenant: str = "default"

    @property
    def tokens(self) -> int:
        """Application work units this request carries (prompt + generated)."""
        return self.prompt_len + self.gen_len


# tokens of work that cost roughly one t_ref on a reference worker
PREFILL_UNIT = 2048
DECODE_UNIT = 64     # decode burst granularity (tokens per decode TAO)


def append_request_chain(dag: TaoDag, r: ServeRequest, width_hint: int = 1,
                         bind: Callable[[TAO, ServeRequest], None]
                         | None = None,
                         n_chunks: int = 1,
                         kv_bytes: float = 0.0) -> TAO:
    """Append ``prefill(r) -> decode_0(r) -> decode_1(r) -> ...`` to ``dag``
    and return the chain's sink (the request's last decode burst).

    Decode is chunked into bursts of ``DECODE_UNIT`` tokens so the scheduler
    sees a stream of small memory-bound TAOs (the continuous-batching
    granularity).  ``TAO.work`` defaults to the simulator's unit-work
    multiplier; ``bind`` may attach real ``ChunkedWork`` payloads instead.
    ``n_chunks > 1`` stamps the *prefill* TAO with that many chunk
    boundaries (``TAO.n_chunks``), making the compute-heavy phase
    preemptible at chunk granularity — decode bursts are already small.

    ``kv_bytes > 0`` stamps the whole chain with ONE shared sticky
    :class:`~repro.core.dag.DataFootprint` of that many bytes — the
    request's KV cache.  Prefill materializes it on whatever cluster runs
    it; every decode burst then pins to that cluster (a decode placed
    elsewhere pays the modeled/measured cache move).  Zero keeps the chain
    footprint-free, i.e. the exact legacy scheduling path.
    """
    fp = DataFootprint(nbytes=kv_bytes, sticky=True) if kv_bytes > 0 else None
    pre = dag.add_task("prefill", width_hint=width_hint,
                       work=max(r.prompt_len / PREFILL_UNIT, 0.05))
    pre.n_chunks = max(1, n_chunks)
    pre.footprint = fp
    if bind:
        bind(pre, r)
    prev = pre
    remaining = r.gen_len
    while remaining > 0:
        burst = min(DECODE_UNIT, remaining)
        t = dag.add_task("decode", width_hint=width_hint,
                         work=max(burst / DECODE_UNIT, 0.05),
                         deps=[prev])
        t.footprint = fp
        if bind:
            bind(t, r)
        prev = t
        remaining -= burst
    return prev


def build_serving_dag(requests, width_hint: int = 1,
                      bind: Callable[[TAO, ServeRequest], None] | None = None
                      ) -> TaoDag:
    """All requests as one offline TAO-DAG (every chain a root at t=0).

    The workload-based entry points below are what serving actually runs;
    this builder remains for structure tests and single-DAG experiments.
    """
    dag = TaoDag()
    for r in requests:
        append_request_chain(dag, r, width_hint=width_hint, bind=bind)
    return dag


def build_serving_workload(requests, width_hint: int = 1,
                           bind: Callable[[TAO, ServeRequest], None]
                           | None = None,
                           n_chunks: int = 1,
                           kv_bytes_per_token: float = 0.0):
    """Request trace -> (``Workload``, ``dag_id -> ServeRequest`` map).

    One DAG per request, arriving at ``r.arrival`` under ``r.tenant`` and
    carrying ``r.tokens`` for the per-tenant throughput accounting.  When
    ``bind`` is given it is wrapped as a lazy ``DagArrival.bind`` — payload
    closures materialize only for *admitted* requests, on the admitting
    thread, so a gate-rejected request never builds its jitted closures.
    ``kv_bytes_per_token`` sizes each request's shared KV-cache footprint
    as ``r.tokens * kv_bytes_per_token`` (0.0 = footprint-free legacy path).
    """
    wl = Workload()
    by_dag: dict[int, ServeRequest] = {}
    for r in requests:
        dag = TaoDag()
        append_request_chain(dag, r, width_hint=width_hint,
                             n_chunks=n_chunks,
                             kv_bytes=r.tokens * kv_bytes_per_token)
        lazy = None
        if bind is not None:
            def lazy(d: TaoDag, r=r) -> None:
                for node in d.nodes:
                    bind(node, r)
        arr = wl.add(dag, at=r.arrival, name=f"req{r.id}", tenant=r.tenant,
                     tokens=r.tokens, bind=lazy)
        by_dag[arr.dag_id] = r
    return wl, by_dag


def bursty_serving_trace(n_steady: int = 40, steady_rate: float = 20.0,
                         n_burst: int = 60, burst_at: float = 0.5,
                         burst_rate: float = 400.0,
                         steady_prompts: Sequence[int] = (512, 1024, 2048),
                         steady_gens: Sequence[int] = (64, 128),
                         burst_prompts: Sequence[int] = (2048, 4096, 8192),
                         burst_gens: Sequence[int] = (128, 256),
                         seed: int = 0) -> list:
    """Two-tenant serving stress trace (the admission/preemption A/B input).

    Tenant ``steady`` is the latency-sensitive chat customer: a gentle
    Poisson stream of small prompts.  Tenant ``burst`` is the batch customer
    dumping large prompts in a tight window from ``burst_at`` — the spike
    that would otherwise blow the steady tenant's p99 sojourn.  This is the
    serving-shaped sibling of :func:`repro.core.dag_gen.bursty_workload`.
    """
    rng = random.Random(seed)
    reqs: list[ServeRequest] = []
    t = 0.0
    for i in range(n_steady):
        reqs.append(ServeRequest(
            id=i, prompt_len=rng.choice(list(steady_prompts)),
            gen_len=rng.choice(list(steady_gens)), arrival=t,
            tenant="steady"))
        t += rng.expovariate(steady_rate)
    t = burst_at
    for i in range(n_burst):
        reqs.append(ServeRequest(
            id=n_steady + i, prompt_len=rng.choice(list(burst_prompts)),
            gen_len=rng.choice(list(burst_gens)), arrival=t,
            tenant="burst"))
        t += rng.expovariate(burst_rate)
    return reqs


def serving_kernel_models() -> dict:
    """Calibrated serve-phase models (mirrors the paper's kernel classes).

    prefill: compute-bound, scales with width, big ~2.4x faster.
    decode:  HBM-BW bound, near-zero width scaling, big only ~1.6x faster
             (BW, not FLOPS, limited).
    """
    return {
        "prefill": KernelModel(
            t_ref=0.020,
            speed={BIG: 2.4, LITTLE: 1.0},
            efficiency={1: 1.0, 2: 0.95, 4: 0.9, 8: 0.85},
        ),
        "decode": KernelModel(
            t_ref=0.010,
            speed={BIG: 1.6, LITTLE: 1.0},
            efficiency={1: 1.0, 2: 0.55, 4: 0.3, 8: 0.16},
            stream=True,
            bw_cap={BIG: 2.0, LITTLE: 3.0},
        ),
    }


@dataclasses.dataclass
class ServeStats:
    """Per-run serving report, identical in shape for both vehicles.

    ``latencies`` maps request id -> *sojourn* (sink completion minus the
    request's own arrival — each request's chain sink is tracked through its
    private DAG, never through sink iteration order).  ``ptt_profiles`` maps
    TAO type -> ``{(leader, width): EWMA seconds}`` — calibrated-model times
    on the simulator, *measured* wall-clock kernel times on the threaded
    vehicle.
    """

    makespan: float
    tokens_per_s: float
    mean_latency: float
    p99_latency: float
    latencies: dict
    tokens_by_tenant: dict
    tokens_per_s_by_tenant: dict
    result: WorkloadResult
    ptt_profiles: dict = dataclasses.field(default_factory=dict)

    def p99_by_tenant(self) -> dict:
        """``tenant -> p99 sojourn`` over that tenant's completed requests."""
        return {tenant: percentile([s.sojourn for s in stats if s.done], 99)
                for tenant, stats in self.result.per_tenant().items()}


def ptt_profiles(core) -> dict:
    """Snapshot the learned profiles out of a scheduler core, tried cells
    only: ``{tao_type: {(leader, width): ewma_seconds}}`` for the implicit
    single-implementation case, with ``(leader, width, impl)`` keys for any
    non-default implementation variant the table has measured (multi-impl
    TAOs record into per-(class, impl) cells — see
    :meth:`repro.core.ptt.PTT.best_impl`)."""
    from .dag import DEFAULT_IMPL

    out: dict[str, dict] = {}
    # size the scan from the registry's own spec: a ShardedScheduler's
    # ``ptt`` is shard 0's registry, whose sub-spec can be narrower than
    # the scheduler-wide spec
    spec = core.ptt.spec
    for typ in core.ptt.types():
        table = core.ptt.table(typ)
        cells = {}
        for impl in table.impls():
            snap = table.snapshot(impl=impl)
            for wi, width in enumerate(spec.widths):
                for worker in range(spec.n_workers):
                    t = float(snap[worker, wi])
                    if t > 0.0:
                        key = ((worker, width) if impl == DEFAULT_IMPL
                               else (worker, width, impl))
                        cells[key] = t
        out[typ] = cells
    return out


def _stats_from(res: WorkloadResult, by_dag: dict, core) -> ServeStats:
    lat = {by_dag[did].id: st.sojourn
           for did, st in res.per_dag.items() if st.done}
    vals = sorted(lat.values())
    elapsed = res.makespan
    return ServeStats(
        makespan=elapsed,
        # guard: an all-rejected / empty / instant run must report 0, not
        # raise ZeroDivisionError (and near-zero elapsed would report junk)
        tokens_per_s=(res.tokens_done() / elapsed
                      if elapsed > 1e-9 else 0.0),
        mean_latency=sum(vals) / len(vals) if vals else float("nan"),
        p99_latency=percentile(vals, 99),
        latencies=lat,
        tokens_by_tenant=res.tokens_by_tenant(),
        tokens_per_s_by_tenant=res.token_throughput_by_tenant(),
        result=res,
        ptt_profiles=ptt_profiles(core),
    )


def simulate_serving(requests, spec: ClusterSpec, policy: Policy,
                     width_hint: int = 1, seed: int = 0,
                     admission=None, preemption=None,
                     n_chunks: int = 1,
                     kv_bytes_per_token: float = 0.0,
                     **sim_kwargs) -> ServeStats:
    """Calibrated-model serving of a request trace on the simulator.

    ``admission`` / ``preemption`` are the same gate/controller objects the
    generic workload benches use; ``n_chunks`` makes prefill TAOs
    preemptible at chunk granularity.  ``kv_bytes_per_token > 0`` turns on
    KV-cache affinity: decode bursts pin to the cluster that ran their
    prefill and off-resident placements pay the modeled transfer time.
    Extra ``sim_kwargs`` forward to the Simulator constructor (e.g.
    ``n_shards`` for sharded scheduling).
    """
    wl, by_dag = build_serving_workload(requests, width_hint=width_hint,
                                        n_chunks=n_chunks,
                                        kv_bytes_per_token=kv_bytes_per_token)
    sim = Simulator(spec, policy, kernel_models=serving_kernel_models(),
                    seed=seed, **sim_kwargs)
    res = sim.run_workload(wl, admission=admission, preemption=preemption)
    return _stats_from(res, by_dag, sim.core)


def run_serving_workload_threaded(requests, spec: ClusterSpec, policy: Policy,
                                  binder: Callable[[TAO, ServeRequest], None],
                                  seed: int = 0, timeout_s: float = 300.0,
                                  admission=None, preemption=None,
                                  runtime: ThreadedRuntime | None = None,
                                  kv_bytes_per_token: float = 0.0
                                  ) -> ServeStats:
    """Real execution: the general entry point — ``binder(tao, r)`` attaches
    each TAO's ``ChunkedWork`` payload (jitted kernel calls; chunked prefill
    gives the preemption controllers real yield points).  Binding happens
    lazily per admitted request on the admitter thread (``DagArrival.bind``).

    Pass ``runtime`` to reuse a warm pool (and its learned PTT) across
    consecutive traces; by default a fresh ``ThreadedRuntime`` is built.
    Returns the same ``ServeStats`` shape as :func:`simulate_serving`, with
    ``ptt_profiles`` holding *measured* per-(class, width) kernel times.
    ``kv_bytes_per_token`` sizes KV-cache footprints exactly as on the
    simulator — here a cache miss pays a *measured* host byte-copy.
    """
    wl, by_dag = build_serving_workload(requests, bind=binder,
                                        kv_bytes_per_token=kv_bytes_per_token)
    rt = runtime if runtime is not None else ThreadedRuntime(spec, policy,
                                                             seed=seed)
    res = rt.run_workload(wl, timeout_s=timeout_s, admission=admission,
                          preemption=preemption)
    return _stats_from(res, by_dag, rt.core)


def run_serving_threaded(requests, spec: ClusterSpec, policy: Policy,
                         prefill_fn: Callable[[ServeRequest], None],
                         decode_fn: Callable[[ServeRequest, int], None],
                         seed: int = 0, timeout_s: float = 300.0,
                         admission=None, preemption=None,
                         runtime: ThreadedRuntime | None = None
                         ) -> ServeStats:
    """Real execution with the classic two-callable payload: each prefill
    TAO calls ``prefill_fn(r)`` once, each decode burst calls
    ``decode_fn(r, i)`` (``i`` the chunk index).  See
    :func:`run_serving_workload_threaded` for custom chunked binders."""
    def binder(tao: TAO, r: ServeRequest) -> None:
        if tao.type == "prefill":
            tao.work = ChunkedWork(lambda i, r=r: prefill_fn(r), 1)
        else:
            tao.work = ChunkedWork(lambda i, r=r: decode_fn(r, i), 1)

    return run_serving_workload_threaded(
        requests, spec, policy, binder, seed=seed, timeout_s=timeout_s,
        admission=admission, preemption=preemption, runtime=runtime)
