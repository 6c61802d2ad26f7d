"""Multi-tenant scheduling: concurrent DAGs arriving online over one pool.

The paper evaluates one DAG at a time; a production pool serves a *stream*.
This example admits a Poisson stream of mixed-mode DAGs (serial pipelines
next to wide fan-outs) into a single 64-worker heterogeneous fleet, runs it
under several policies, and prints the per-tenant latency table the
workload engine keeps: arrival, queueing delay, makespan, and sojourn
(completion - arrival — what the tenant actually experiences).

Criticality is namespaced per DAG, so a 5-node tenant's root still counts
as critical while a 3000-node tenant holds criticality values in the
hundreds.

The admission demo shows the other half of multi-tenancy: an SLO-aware
gate (``repro_torch.core.admission``) throttling a bursty batch tenant so a
small latency-bound tenant's p99 stays flat.  The preemption demo at the
end goes one step further — the gate only touches *arrivals*, while the
``backlog`` controller (``repro_torch.core.preemption``) stops the dominant
tenant's *running* TAOs at chunk boundaries and hands their slots to the
steady tenant, recovering its sojourn even for work already in flight.

Twin of ``examples/multi_tenant.py`` through ``repro_torch.core``: the same
simulator and seeds print the same tables (the threaded demo's times are
wall-clock).

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_tenant
"""
import math

from ..core import (BIG, LITTLE, ImplVariant, KernelModel, Simulator,
                    ThreadedRuntime, Workload, bursty_workload, fleet,
                    hikey960, make_gate, make_policy, make_preemption,
                    paper_kernel_models, percentile, random_dag,
                    random_workload)


def _fmt(v: float, scale: float = 1.0, unit: str = "s") -> str:
    """A DAG that never started/finished has nan latencies: print '-'."""
    if math.isnan(v):
        return "-"
    return f"{v * scale:.3f}{unit}"


def _print_table(res) -> None:
    for st in res.per_dag.values():
        print(f"    {st.name:14s} arrival={st.arrival:.3f}s "
              f"queue={_fmt(st.queue_delay, 1e3, 'ms'):>9s} "
              f"makespan={_fmt(st.makespan):>8s} "
              f"sojourn={_fmt(st.sojourn):>8s}")


def trace_driven_demo() -> None:
    """Explicit trace: a big batch job, then two small latency-bound DAGs."""
    batch = random_dag(600, target_degree=8.06, seed=0, width_hint=1)
    small_a = random_dag(30, target_degree=1.62, seed=1, width_hint=1)
    small_b = random_dag(30, target_degree=1.62, seed=2, width_hint=1)
    wl = Workload.from_trace([
        (0.00, batch, "batch-600"),
        (0.05, small_a, "interactive-a"),
        (0.10, small_b, "interactive-b"),
    ])
    print("== trace-driven: one batch tenant + two interactive tenants ==")
    for policy in ("homogeneous", "crit-aware", "molding:adaptive"):
        res = Simulator(fleet(48, 16), make_policy(policy),
                        seed=0).run_workload(wl)
        print(f"\n  policy={policy}  (makespan={res.makespan:.3f}s, "
              f"util={res.utilization:.1%})")
        _print_table(res)


def threaded_vehicle_demo() -> None:
    """The same Workload abstraction on the *threaded* runtime: DAGs are
    admitted by a timer thread at real wall-clock offsets into the live
    8-worker pool (TAOs carry no payload here, so chunks are no-ops —
    what's exercised is the online DPA/assembly-queue machinery)."""
    wl = Workload.from_trace([
        (0.00, random_dag(40, target_degree=3.03, seed=3), "stream-a"),
        (0.02, random_dag(12, target_degree=1.62, seed=4), "stream-b"),
        (0.05, random_dag(12, target_degree=1.62, seed=5), "stream-c"),
    ])
    print("\n== threaded vehicle: same stream, real worker threads ==")
    rt = ThreadedRuntime(hikey960(), make_policy("molding:adaptive"), seed=0)
    res = rt.run_workload(wl, timeout_s=60.0)
    print(f"  makespan={res.makespan:.3f}s completed={res.completed} "
          f"util={res.utilization:.1%}")
    _print_table(res)


def poisson_stream_demo() -> None:
    """Synthetic online load: 12 mixed-degree DAGs, Poisson arrivals."""
    print("\n== Poisson stream: 12 tenants, mixed parallelism degrees ==")
    print(f"  {'policy':18s} {'p50':>8s} {'p99':>8s} {'mean':>8s}")
    for policy in ("homogeneous", "weight", "adaptive", "molding:adaptive"):
        wl = random_workload(n_dags=12, rate=4.0, n_tasks=120, seed=7)
        res = Simulator(fleet(48, 16), make_policy(policy),
                        seed=1).run_workload(wl)
        print(f"  {policy:18s} {res.sojourn_p50():8.4f} "
              f"{res.sojourn_p99():8.4f} {res.mean_sojourn():8.4f}")


def admission_control_demo() -> None:
    """SLO-aware backpressure: tenant ``burst`` dumps 14 large DAGs half a
    second into tenant ``steady``'s gentle stream.  Ungated, the burst
    inflates the steady tenant's p99 several-fold; the ``slo-adaptive``
    gate sees the burst's backlog dominate the pool and holds its DAGs at
    the door (releasing them as load drains), keeping the steady tenant's
    latency flat without shrinking total goodput."""
    print("\n== admission control: bursty batch tenant vs 0.5s-SLO tenant ==")
    slo = {"steady": 0.5, "burst": 3.0}

    def run(gate):
        sim = Simulator(fleet(48, 16), make_policy("molding:adaptive"),
                        seed=1)
        return sim.run_workload(bursty_workload(seed=1), admission=gate)

    for name in ("none", "slo-adaptive"):
        gate = make_gate(name) if name == "none" else make_gate(
            name, slo=slo["steady"], slo_per_tenant={"burst": slo["burst"]})
        res = run(gate)
        print(f"\n  admission={name}  (goodput={res.goodput(slo)} of "
              f"{len(res.per_dag)} DAGs within SLO, "
              f"makespan={res.makespan:.3f}s)")
        for tenant, stats in res.per_tenant().items():
            so = [s.sojourn for s in stats if s.done]
            delayed = [s for s in stats
                       if s.was_admitted and s.admission_delay > 1e-9]
            rejected = sum(1 for s in stats if s.rejected)
            print(f"    {tenant:7s} SLO={slo[tenant]:.1f}s "
                  f"p50={_fmt(percentile(so, 50))} "
                  f"p99={_fmt(percentile(so, 99))} "
                  f"delayed={len(delayed)} rejected={rejected}")


def preemption_demo() -> None:
    """Chunk-granularity preemption: the ``backlog`` controller displaces
    the dominant tenant's *running* TAOs.  The stream is the same bursty
    two-tenant workload, but every TAO carries 4 chunk boundaries
    (``n_chunks=4``) — the yield points where a running TAO can be
    stopped, its unclaimed chunks repackaged as a continuation and
    re-admitted with molding free to pick a new (leader, width).  On top
    of the slo-adaptive gate the controller cuts the steady tenant's p99
    further; the displacement ledger shows the burst tenant's running
    DAGs being stopped while the steady tenant is never the victim."""
    print("\n== preemption: displacing the burst tenant's *running* TAOs ==")
    slo = {"steady": 0.5, "burst": 3.0}

    def run(ctrl):
        sim = Simulator(fleet(48, 16), make_policy("molding:adaptive"),
                        seed=1)
        gate = make_gate("slo-adaptive", slo=slo["steady"],
                         slo_per_tenant={"burst": slo["burst"]})
        return sim.run_workload(bursty_workload(seed=1, n_chunks=4),
                                admission=gate, preemption=ctrl)

    for name in ("none", "backlog"):
        ctrl = None if name == "none" else make_preemption(name)
        res = run(ctrl)
        print(f"\n  preemption={name}  (goodput={res.goodput(slo)}, "
              f"displacements={res.n_preemptions}, "
              f"makespan={res.makespan:.3f}s)")
        displaced = res.preemptions_by_tenant()
        for tenant, stats in res.per_tenant().items():
            so = [s.sojourn for s in stats if s.done]
            print(f"    {tenant:7s} p50={_fmt(percentile(so, 50))} "
                  f"p99={_fmt(percentile(so, 99))} "
                  f"displaced={displaced.get(tenant, 0)}")
        if res.n_preemptions:
            worst = max(res.per_dag.values(),
                        key=lambda s: s.preempted_count)
            print(f"    most-displaced DAG: {worst.name} "
                  f"({worst.tenant}) stopped {worst.preempted_count}x, "
                  f"continuations waited {worst.preemption_delay*1e3:.1f}ms "
                  f"total")


def impl_variant_demo() -> None:
    """Implementation-variant TAOs: every matmul carries two builds — a
    ``ref`` kernel that is the faster one on LITTLE cores and a ``vector``
    build that pays off on big ones — and the scheduler picks the build
    *jointly* with (leader, width) from per-(class, impl) PTT cells.  The
    joint run is compared against forcing either build everywhere, then the
    learned per-(class, impl, width) profile is printed: the divergence per
    cluster is the thing no static choice can express."""
    print("\n== implementation variants: joint (impl, width, leader) "
          "placement ==")
    models = paper_kernel_models()
    eff = {1: 1.0, 2: 0.98, 4: 0.96, 8: 0.94}
    models[("matmul", "ref")] = KernelModel(
        t_ref=0.010, speed={BIG: 2.4, LITTLE: 1.0}, efficiency=eff)
    models[("matmul", "vector")] = KernelModel(
        t_ref=0.010, speed={BIG: 3.4, LITTLE: 0.7}, efficiency=eff)

    spec = hikey960()
    sim = Simulator(spec, make_policy("molding:adaptive"),
                    kernel_models=models, seed=1)
    for leg in ("ref", "vector", "joint"):
        chosen = ("ref", "vector") if leg == "joint" else (leg,)
        wl = random_workload(n_dags=4, rate=4.0, n_tasks=80, seed=2,
                             width_hint=2,
                             impls={"matmul": [ImplVariant(n)
                                               for n in chosen]})
        res = sim.run_workload(wl)
        print(f"  {leg:7s} makespan={res.makespan:.3f}s "
              f"p99={res.sojourn_p99():.3f}s")
        if leg != "joint":
            sim.reset_learning()   # each leg learns from scratch

    print("  learned per-(class, impl, width) profile (joint leg):")
    ptt = sim.core.ptt
    for typ in sorted(ptt.types()):
        table = ptt.table(typ)
        for impl in sorted(table.impls()):
            for width in spec.widths:
                tried = [(table.time(ld, width, impl=impl), ld)
                         for ld in range(spec.n_workers)
                         if table.time(ld, width, impl=impl) > 0.0]
                if not tried:
                    continue
                best_t, best_l = min(tried)
                cls = spec.classes[best_l]
                print(f"    PTT[{typ}][{impl}] w={width}: {len(tried)} "
                      f"cells, best {best_t * 1e3:.2f} ms @ leader "
                      f"{best_l} ({cls})")


def main() -> None:
    trace_driven_demo()
    poisson_stream_demo()
    threaded_vehicle_demo()
    admission_control_demo()
    preemption_demo()
    impl_variant_demo()


if __name__ == "__main__":
    main()
