"""Randomized TAO-DAG generation (paper §4.3).

The paper follows the generator methodology of Topcuoglu et al. [HEFT, 2002]:
layered random DAGs controlled by a width ("fat") parameter, edge density and
jump edges, producing irregular graphs.  Three DAGs of 3000 TAOs (1000 per
kernel type) with parallelism degrees 1.62 / 3.03 / 8.06 are evaluated.

Parallelism degree (paper §4.4) is ``#TAOs / Cp`` with Cp the critical-path
length in nodes.  In a layered DAG where consecutive layers are connected,
Cp equals the number of layers, so the *mean layer width* directly controls
the degree.  ``random_dag(..., target_degree=d)`` draws layer widths with
mean ≈ d, then verifies the achieved degree.
"""
from __future__ import annotations

import random
from typing import Sequence

from .dag import TAO, ImplVariant, TaoDag


def _impls_for(impls, kernel_type: str):
    """Resolve a generator ``impls`` argument for one node's kernel type.

    ``impls`` may be a flat sequence of :class:`ImplVariant` (every node
    carries the same alternatives) or a mapping ``kernel_type -> sequence``
    (per-class alternatives; types absent from the mapping stay
    single-variant).  Attaching variants never consumes RNG state, so a
    generator call with and without ``impls`` builds the same topology."""
    if not impls:
        return ()
    if isinstance(impls, dict):
        return tuple(impls.get(kernel_type, ()))
    return tuple(impls)

KERNEL_TYPES = ("matmul", "sort", "copy")  # paper's three TAO classes


def random_dag(
    n_tasks: int = 3000,
    target_degree: float = 3.0,
    kernel_types: Sequence[str] = KERNEL_TYPES,
    seed: int = 0,
    width_hint: int = 1,
    max_extra_parents: int = 2,
    jump_prob: float = 0.15,
    max_jump: int = 3,
    impls=(),
) -> TaoDag:
    """Layered Topcuoglu-style random DAG with ``n_tasks`` nodes.

    * layer widths ~ Uniform{1, .., 2*target_degree-1} (mean = target_degree)
    * every node in layer i+1 has >=1 parent in layer i (keeps Cp == #layers)
    * extra same-layer-distance and jump edges add irregularity
    * kernel types are assigned in equal proportions, shuffled (paper: 1000
      of each of matmul/sort/copy for n=3000).
    """
    if target_degree < 1.0:
        raise ValueError("target_degree must be >= 1")
    rng = random.Random(seed)
    dag = TaoDag()

    # --- draw layer widths until we have n_tasks nodes -----------------------
    widths: list[int] = []
    total = 0
    hi = max(1, int(round(2 * target_degree - 1)))
    while total < n_tasks:
        w = rng.randint(1, hi)
        w = min(w, n_tasks - total)
        widths.append(w)
        total += w

    # --- equal-proportion kernel type assignment ----------------------------
    types: list[str] = []
    base, rem = divmod(n_tasks, len(kernel_types))
    for i, kt in enumerate(kernel_types):
        types.extend([kt] * (base + (1 if i < rem else 0)))
    rng.shuffle(types)
    it = iter(types)

    # --- build layers --------------------------------------------------------
    layers: list[list[TAO]] = []
    for w in widths:
        layer = []
        for _ in range(w):
            kt = next(it)
            layer.append(dag.add_task(kt, width_hint=width_hint,
                                      impls=_impls_for(impls, kt)))
        layers.append(layer)

    for li in range(1, len(layers)):
        prev = layers[li - 1]
        for node in layers[li]:
            # mandatory parent in the previous layer -> Cp == #layers
            parents = {rng.choice(prev)}
            for _ in range(rng.randint(0, max_extra_parents)):
                parents.add(rng.choice(prev))
            # occasional jump edge from an earlier layer (irregularity)
            if li >= 2 and rng.random() < jump_prob:
                src_layer = layers[max(0, li - 1 - rng.randint(1, max_jump))]
                parents.add(rng.choice(src_layer))
            for p in parents:
                dag.add_edge(p, node)

    dag.assign_criticality()
    return dag


def paper_dags(n_tasks: int = 3000, width_hint: int = 1, seed: int = 0):
    """The three evaluation DAGs (degrees ~1.62, ~3.03, ~8.06).

    Targets are matched by construction (mean layer width == degree); the
    achieved degree of each generated instance is within a few percent and is
    reported by callers (benchmarks print it).
    """
    return {
        1.62: random_dag(n_tasks, target_degree=1.62, seed=seed, width_hint=width_hint),
        3.03: random_dag(n_tasks, target_degree=3.03, seed=seed + 1, width_hint=width_hint),
        8.06: random_dag(n_tasks, target_degree=8.06, seed=seed + 2, width_hint=width_hint),
    }


def random_workload(
    n_dags: int = 8,
    rate: float = 2.0,
    n_tasks: int = 150,
    degrees: Sequence[float] = (1.62, 3.03, 8.06),
    kernel_types: Sequence[str] = KERNEL_TYPES,
    seed: int = 0,
    width_hint: int = 1,
    impls=(),
):
    """A multi-tenant arrival stream of mixed random DAGs.

    ``n_dags`` Topcuoglu-style DAGs of ``n_tasks`` nodes each, with
    parallelism degrees drawn uniformly from ``degrees``, arriving as a
    Poisson process of ``rate`` DAGs/s (first DAG at t=0).  Each DAG gets an
    independent structure seed, so the stream mixes serial and parallel
    tenants the way a shared pool would see them.
    """
    from .workload import Workload

    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = random.Random(seed)
    wl = Workload()
    t = 0.0
    # label with the dag_id the fresh Workload will assign (sequential from
    # 1) so names, per_dag keys and TraceRecord.dag_id line up in reports
    for i in range(1, n_dags + 1):
        degree = rng.choice(list(degrees))
        dag = random_dag(n_tasks, target_degree=degree,
                         kernel_types=kernel_types,
                         seed=rng.randrange(2 ** 31), width_hint=width_hint,
                         impls=impls)
        wl.add(dag, at=t, name=f"dag{i}(deg={degree})")
        t += rng.expovariate(rate)
    return wl


def bursty_workload(
    n_steady: int = 10,
    steady_rate: float = 2.0,
    steady_tasks: int = 60,
    n_burst: int = 14,
    burst_at: float = 0.5,
    burst_rate: float = 100.0,
    burst_tasks: int = 150,
    degrees: Sequence[float] = (1.62, 3.03, 8.06),
    seed: int = 0,
    width_hint: int = 1,
    n_chunks: int = 1,
    impls=(),
):
    """Two-tenant admission-control stress stream.

    Tenant ``steady`` submits ``n_steady`` small DAGs as a gentle Poisson
    process (``steady_rate`` DAGs/s from t=0) — the latency-sensitive
    customer whose sojourn an SLO protects.  Tenant ``burst`` dumps
    ``n_burst`` larger DAGs in a tight window starting at ``burst_at``
    (inter-arrivals ~ Exp(``burst_rate``), i.e. effectively all at once) —
    the batch customer whose spike would otherwise blow the steady
    tenant's p99.  Admission gates key on ``DagArrival.tenant``, so this
    is the canonical input for demonstrating per-tenant backpressure.

    ``n_chunks > 1`` stamps every TAO with that many chunk boundaries
    (``TAO.n_chunks``), making the stream *preemptible* at chunk
    granularity — the canonical input for the preemption controllers
    too.  The default (1) leaves TAOs monolithic, exactly as before.
    """
    from .workload import Workload

    rng = random.Random(seed)
    wl = Workload()
    t = 0.0
    for i in range(1, n_steady + 1):
        dag = random_dag(steady_tasks, target_degree=rng.choice(list(degrees)),
                         seed=rng.randrange(2 ** 31), width_hint=width_hint,
                         impls=impls)
        for node in dag.nodes:
            node.n_chunks = n_chunks
        wl.add(dag, at=t, name=f"steady{i}", tenant="steady")
        t += rng.expovariate(steady_rate)
    t = burst_at
    for i in range(1, n_burst + 1):
        dag = random_dag(burst_tasks, target_degree=rng.choice(list(degrees)),
                         seed=rng.randrange(2 ** 31), width_hint=width_hint,
                         impls=impls)
        for node in dag.nodes:
            node.n_chunks = n_chunks
        wl.add(dag, at=t, name=f"burst{i}", tenant="burst")
        t += rng.expovariate(burst_rate)
    return wl
