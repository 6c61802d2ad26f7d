"""The one general generator of the benchmark's traffic.  A mix is a data file
``bench/traffic/<name>.json``; its ``kind`` names one of the generators below
and the rest of the file holds its parameters.  Every draw comes from the
run's ``--seed``: the same seed gives the same traffic.

``closed_dag``: one DAG in flight at a time, DAG k of a run being the
paper's layered random DAG (Topcuoglu et al.'s method, as the paper builds
its 3000-TAO DAGs) drawn from (seed, k).  So that seeds change the DAG and
not its amount of parallelism, every seed gets the same set of layer widths,
in an order of its own.
"""
from __future__ import annotations

import hashlib
import math
import random

KINDS = ("closed_dag",)


def sub_seed(seed: int, *labels) -> int:
    """A 63-bit seed drawn from ``seed`` and ``labels``: every stream of a run
    its own, and the same for the same seed."""
    h = hashlib.sha256(repr((int(seed),) + labels).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def layer_widths(n_tasks: int, degree: float) -> list:
    """round(n_tasks / degree) layer widths that sum to ``n_tasks``, so the
    DAG's degree is ``degree`` to within its rounding: the layers' quantiles
    of a uniform on [1, 2 degree - 1] (whose mean is the degree), scaled to
    the sum and rounded by largest remainders, in ascending order."""
    if degree < 1.0:
        raise ValueError("degree must be >= 1")
    n_layers = max(1, min(n_tasks, round(n_tasks / degree)))
    xs = [1.0 + (i + 0.5) / n_layers * (2.0 * degree - 2.0)
          for i in range(n_layers)]
    scale = n_tasks / sum(xs)
    xs = [x * scale for x in xs]
    widths = [max(1, math.floor(x)) for x in xs]
    short = sorted(range(n_layers), key=lambda i: widths[i] - xs[i])
    for i in short[:n_tasks - sum(widths)]:
        widths[i] += 1
    while sum(widths) > n_tasks:    # layers of width 1 rounded up
        widths[widths.index(max(widths))] -= 1
    return widths


def random_dag(n_tasks: int, target_degree: float, seed: int, *,
               kernel_types=("matmul", "sort", "copy"),
               max_extra_parents: int = 2, jump_prob: float = 0.15,
               max_jump: int = 3):
    """The paper's layered random DAG (its section 4.3) as the program's
    ``TaoDag``, of parallelism degree d = TAOs / critical path: the widths of
    ``layer_widths``, in an order drawn from the seed; equal thirds of each
    kernel type, shuffled; every node one parent in the previous layer (so
    the critical path runs through every layer), up to
    ``max_extra_parents`` more, and with ``jump_prob`` an edge from up to
    ``max_jump`` layers further back."""
    from repro_torch.core.dag import TaoDag

    rng = random.Random(seed)
    dag = TaoDag()
    widths = layer_widths(n_tasks, target_degree)
    rng.shuffle(widths)
    types = []
    base, rem = divmod(n_tasks, len(kernel_types))
    for i, kt in enumerate(kernel_types):
        types.extend([kt] * (base + (1 if i < rem else 0)))
    rng.shuffle(types)
    it = iter(types)
    layers = [[dag.add_task(next(it)) for _ in range(w)] for w in widths]
    for li in range(1, len(layers)):
        prev = layers[li - 1]
        for node in layers[li]:
            parents = {rng.choice(prev)}
            for _ in range(rng.randint(0, max_extra_parents)):
                parents.add(rng.choice(prev))
            if li >= 2 and rng.random() < jump_prob:
                src = layers[max(0, li - 1 - rng.randint(1, max_jump))]
                parents.add(rng.choice(src))
            for p in sorted(parents, key=lambda t: t.id):
                dag.add_edge(p, node)
    return dag


def closed_dag(mix: dict, seed: int):
    """DAG k of the run, for k = 0, 1, ...: ``dag(k)``; ``dag("warm")`` the
    one set-up runs, of ``warm_tasks`` TAOs."""
    def dag(k):
        n = mix["warm_tasks"] if k == "warm" else mix["n_tasks"]
        return random_dag(n, mix["degree"], sub_seed(seed, "dag", k))
    return dag
