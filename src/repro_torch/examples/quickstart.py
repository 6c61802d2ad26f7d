"""Quickstart: the paper's heterogeneous mixed-mode scheduling in 60 lines.

Builds the paper's evaluation setup — randomized mixed-mode DAGs of
matmul/sort/copy TAOs on a 4 big + 4 LITTLE pool — and compares random work
stealing against the heterogeneous schedulers + task molding (PTT-driven).

Twin of ``examples/quickstart.py`` through ``repro_torch.core``: the same
simulator and seeds print the same table.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from ..core import Simulator, hikey960, make_policy, random_dag

SPEC = hikey960()                     # the paper's HiKey960: 4x A53 + 4x A73
POLICIES = ("homogeneous",            # base case: random work stealing
            "crit-aware",             # CATS-style, knows big/LITTLE
            "crit-ptt",               # CATS-style, learns from the PTT
            "weight",                 # Bias-style speedup threshold
            "molding:weight")         # + PTT task molding


def main() -> None:
    for degree in (1.62, 3.03, 8.06):
        dag_of = lambda: random_dag(3000, target_degree=degree,
                                    seed=int(degree * 100), width_hint=1)
        print(f"\n=== randomized DAG, parallelism degree {degree} "
              f"(achieved {dag_of().parallelism_degree():.2f}) ===")
        base = None
        for policy in POLICIES:
            res = Simulator(SPEC, make_policy(policy), seed=1).run(dag_of())
            base = base or res.throughput
            print(f"  {policy:18s} {res.throughput:7.1f} TAOs/s  "
                  f"(x{res.throughput / base:.2f} vs RWS)  "
                  f"util {res.utilization:.0%}")


if __name__ == "__main__":
    main()
