"""Runs of a cell that set its limits, outside the benchmark's own runs:
several seeds in one process on the card.

    python3 bench/tools.py controls --workload <cell> --seeds 1,2 --seconds 20
        each seed: the numbers the run's answers were judged by, and the same
        numbers of the control (the plain reference one precision lower, in
        the program's place), as one JSON line a seed
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import main as M  # noqa: E402


def controls(args) -> None:
    import torch
    b = M.benchmark()
    cell, config, mix = M.cell_files(b, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = M.Run(cell, config, mix, seed, args.seconds, False,
                    torch.device("cuda", 0), time.perf_counter(),
                    control=True)
        obs = M.driver(config["driver"]).run(run)
        print(json.dumps({"seed": seed, "program": obs["checks"],
                          "control": obs["control_checks"],
                          "attempted": obs["attempted"],
                          "failed": obs["failed"]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("controls",))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="1,2,3")
    args = ap.parse_args(argv)
    M.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    controls(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
