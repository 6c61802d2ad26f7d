#!/usr/bin/env python3
"""Dry-run cells of two or more runs side by side, as a Markdown table.

Each run is the ``--out`` directory of ``python -m repro_torch.launch.dryrun``
(``<dir>/<mesh>/<arch>__<shape>.json``), named on the command line as
``label=dir``.  A row is a cell that every run holds, a column a run; the
last column is the last run over the first (or over ``--base``), less
one.  Byte metrics are
a device's, FLOPs the world's (``flops``) or a device's
(``flops_per_device``).  Cells that are not ``ok`` in every run are listed
under the table with their statuses.

Usage:
  python tools/dryrun_table.py parent=experiments/a change=experiments/b \\
      [--metric temp] [--metric all-reduce] [--mesh single_pod] \\
      [--shape train_4k] [--gib] [--base parent]

Metrics: ``collectives`` (the sum of every kind's bytes), each kind of
``dryrun.COLLECTIVES``, ``count`` (collectives issued), ``temp``,
``arguments``, ``flops``, ``flops_per_device``.
"""
from __future__ import annotations

import argparse
import json
import pathlib

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
BYTES = ("collectives", *KINDS, "temp", "arguments")


def value(cell: dict, metric: str):
    coll = cell["collectives"]
    if metric == "collectives":
        return sum(coll[k] for k in KINDS)
    if metric in KINDS or metric == "count":
        return coll[metric]
    if metric == "temp":
        return cell["memory"]["temp_size_bytes"]
    if metric == "arguments":
        return cell["memory"]["argument_size_bytes"]
    if metric == "flops":
        return cell["matmul_flops"]
    if metric == "flops_per_device":
        return cell["matmul_flops_per_device"]
    raise ValueError(metric)


def load(root: pathlib.Path, mesh: str | None, shape: str | None) -> dict:
    """(mesh, arch, shape) -> the cell's record, every JSON under
    ``root``."""
    out = {}
    for path in sorted(root.glob("*/*__*.json")):
        rec = json.loads(path.read_text())
        key = (path.parent.name, rec["arch"], rec["shape"])
        if (mesh is None or key[0] == mesh) and \
                (shape is None or key[2] == shape):
            out[key] = rec
    return out


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LABEL=DIR")
    ap.add_argument("--metric", action="append")
    ap.add_argument("--mesh", choices=("single_pod", "multi_pod"))
    ap.add_argument("--shape")
    ap.add_argument("--base", help="the run the last column divides by "
                    "(default: the first)")
    ap.add_argument("--gib", action="store_true",
                    help="byte metrics in GiB (2**30 B), unrounded")
    args = ap.parse_args(argv)
    metrics = args.metric or ["collectives", "count", "temp", "flops"]
    runs = {}
    for spec in args.runs:
        label, _, root = spec.partition("=")
        runs[label] = load(pathlib.Path(root), args.mesh, args.shape)
    labels = list(runs)
    base = labels.index(args.base) if args.base else 0
    keys = sorted(set.intersection(*(set(r) for r in runs.values())))
    lines = [f"| cell | metric | {' | '.join(labels)} | "
             f"{labels[-1]} / {labels[base]} |",
             "|---|---|" + "---|" * (len(labels) + 1)]
    odd = []
    for key in keys:
        recs = [runs[label][key] for label in labels]
        if any(r["status"] != "ok" for r in recs):
            odd.append((key, [r["status"] for r in recs]))
            continue
        name = f"{'2x16x16' if key[0] == 'multi_pod' else '16x16'} " \
               f"{key[1]} `{key[2]}`"
        for metric in metrics:
            vals = [value(r, metric) for r in recs]
            shown = [v / 2 ** 30 if args.gib and metric in BYTES else v
                     for v in vals]
            change = (f"{vals[-1] / vals[base] - 1:+.4%}" if vals[base]
                      else "n/a")
            lines.append(f"| {name} | {metric} | "
                         f"{' | '.join(str(v) for v in shown)} | {change} |")
    for key, statuses in odd:
        lines.append(f"\n{key}: {dict(zip(labels, statuses))}")
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main()
