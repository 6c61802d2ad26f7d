"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, times each at the main path's shapes, and
drives the main path at full size: the paper's 3000-TAO mixed-mode DAG on
``ThreadedRuntime`` under the policies ``homogeneous`` and ``molding:weight``.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Every phase prints one JSON line.  Any failed check raises, and the script
exits with a code other than 0; it does the same without a CUDA device.  The
line before the last lists every kernel with its launches in each policy's
run (``launches`` is the smaller), its error and its times; the last line
names the card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the port from this checkout; in a directory without it the import fails
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import kernels, mixed_mode  # noqa: E402
from repro_torch.core import random_dag  # noqa: E402
from repro_torch.kernels import _build, copy_stream, ops, ref  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM's rate and its operations over
# the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

N_TASKS, DEGREE, SEED = 3000, 3.03, 1
PTT_FLOOR = 0.8  # a PTT time must cover this share of its kernel's time
REPS, WARMUP = 30, 5

# kernel -> (source, the Pallas kernel it replaces, the DAG class it serves)
KERNELS = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:63", "matmul"),
    "copy": ("src/repro_torch/kernels/csrc/copy_stream.cu",
             "src/repro/kernels/copy_stream.py:37", "copy"),
    "sort_rows": ("src/repro_torch/kernels/csrc/sort_bitonic.cu",
                  "src/repro/kernels/sort_bitonic.py:62", "sort"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def tensor(shape, dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        a = rng.integers(-1000, 1000, shape, dtype=np.int32)
    else:
        a = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a).to(device="cuda", dtype=dtype)


def phase_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "load_s": time.perf_counter() - t0, "build_s": _build.build_seconds,
          "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]})


def phase_kernels() -> dict:
    """Each kernel against its plain version on the card, at the shapes of
    tests/test_kernels.py and of the main path.  matmul within that file's
    tolerances (rtol=tol, atol=10*tol); copy and sort bit-exact."""
    before = kernels.launch_counts()
    err = {name: 0.0 for name in KERNELS}
    main_err = {}
    cases = 0
    for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 2e-2)):
        for m, k, n, bm, bn, bk in ((128, 128, 128, 128, 128, 128),
                                    (256, 384, 256, 128, 128, 128),
                                    (256, 256, 512, 128, 256, 64),
                                    (512, 128, 128, 256, 128, 128),
                                    (2048, 2048, 2048, 128, 128, 128)):
            x, y = tensor((m, k), dtype, 1), tensor((k, n), dtype, 2)
            got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk).float()
            want = ref.matmul(x, y).float()
            diff = (got - want).abs()
            if not bool((diff <= 10 * tol + tol * want.abs()).all()):
                raise AssertionError(f"matmul {dtype} ({m},{k},{n}): max abs "
                                     f"err {diff.max().item()}")
            err["matmul"] = max(err["matmul"], diff.max().item())
            if dtype == torch.bfloat16 and m == 2048:
                main_err["matmul"] = diff.max().item()
            cases += 1
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for shape, block in (((256, 128), 256), ((512, 64), 128),
                             ((1024, 256), 256), ((16384, 1024), 256)):
            x = tensor(shape, dtype, 3)
            got = ops.copy(x, block_rows=block)
            if not torch.equal(got, x) or got.data_ptr() == x.data_ptr():
                raise AssertionError(f"copy {dtype} {shape} not a bit-exact "
                                     f"new buffer")
            cases += 1
    # the byte path: an unaligned start, and a tail past the last 16 bytes
    flat = tensor((1, 4099), torch.int32, 4).view(-1)
    for x in (flat[1:].view(1, 4098), tensor((1, 1001), torch.bfloat16, 5)):
        if not torch.equal(copy_stream.copy(x), x):
            raise AssertionError(f"copy byte path {x.dtype} {tuple(x.shape)}")
        cases += 1
    main_err["copy"] = 0.0
    for dtype, shape, block in ((torch.float32, (8, 64), 8),
                                (torch.float32, (16, 256), 8),
                                (torch.float32, (32, 1024), 4),
                                (torch.float32, (8, 128), 2),
                                (torch.float32, (1024, 4096), 8),
                                (torch.float32, (8, 32768), 8),
                                (torch.int32, (16, 1024), 8)):
        x = tensor(shape, dtype, 6)
        got = ops.sort_rows(x, block_rows=block)
        if not torch.equal(got, ref.sort_rows(x)):
            raise AssertionError(f"sort {dtype} {shape} differs from "
                                 f"torch.sort")
        cases += 1
    main_err["sort_rows"] = 0.0
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in KERNELS:
        if after[name] <= before[name]:
            raise AssertionError(f"{name}'s launch counter did not move")
    emit({"phase": "kernels", "checked": list(KERNELS), "cases": cases,
          "max_abs_err": err, "max_abs_err_main_shape": main_err})
    return main_err


def device_ms(fn) -> float:
    """Median device time of one call, from CUDA events around each call.
    The calls queue behind a sleep kernel, so host launch gaps do not count."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_times() -> dict:
    """kernel, plain and library times at the main path's shapes, and the
    bound each kernel is held to."""
    shapes, dtypes = mixed_mode.PAPER_SHAPES, mixed_mode.DTYPES
    xm = tensor(shapes["matmul"], dtypes["matmul"], 7)
    xc = tensor(shapes["copy"], dtypes["copy"], 8)
    xs = tensor(shapes["sort"], dtypes["sort"], 9)
    m, k = xm.shape
    n = k
    mm_bytes = (m * k + k * n + m * n) * xm.element_size()
    mm_ops = 2 * m * n * k
    rows, width = xs.shape
    stages = width.bit_length() - 1
    sort_ops = 2 * rows * (width // 2) * stages * (stages + 1) // 2
    work = {  # name -> (kernel, plain, library, bytes, operations, op dtype)
        "matmul": (lambda: ops.matmul(xm, xm), lambda: ref.matmul(xm, xm),
                   lambda: torch.matmul(xm, xm), mm_bytes, mm_ops, xm.dtype),
        "copy": (lambda: ops.copy(xc), lambda: ref.copy(xc),
                 lambda: torch.empty_like(xc).copy_(xc),
                 2 * xc.numel() * xc.element_size(), 0, xc.dtype),
        "sort_rows": (lambda: ops.sort_rows(xs), lambda: ref.sort_rows(xs),
                      lambda: torch.sort(xs, dim=-1),
                      2 * xs.numel() * xs.element_size(), sort_ops,
                      xs.dtype),
    }
    times = {}
    for name, (kern, plain, lib, nbytes, nops, dtype) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
        t = {"kernel_ms": device_ms(kern), "plain_ms": device_ms(plain),
             "library_ms": device_ms(lib),
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        times[name] = t
        emit({"phase": "time", "kernel": name, "shape": list(
            {"matmul": xm, "copy": xc, "sort_rows": xs}[name].shape), **t})
    return times


def check_slice_outputs() -> None:
    """One chunk of each class, at the main path's shapes, against the plain
    version of its op on the same operands."""
    operands = mixed_mode.operands_from_numpy(mixed_mode.make_arrays(), "cuda")
    torch.cuda.synchronize()
    dag = random_dag(n_tasks=3, target_degree=1.0, seed=0)
    mixed_mode.bind_real_work(dag, operands, device="cuda")
    plain = {"matmul": lambda x: ref.matmul(x, x), "sort": ref.sort_rows,
             "copy": ref.copy}
    for node in dag.nodes:
        got = node.work.chunk_fn(0)
        want = plain[node.type](operands[node.type])
        if got.shape != want.shape or \
                not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{node.type} chunk: bad shape or values")
        if node.type == "matmul":
            diff = (got.float() - want.float()).abs()
            ok = bool((diff <= 0.2 + 2e-2 * want.float().abs()).all())
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"{node.type} chunk differs from plain")


def phase_slice(times) -> dict:
    """The main path: both policies at full size.  Every counter is reset
    just before each policy's run and read just after it.  Returns policy ->
    kernel -> launches."""
    floor_s = {KERNELS[name][2]: PTT_FLOOR * t["kernel_ms"] / 1e3
               for name, t in times.items()}
    launches = {}
    for policy in mixed_mode.POLICIES:
        log = mixed_mode.ChunkLog()
        kernels.reset_launch_counts()
        out = mixed_mode.run(policy, N_TASKS, DEGREE, SEED, "cuda",
                             timeout_s=300.0, log=log)
        per_run = launches[policy] = kernels.launch_counts()
        if out["completed"] != N_TASKS:
            raise AssertionError(f"{policy}: {out['completed']} of {N_TASKS}")
        runs = log.runs
        if len(runs) != N_TASKS * mixed_mode.N_CHUNKS or \
                set(runs.values()) != {1}:
            raise AssertionError(f"{policy}: chunks not each run once")
        want = N_TASKS // 3 * mixed_mode.N_CHUNKS
        if any(v != want for v in per_run.values()):
            raise AssertionError(f"{policy}: launches {per_run}, want {want}")
        # A PTT time is a leader's wall time.  A leader that ran a chunk
        # waited for the card, so its time covers the kernel's.  A leader
        # whose place-mates claimed every chunk first records only its idle
        # claim; those records, and the cells they touched, are counted.
        records = log.records
        short = [r for r in records
                 if r.leader_chunks > 0 and r.elapsed_s < floor_s[r.cls]]
        if short:
            raise AssertionError(f"{policy}: {len(short)} PTT records under "
                                 f"the kernel's time, e.g. {short[0]}")
        idle = [r for r in records if r.leader_chunks == 0]
        idle_cells = {(r.cls, r.leader, r.width) for r in idle}
        widths = out["widths"]
        below = []
        for cls, table in out["ptt"].items():
            for leader, row in enumerate(table):
                for wi, t in enumerate(row):
                    if t <= 0 or t >= floor_s[cls]:
                        continue
                    if (cls, leader, widths[wi]) not in idle_cells:
                        raise AssertionError(
                            f"{policy}: PTT[{cls}][{leader}, w{widths[wi]}] "
                            f"= {t} s under the kernel's time")
                    below.append(f"{cls}[{leader},w{widths[wi]}]")
        emit({"phase": "slice", "policy": policy,
              "completed": out["completed"], "elapsed_s": out["elapsed_s"],
              "taos_per_s": out["throughput_taos_per_s"],
              "launches": per_run, "ptt_records": len(records),
              "idle_leader_records": {
                  f"w{w}": sum(r.width == w for r in idle) for w in widths},
              "ptt_cells_below_floor_from_idle_leaders": below,
              "ptt_ms": {cls: (table * 1e3).tolist()
                         for cls, table in out["ptt"].items()}})
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 = "highest"
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    main_err = phase_kernels()
    times = phase_times()
    check_slice_outputs()
    launches = phase_slice(times)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": min(n[name] for n in launches.values()),
         "launches_by_policy": {p: n[name] for p, n in launches.items()},
         "max_abs_err": main_err[name],
         "ms": times[name]["kernel_ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name, (src, replaces, _) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
