"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, times each at the shapes of the paths
that run it, and drives both ported paths at full size:

* the paper's 3000-TAO mixed-mode DAG on ``ThreadedRuntime`` under the
  policies ``homogeneous`` and ``molding:weight`` (slice 1);
* serving through the tenant zoo's kernel tenants at llama3.2-1b widths
  (slice 2): the trace, gate and controller of
  ``python -m repro_torch.launch.serve --zoo``, then a full backlog (the
  default ``bursty_serving_trace``, 100 requests) with no gate and no
  controller.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Every phase prints one JSON line.  Any failed check raises, and the script
exits with a code other than 0; it does the same without a CUDA device.  The
line before the last lists every kernel with its launches in each path's
run (``launches`` is the smallest over the paths that run it), its error and
its times at each path's shapes; the last line names the card.
"""
from __future__ import annotations

import collections
import json
import math
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
from repro_torch.core.serve_orchestrator import DECODE_UNIT  # noqa: E402
from repro_torch.kernels import _build, copy_stream, ops, ref  # noqa: E402
from repro_torch.launch import serve, zoo  # noqa: E402
from repro_torch.workers import ChunkLog  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM's rate and its operations over
# the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

N_TASKS, DEGREE, SEED = 3000, 3.03, 1
PTT_FLOOR = 0.8  # a PTT time must cover this share of its kernel's time
REPS, WARMUP = 30, 5

# kernel -> (source, the Pallas kernel it replaces, the DAG class it serves
# on the mixed-mode path, or None)
KERNELS = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:63", "matmul"),
    "copy": ("src/repro_torch/kernels/csrc/copy_stream.cu",
             "src/repro/kernels/copy_stream.py:37", "copy"),
    "sort_rows": ("src/repro_torch/kernels/csrc/sort_bitonic.cu",
                  "src/repro/kernels/sort_bitonic.py:62", "sort"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:124", None),
}
MIXED_PATHS = tuple(f"mixed_mode:{p}" for p in mixed_mode.POLICIES)
SERVE_PATHS = tuple(serve.PATHS)
# kernel -> the paths whose main run must launch it
KERNEL_PATHS = {"matmul": MIXED_PATHS + SERVE_PATHS,
                "copy": MIXED_PATHS + SERVE_PATHS,
                "sort_rows": MIXED_PATHS,
                "flash_attention": SERVE_PATHS}
# kernel -> the shape (a key of phase_times's result) its top-level numbers
# in the kernels line are taken at: the path that brought it into the port
MAIN_SHAPE = {"matmul": "mixed_mode", "copy": "mixed_mode",
              "sort_rows": "mixed_mode", "flash_attention": "serve"}


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
    tests/test_kernels.py and of the main paths.  matmul within that file's
    tolerances (rtol=tol, atol=10*tol); copy and sort bit-exact; flash
    attention as ``check_flash`` says."""
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
    # the zoo's decode GEMV: one row through the kernel at bm=1
    for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 2e-2)):
        x, w = tensor((1, 2048), dtype, 10), tensor((2048, 2048), dtype, 11)
        got = ops.matmul(x, w, bm=1).float()
        want = ref.matmul(x, w).float()
        diff = (got - want).abs()
        if not bool((diff <= 10 * tol + tol * want.abs()).all()):
            raise AssertionError(f"matmul GEMV {dtype}: max abs err "
                                 f"{diff.max().item()}")
        err["matmul"] = max(err["matmul"], diff.max().item())
        cases += 1
    flash_cases, main_err["flash_attention"], err["flash_attention"] = \
        check_flash()
    cases += flash_cases
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

# dtype -> (rtol, atol) of flash_attention against its plain version.  fp32:
# summation order.  bf16: both sides compute in fp32 and round the output to
# bf16 once, so they differ by at most one bf16 ulp (2^-7 of the value):
# rtol 1e-2 holds that, and atol 2e-3 is under a tenth of a typical output
# at the serving shape (|out| ~ 0.05 where a row averages ~500 keys).
FLASH_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 2e-3)}


def check_flash() -> tuple[int, float, float]:
    """flash_attention against its plain version, in the working dtype, at
    ``FLASH_TOL``.  Returns the number of cases, the error at the serving
    shape and the largest."""
    cases = []  # (B, Hq, Hkv, S, Sk, D), dtype, causal, window
    # test_kernels.py's modes, GQA ratios and bf16 case
    for causal, window in ((True, None), (False, None), (True, 100),
                           (True, 256)):
        cases.append(((2, 4, 2, 256, 256, 64), torch.float32, causal, window))
    for hkv in (8, 4, 1):
        cases.append(((1, 8, hkv, 256, 256, 32), torch.float32, True, None))
    cases.append(((1, 2, 1, 256, 256, 64), torch.bfloat16, True, None))
    # every head size the kernel takes
    for d in (32, 64, 128):
        for dtype in FLASH_TOL:
            cases.append(((1, 4, 2, 320, 320, d), dtype, True, None))
    # S != Sk, with rows (319 on) that see no key: the reference's fault 2
    for causal in (True, False):
        for dtype in FLASH_TOL:
            cases.append(((1, 2, 1, 512, 256, 64), dtype, causal, 64))
    s = zoo.SERVE_SHAPES
    serving = ((s.batch, s.q_heads, s.kv_heads, s.seq, s.seq, s.head_dim),
               s.dtype, True, None)
    cases.append(serving)
    worst = main = 0.0
    for i, case in enumerate(cases):
        (b, hq, hkv, sq, sk, d), dtype, causal, window = case
        q = tensor((b, hq, sq, d), dtype, 20 + i)
        k = tensor((b, hkv, sk, d), dtype, 40 + i)
        v = tensor((b, hkv, sk, d), dtype, 60 + i)
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, bq=64, bk=64, **kw).float()
        want = ref.attention(q, k, v, **kw).float()
        rtol, atol = FLASH_TOL[dtype]
        diff = (got - want).abs()
        if got.shape != want.shape or \
                not bool((diff <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"flash_attention {case}: max abs err "
                                 f"{diff.max().item()}")
        if sk < sq and window is not None and bool(got[:, :, 319:].any()):
            raise AssertionError(f"flash_attention {case}: a row that sees "
                                 f"no key is not 0")
        worst = max(worst, diff.max().item())
        if case == serving:
            main = diff.max().item()
    return len(cases), main, worst


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


def attention_pairs(s: int, sk: int, causal: bool, window) -> int:
    """(row, col) pairs a mask lets through: the work of these inputs."""
    rows = np.arange(s)
    hi = np.minimum(rows, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(rows - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def sdpa(q, k, v):
    """``scaled_dot_product_attention`` over GQA heads, causal (top-left,
    as the kernel's mask at S = Sk): the library yardstick, never called
    by the port."""
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(q, k, v, is_causal=True, enable_gqa=True)


def phase_times() -> dict:
    """kernel, plain and library times at the shapes of each path that runs
    the kernel, and the bound each kernel is held to there.  Returns
    kernel -> shape key -> times."""
    shapes, dtypes = mixed_mode.PAPER_SHAPES, mixed_mode.DTYPES
    xm = tensor(shapes["matmul"], dtypes["matmul"], 7)
    xc = tensor(shapes["copy"], dtypes["copy"], 8)
    xs = tensor(shapes["sort"], dtypes["sort"], 9)
    rows, width = xs.shape
    stages = width.bit_length() - 1
    sort_ops = 2 * rows * (width // 2) * stages * (stages + 1) // 2
    # the serving chunk's operands (zoo.SERVE_SHAPES)
    sv = zoo.SERVE_SHAPES
    q = tensor((sv.batch, sv.q_heads, sv.seq, sv.head_dim), sv.dtype, 10)
    kv = tensor((sv.batch, sv.kv_heads, sv.seq, sv.head_dim), sv.dtype, 11)
    w = tensor((sv.width, sv.width), sv.dtype, 12)
    xp = tensor((sv.seq, sv.width), sv.dtype, 13)
    x1 = tensor((1, sv.width), sv.dtype, 14)
    slab = tensor((sv.cache_rows, sv.cache_cols), sv.dtype, 15)
    flash_ops = (4 * sv.head_dim * sv.batch * sv.q_heads
                 * attention_pairs(sv.seq, sv.seq, True, None))
    flash_library = sdpa(q, kv, kv)
    lib_err = (flash_library().float()
               - ref.attention(q, kv, kv).float()).abs().max().item()

    def mm(x, y):
        return (lambda: ops.matmul(x, y, bm=min(128, x.shape[0])),
                lambda: ref.matmul(x, y), lambda: torch.matmul(x, y),
                (x.numel() + y.numel() + x.shape[0] * y.shape[1])
                * x.element_size(), 2 * x.shape[0] * y.shape[1] * x.shape[1],
                x.dtype, [list(x.shape), list(y.shape)])

    def cp(x):
        return (lambda: ops.copy(x), lambda: ref.copy(x),
                lambda: torch.empty_like(x).copy_(x),
                2 * x.numel() * x.element_size(), 0, x.dtype, list(x.shape))

    work = {  # (name, shape key) -> (kernel, plain, library, bytes,
        #                             operations, op dtype, shape)
        ("matmul", "mixed_mode"): mm(xm, xm),
        ("copy", "mixed_mode"): cp(xc),
        ("sort_rows", "mixed_mode"): (
            lambda: ops.sort_rows(xs), lambda: ref.sort_rows(xs),
            lambda: torch.sort(xs, dim=-1),
            2 * xs.numel() * xs.element_size(), sort_ops, xs.dtype,
            list(xs.shape)),
        ("flash_attention", "serve"): (
            lambda: ops.flash_attention(q, kv, kv),
            lambda: ref.attention(q, kv, kv), flash_library,
            2 * (q.numel() + kv.numel()) * q.element_size(), flash_ops,
            q.dtype, [list(q.shape), list(kv.shape)]),
        ("matmul", "serve:projection"): mm(xp, w),
        ("matmul", "serve:gemv"): mm(x1, w),
        ("copy", "serve:slab"): cp(slab),
    }
    times: dict = {}
    for (name, key), (kern, plain, lib, nbytes, nops, dtype, shape) in \
            work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
        t = {"kernel_ms": device_ms(kern), "plain_ms": device_ms(plain),
             "library_ms": device_ms(lib),
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        times.setdefault(name, {})[key] = t
        extra = ({"library": "scaled_dot_product_attention",
                  "library_max_abs_err": lib_err}
                 if name == "flash_attention" else {})
        emit({"phase": "time", "kernel": name, "at": key, "shape": shape,
              **t, **extra})
    return times


def check_ptt(label: str, records, cells, floors: dict) -> tuple[list, list]:
    """A PTT time is a leader's wall time.  A leader that ran a chunk waited
    for the card, so its time covers its kernels' (``floors[cls]`` s).  A
    leader whose place-mates claimed every chunk first records only its idle
    claim; a PTT cell ``(cls, leader, width, t)`` under the floor must be one
    such a record touched.  Returns the idle records and those cells."""
    short = [r for r in records
             if r.leader_chunks > 0 and r.elapsed_s < floors[r.cls]]
    if short:
        raise AssertionError(f"{label}: {len(short)} PTT records under the "
                             f"kernels' time, e.g. {short[0]}")
    idle = [r for r in records if r.leader_chunks == 0]
    idle_cells = {(r.cls, r.leader, r.width) for r in idle}
    below = []
    for cls, leader, width, t in cells:
        if t >= floors[cls]:
            continue
        if (cls, leader, width) not in idle_cells:
            raise AssertionError(f"{label}: PTT[{cls}][{leader}, w{width}] "
                                 f"= {t} s under the kernels' time")
        below.append(f"{cls}[{leader},w{width}]")
    return idle, below


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
    just before each policy's run and read just after it.  Returns path ->
    kernel -> launches."""
    floor_s = {KERNELS[name][2]: PTT_FLOOR * t["mixed_mode"]["kernel_ms"]
               / 1e3 for name, t in times.items() if KERNELS[name][2]}
    launches = {}
    for policy in mixed_mode.POLICIES:
        log = mixed_mode.ChunkLog()
        kernels.reset_launch_counts()
        out = mixed_mode.run(policy, N_TASKS, DEGREE, SEED, "cuda",
                             timeout_s=300.0, log=log)
        per_run = launches[f"mixed_mode:{policy}"] = kernels.launch_counts()
        if out["completed"] != N_TASKS:
            raise AssertionError(f"{policy}: {out['completed']} of {N_TASKS}")
        runs = log.runs
        if len(runs) != N_TASKS * mixed_mode.N_CHUNKS or \
                set(runs.values()) != {1}:
            raise AssertionError(f"{policy}: chunks not each run once")
        want = {name: N_TASKS // 3 * mixed_mode.N_CHUNKS if cls else 0
                for name, (_, _, cls) in KERNELS.items()}
        if per_run != want:
            raise AssertionError(f"{policy}: launches {per_run}, want {want}")
        records, widths = log.records, out["widths"]
        idle, below = check_ptt(policy, records, (
            (cls, leader, widths[wi], t)
            for cls, table in out["ptt"].items()
            for leader, row in enumerate(table)
            for wi, t in enumerate(row) if t > 0), floor_s)
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


def serve_floors(times, tenant) -> dict:
    """TAO type -> the least wall time of one chunk: its kernels' event
    times at the serving shapes, times PTT_FLOOR."""
    def ms(name, key):
        return times[name][key]["kernel_ms"]
    return {"prefill": PTT_FLOOR * (ms("flash_attention", "serve")
                                    + ms("matmul", "serve:projection")) / 1e3,
            "decode": PTT_FLOOR * tenant.decode_steps * (
                ms("copy", "serve:slab") + ms("matmul", "serve:gemv")) / 1e3}


def check_serving_outputs() -> None:
    """One prefill slab and one decode burst of a kernel tenant at the
    serving shapes against the plain versions composed the same way.  The
    projection sums 2048 products: test_kernels.py's bf16 matmul tolerance
    (rtol=2e-2, atol=0.2) holds it."""
    arrays = zoo.kernel_arrays(zoo.SERVE_SHAPES, seed=5)
    operands = zoo.kernel_operands_from_numpy(arrays, "cuda")
    tenant = zoo.ZooTenant("check", operands=operands)
    q, kv, w, x1 = (operands[n] for n in ("q", "kv", "w", "x1"))
    attn = ref.attention(q, kv, kv)
    got = tenant.prefill_slab().float()
    want = ref.matmul(attn.reshape(attn.shape[2], -1), w).float()
    moved, y = tenant.decode_burst()
    torch.cuda.synchronize()
    if not torch.equal(moved, operands["cache_slab"]):
        raise AssertionError("decode burst: the slab copy differs")
    gemv = ref.matmul(x1, w).float()
    for what, g, wnt in (("prefill slab", got, want),
                         ("decode GEMV", y.float(), gemv)):
        diff = (g - wnt).abs()
        if g.shape != wnt.shape or not bool(torch.isfinite(g).all()) or \
                not bool((diff <= 0.2 + 2e-2 * wnt.abs()).all()):
            raise AssertionError(f"{what} differs from plain: max abs err "
                                 f"{diff.max().item()}")


def serve_run(path: str, tenants: dict, requests: list, floors: dict,
              **controls) -> dict:
    """One serving run through ``serve.run_zoo``, with every counter reset
    just before it and read just after.  Checks that every admitted request
    completes, every chunk runs once, each kernel launches exactly as often
    as the admitted requests' chunks call it, and every PTT update whose
    leader ran a chunk covers the chunk's kernel time.  Returns kernel ->
    launches."""
    log = ChunkLog()
    kernels.reset_launch_counts()
    stats = serve.run_zoo(requests, tenants, log=log, timeout_s=300.0,
                          **controls)
    launched = kernels.launch_counts()
    res = stats.result
    by_name = {f"req{r.id}": r for r in requests}
    admitted = [by_name[st.name] for st in res.admitted_dags()]
    undone = [st.name for st in res.admitted_dags() if not st.done]
    if not admitted or undone:
        raise AssertionError(f"{path}: {len(admitted)} admitted, not done: "
                             f"{undone}")
    prefill = sum(tenants[r.tenant].prefill_chunks(r) for r in admitted)
    bursts = [(r, math.ceil(r.gen_len / DECODE_UNIT)) for r in admitted]
    decode_taos = sum(n for _, n in bursts)
    steps = sum(n * tenants[r.tenant].decode_steps for r, n in bursts)
    want = {"matmul": prefill + steps, "copy": steps, "sort_rows": 0,
            "flash_attention": prefill}
    if launched != want:
        raise AssertionError(f"{path}: launches {launched}, want {want}")
    if len(log.runs) != prefill + decode_taos or \
            set(log.runs.values()) != {1}:
        raise AssertionError(f"{path}: chunks not each run once")
    records = log.records
    idle, below = check_ptt(path, records, (
        (typ, leader, width, t) for typ, cells in stats.ptt_profiles.items()
        for (leader, width, *_), t in cells.items()), floors)
    emit({"phase": "serve", "path": path, "requests": len(requests),
          "admitted": len(admitted), "rejected": res.n_rejected,
          "prefill_chunks": prefill, "decode_taos": decode_taos,
          "completed_taos": res.completed, "makespan_s": stats.makespan,
          "tokens_per_s": stats.tokens_per_s,
          "tokens_per_s_by_tenant": stats.tokens_per_s_by_tenant,
          "p99_sojourn_s_by_tenant": stats.p99_by_tenant(),
          "preemptions": res.n_preemptions, "launches": launched,
          "ptt_records": len(records),
          "idle_leader_records": {f"{typ}:w{w}": n for (typ, w), n in sorted(
              collections.Counter((r.cls, r.width) for r in idle).items())},
          "ptt_cells_below_floor_from_idle_leaders": below,
          "ptt_floor_ms": {t: f * 1e3 for t, f in floors.items()},
          "ptt_ms": {typ: {f"{k[0]},w{k[1]}": t * 1e3
                           for k, t in sorted(cells.items())}
                     for typ, cells in stats.ptt_profiles.items()}})
    return launched


def phase_serve(times) -> dict:
    """The serving path at llama3.2-1b widths: the entry point's trace, gate
    and controller, then a full backlog with neither.  Returns path ->
    kernel -> launches."""
    check_serving_outputs()
    tenants = zoo.default_zoo(serve.KERNEL_TENANTS)
    zoo.warm_zoo(tenants)
    floors = serve_floors(times, next(iter(tenants.values())))
    return {path: serve_run(path, tenants, trace(), floors, **controls())
            for path, (trace, controls) in serve.PATHS.items()}


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
    launches.update(phase_serve(times))
    entries = []
    for name, (src, replaces, _) in KERNELS.items():
        on_path = {p: launches[p][name] for p in KERNEL_PATHS[name]}
        if min(on_path.values()) == 0:
            raise AssertionError(f"{name} was not launched on {on_path}")
        main_t = times[name][MAIN_SHAPE[name]]
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": min(on_path.values()),
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": main_err[name],
            "ms": main_t["kernel_ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "times_by_shape": {key: {k: t[k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")} for key, t in times[name].items()}})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
