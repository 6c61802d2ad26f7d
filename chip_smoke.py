"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, times each at the shapes of the paths
that run it, and drives every ported path at full size:

* the paper's 3000-TAO mixed-mode DAG on ``ThreadedRuntime`` under the
  policies ``homogeneous`` and ``molding:weight`` (slice 1);
* ``python -m repro_torch.launch.serve --arch llama3.2-1b --orchestrate``:
  the llama3.2-1b decoder at its published widths and depth, random weights
  from a seed, with a teacher-forcing check at full depth and a check of
  the card against the CPU at full width and 2 layers (slice 3);
* serving through the tenant zoo's JAX pairing, a llama3.2-1b transformer
  tenant and a kernel tenant at llama3.2-1b widths (slices 2 and 3): the
  trace, gate and controller of ``python -m repro_torch.launch.serve
  --zoo``, then a full backlog (the default ``bursty_serving_trace``, 100
  requests) with no gate and no controller.

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
import dataclasses
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
from repro_torch.models import (get_model, make_decode_step,  # noqa: E402
                                make_prefill_step)
from repro_torch.models.convert import (numpy_params,  # noqa: E402
                                        params_from_numpy)
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
    "triad": ("src/repro_torch/kernels/csrc/copy_stream.cu",
              "src/repro/kernels/copy_stream.py:69", None),
    "sort_rows": ("src/repro_torch/kernels/csrc/sort_bitonic.cu",
                  "src/repro/kernels/sort_bitonic.py:62", "sort"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:35", None),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:124", None),
}
MIXED_PATHS = tuple(f"mixed_mode:{p}" for p in mixed_mode.POLICIES)
MODEL_PATH = "serve:model"
SERVE_PATHS = tuple(serve.PATHS)
# kernel -> the paths whose main run must launch it.  triad has no caller
# in either package: it is checked and timed, and no path runs it.
KERNEL_PATHS = {"matmul": MIXED_PATHS + SERVE_PATHS,
                "copy": MIXED_PATHS + SERVE_PATHS,
                "triad": (),
                "sort_rows": MIXED_PATHS,
                "rmsnorm": (MODEL_PATH,) + SERVE_PATHS,
                "flash_attention": (MODEL_PATH,) + SERVE_PATHS}
# kernel -> the shape (a key of phase_times's result) its top-level numbers
# in the kernels line are taken at: the path that brought it into the port
MAIN_SHAPE = {"matmul": "mixed_mode", "copy": "mixed_mode",
              "triad": "stream", "sort_rows": "mixed_mode",
              "rmsnorm": "serve:model", "flash_attention": "serve"}
ARCH = "llama3.2-1b"  # the model of serve:model and of the zoo's transformer
D_MODEL = 2048        # its width (configs/llama3_2_1b.py)
MODEL_BATCH, MODEL_PROMPT = 4, 64  # serve --arch's defaults (serve:model)
# rmsnorm rows at each shape key: serve:model's prefill (batch 4 x prompt
# 64), the zoo's prefill chunk (1 x 1024 tokens) and a decode step of
# serve:model (batch 4)
NORM_ROWS = {"serve:model": MODEL_BATCH * MODEL_PROMPT,
             "serve:zoo_prefill": zoo.SERVE_SHAPES.model_prompt,
             "serve:decode": MODEL_BATCH}


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
    tests/test_kernels.py and of the main paths.  matmul and rmsnorm within
    that file's tolerances (matmul rtol=tol, atol=10*tol; rmsnorm
    rtol=atol=2e-5 fp32, 2e-2 bf16); copy, sort and triad bit-exact (the
    triad rounds the product and the sum one at a time, as PyTorch does);
    flash attention as ``check_flash`` says."""
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
    # rmsnorm at test_kernels.py's sweep (w in x's dtype, eps 1e-6), then at
    # the model's shapes: bf16 x, fp32 w, eps 1e-5, all rows in one block
    norm_cases = [(rows, d, block, dtype, dtype, 1e-6, tol)
                  for rows, d, block in ((256, 128, 256), (512, 512, 128),
                                         (256, 64, 64))
                  for dtype, tol in ((torch.float32, 2e-5),
                                     (torch.bfloat16, 2e-2))]
    norm_cases += [(rows, D_MODEL, rows, torch.bfloat16, torch.float32, 1e-5,
                    2e-2) for rows in (256, 1024, 4, 1)]
    for i, (rows, d, block, xd, wd, eps, tol) in enumerate(norm_cases):
        x, w = tensor((rows, d), xd, 70 + i), tensor((d,), wd, 90 + i)
        got = ops.rmsnorm(x, w, eps=eps, block_rows=block).float()
        want = ref.rmsnorm(x, w, eps).float()
        diff = (got - want).abs()
        if got.shape != want.shape or \
                not bool((diff <= tol + tol * want.abs()).all()):
            raise AssertionError(f"rmsnorm ({rows},{d}) {xd} w {wd}: max abs "
                                 f"err {diff.max().item()}")
        err["rmsnorm"] = max(err["rmsnorm"], diff.max().item())
        if (rows, d, wd) == (NORM_ROWS["serve:model"], D_MODEL,
                             torch.float32):
            main_err["rmsnorm"] = diff.max().item()
        cases += 1
    # triad at test_kernels.py's cases and at the streaming shape
    for shape, block in (((256, 128), 128), ((16384, 1024), 256)):
        x, y = tensor(shape, torch.float32, 110), \
            tensor(shape, torch.float32, 111)
        for a in (0.0, 1.0, -2.5):
            got = ops.triad(a, x, y, block_rows=block)
            if not torch.equal(got, ref.triad(a, x, y)):
                raise AssertionError(f"triad a={a} {shape} differs from "
                                     f"a * x + y")
            cases += 1
    main_err["triad"] = 0.0
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
    ``FLASH_TOL``, through ``ops.flash_attention`` with the tiles each caller
    passes (64 unless a case says).  Returns the number of cases, the error
    at the kernel tenant's serving shape and the largest."""
    cases = []  # (B, Hq, Hkv, S, Sk, D), dtype, causal, window, tile
    # test_kernels.py's modes, GQA ratios and bf16 case
    for causal, window in ((True, None), (False, None), (True, 100),
                           (True, 256)):
        cases.append(((2, 4, 2, 256, 256, 64), torch.float32, causal, window,
                      64))
    for hkv in (8, 4, 1):
        cases.append(((1, 8, hkv, 256, 256, 32), torch.float32, True, None,
                      64))
    cases.append(((1, 2, 1, 256, 256, 64), torch.bfloat16, True, None, 64))
    # every head size the kernel takes
    for d in (32, 64, 128):
        for dtype in FLASH_TOL:
            cases.append(((1, 4, 2, 320, 320, d), dtype, True, None, 64))
    # S != Sk, with rows (319 on) that see no key: the reference's fault 2
    for causal in (True, False):
        for dtype in FLASH_TOL:
            cases.append(((1, 2, 1, 512, 256, 64), dtype, causal, 64, 64))
    s = zoo.SERVE_SHAPES
    serving = ((s.batch, s.q_heads, s.kv_heads, s.seq, s.seq, s.head_dim),
               s.dtype, True, None, 64)
    cases.append(serving)
    # the decoder's prefill attention (layers.attention: bq = bk = S) at
    # llama3.2-1b's heads, at each batch and length the model's calls give
    # it: serve:model's prefill and forward (batch 4) and the 2-layer parity
    # check's forward (batch 2) over the prompt, their teacher-forcing
    # prefills over all but its last token, and the zoo transformer's chunk
    hq, hkv, d = s.q_heads, s.kv_heads, s.head_dim
    for b, sq in ((MODEL_BATCH, MODEL_PROMPT), (MODEL_BATCH, MODEL_PROMPT - 1),
                  (2, MODEL_PROMPT), (2, MODEL_PROMPT - 1),
                  (1, s.model_prompt)):
        cases.append(((b, hq, hkv, sq, sq, d), s.dtype, True, None, sq))
    worst = main = 0.0
    for i, case in enumerate(cases):
        (b, hq, hkv, sq, sk, d), dtype, causal, window, tile = case
        q = tensor((b, hq, sq, d), dtype, 20 + 3 * i)
        k = tensor((b, hkv, sk, d), dtype, 21 + 3 * i)
        v = tensor((b, hkv, sk, d), dtype, 22 + 3 * i)
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, bq=tile, bk=tile, **kw).float()
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

    def norm(rows):
        # the model's operands: bf16 activations, fp32 weight, eps 1e-5; four
        # fp32 operations an element (square, sum, scale, weight)
        x = tensor((rows, D_MODEL), torch.bfloat16, 16)
        w = tensor((D_MODEL,), torch.float32, 17)
        f = torch.nn.functional.rms_norm
        return (lambda: ops.rmsnorm(x, w, eps=1e-5, block_rows=rows),
                lambda: ref.rmsnorm(x, w, 1e-5),
                lambda: f(x, (D_MODEL,), w, 1e-5),
                2 * x.numel() * x.element_size() + w.numel() * w.element_size(),
                4 * x.numel(), torch.float32, [list(x.shape), list(w.shape)])

    xt, yt = (tensor((16384, 1024), torch.float32, seed) for seed in (18, 19))

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
        ("triad", "stream"): (
            lambda: ops.triad(-2.5, xt, yt), lambda: ref.triad(-2.5, xt, yt),
            lambda: torch.add(yt, xt, alpha=-2.5),
            3 * xt.numel() * xt.element_size(), 2 * xt.numel(), xt.dtype,
            [list(xt.shape), list(yt.shape)]),
        **{("rmsnorm", key): norm(rows) for key, rows in NORM_ROWS.items()},
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
        extra = {"flash_attention": {"library": "scaled_dot_product_attention",
                                     "library_max_abs_err": lib_err},
                 "rmsnorm": {"library": "rms_norm (fp32 weight)"},
                 "triad": {"library": "add(y, x, alpha=a)"}}.get(name, {})
        emit({"phase": "time", "kernel": name, "at": key, "shape": shape,
              **t, **extra})
    return times


def check_ptt(label: str, records, cells, floor) -> tuple[list, list]:
    """A PTT time is a leader's wall time.  A leader that ran a chunk waited
    for the card, so its time covers its kernels': ``floor(cls, dag_id)``
    s for a chunk of class ``cls`` in DAG ``dag_id``.  A leader whose
    place-mates claimed every chunk first records only its idle claim; a
    PTT cell ``(cls, leader, width, t)``, shared by every DAG, under
    ``floor(cls, None)`` must be one such a record touched.  Returns the
    idle records and those cells."""
    short = [r for r in records
             if r.leader_chunks > 0 and r.elapsed_s < floor(r.cls, r.dag_id)]
    if short:
        raise AssertionError(f"{label}: {len(short)} PTT records under the "
                             f"kernels' time, e.g. {short[0]}")
    idle = [r for r in records if r.leader_chunks == 0]
    idle_cells = {(r.cls, r.leader, r.width) for r in idle}
    below = []
    for cls, leader, width, t in cells:
        if t >= floor(cls, None):
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
            for wi, t in enumerate(row) if t > 0),
            lambda cls, dag_id: floor_s[cls])
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


def chunk_launches(tenant) -> dict:
    """TAO type -> kernel -> launches of one chunk of ``tenant``'s (one
    decode step of a burst)."""
    if tenant.flavor == "kernel":
        return {"prefill": {"flash_attention": 1, "matmul": 1},
                "decode": {"copy": 1, "matmul": 1}}
    layers = tenant.config.n_layers
    return {"prefill": {"rmsnorm": 2 * layers + 1, "flash_attention": layers},
            "decode": {"rmsnorm": 2 * layers + 1}}


def serve_floors(times, tenants) -> dict:
    """flavor -> TAO type -> the least wall time of one chunk: the event
    times of the port's kernels that the chunk launches, at the serving
    shapes, times PTT_FLOOR.  The kernel flavor's prefill chunk is one flash
    attention and one projection; the transformer's is 2L + 1 norms of the
    1024-token chunk and L flash attentions (its projections are plain
    torch.matmul, which the floor leaves out)."""
    def ms(name, key):
        return times[name][key]["kernel_ms"]
    keys = {"flash_attention": "serve", "rmsnorm": "serve:zoo_prefill"}
    floors = {}
    for tenant in tenants.values():
        n = chunk_launches(tenant)
        pre = sum(k * ms(name, keys.get(name, "serve:projection"))
                  for name, k in n["prefill"].items())
        dec = sum(k * ms(name, {"copy": "serve:slab", "matmul": "serve:gemv",
                                "rmsnorm": "serve:decode"}[name])
                  for name, k in n["decode"].items())
        floors[tenant.flavor] = {
            "prefill": PTT_FLOOR * pre / 1e3,
            "decode": PTT_FLOOR * tenant.decode_steps * dec / 1e3}
    return floors


def close(what: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
          atol: float) -> float:
    """Raise unless ``got`` is finite and within rtol/atol of ``want``;
    returns the largest error."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, want "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or \
            not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {diff.max().item()} "
                             f"(rtol {rtol}, atol {atol})")
    return diff.max().item()


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
    got = tenant.prefill_slab()
    want = ref.matmul(attn.reshape(attn.shape[2], -1), w)
    moved, y = tenant.decode_burst()
    torch.cuda.synchronize()
    if not torch.equal(moved, operands["cache_slab"]):
        raise AssertionError("decode burst: the slab copy differs")
    close("prefill slab", got, want, 2e-2, 0.2)
    close("decode GEMV", y, ref.matmul(x1, w), 2e-2, 0.2)


def check_transformer_tenant(tenant) -> dict:
    """The transformer tenant's payloads by teacher forcing: the burst
    decodes the chunk's last token once more at position 1024, so forward
    over the chunk and that token gives the prefill slab's logits at its
    second-last position and the burst's at its last; all finite, at rtol
    3e-2 and ``bf16_atol`` of the model's depth, as ``phase_model``."""
    model, weights, toks = tenant.model, tenant.weights, tenant.tokens
    atol = bf16_atol(model.cfg.n_layers)
    with torch.inference_mode():
        full = model.forward(weights, {"tokens": torch.cat(
            [toks, toks[:, -1:]], dim=1)})
    return {"atol": atol, "prefill_max_abs_err": close(
                "transformer prefill slab", tenant.prefill_slab()[:, 0],
                full[:, -2], 3e-2, atol),
            "decode_max_abs_err": close(
                "transformer decode burst", tenant.decode_burst()[:, 0],
                full[:, -1], 3e-2, atol)}


def serve_run(path: str, tenants: dict, requests: list, floors: dict,
              **controls) -> dict:
    """One serving run through ``serve.run_zoo``, with every counter reset
    just before it and read just after.  Checks that every admitted request
    completes, every chunk runs once, each kernel launches exactly as often
    as the admitted requests' chunks call it, and every PTT update whose
    leader ran a chunk covers the chunk's kernel time (its tenant's floor).
    Returns kernel -> launches."""
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
    want = collections.Counter({name: 0 for name in KERNELS})
    prefill = decode_taos = 0
    for r in admitted:
        tenant = tenants[r.tenant]
        n_pre = tenant.prefill_chunks(r)
        n_dec = math.ceil(r.gen_len / DECODE_UNIT)
        prefill += n_pre
        decode_taos += n_dec
        per = chunk_launches(tenant)
        for name, k in per["prefill"].items():
            want[name] += n_pre * k
        for name, k in per["decode"].items():
            want[name] += n_dec * tenant.decode_steps * k
    if launched != dict(want):
        raise AssertionError(f"{path}: launches {launched}, want "
                             f"{dict(want)}")
    if len(log.runs) != prefill + decode_taos or \
            set(log.runs.values()) != {1}:
        raise AssertionError(f"{path}: chunks not each run once")
    flavor_of = {dag_id: tenants[by_name[st.name].tenant].flavor
                 for dag_id, st in res.per_dag.items()}
    records = log.records

    def floor(typ, dag_id):
        # a record is its tenant's chunk; a PTT cell is per type, shared by
        # the tenants, so its floor is the least of theirs
        if dag_id is None:
            return min(f[typ] for f in floors.values())
        return floors[flavor_of[dag_id]][typ]

    idle, below = check_ptt(
        path, records,
        ((typ, leader, width, t) for typ, cells in stats.ptt_profiles.items()
         for (leader, width, *_), t in cells.items()), floor)
    emit({"phase": "serve", "path": path, "requests": len(requests),
          "tenants": {n: t.flavor for n, t in tenants.items()},
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
          "ptt_floor_ms": {fl: {t: v * 1e3 for t, v in f.items()}
                           for fl, f in floors.items()},
          "ptt_ms": {typ: {f"{k[0]},w{k[1]}": t * 1e3
                           for k, t in sorted(cells.items())}
                     for typ, cells in stats.ptt_profiles.items()}})
    return launched


def phase_serve(times) -> dict:
    """The serving path through the zoo's JAX pairing at full size: the
    entry point's trace, gate and controller, then a full backlog with
    neither.  Returns path -> kernel -> launches."""
    check_serving_outputs()
    tenants = zoo.default_zoo()
    zoo.warm_zoo(tenants)
    checked = check_transformer_tenant(tenants["steady"])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    floors = serve_floors(times, tenants)
    emit({"phase": "serve_tenants", "tenants": {
        n: t.flavor for n, t in tenants.items()},
        "transformer": tenants["steady"].config.name, **checked})
    return {path: serve_run(path, tenants, trace(), floors, **controls())
            for path, (trace, controls) in serve.PATHS.items()}


def bf16_atol(layers: int) -> float:
    """test_models.py:114-125's bound for bf16 logits after ``layers``
    layers: 4 * 2^-8 * sqrt(4 L + 2), the error of bf16 sums taken in
    another order growing with the number of reductions."""
    return 4 * 2.0 ** -8 * math.sqrt(4 * layers + 2)


def teacher_forcing(model, weights, toks, atol: float, steps=None) -> dict:
    """Prefill of all but the last token, then a decode step of it, against
    forward over all: test_models.py:86-106's check, at rtol 3e-2 and
    ``atol``.  With ``steps`` each call's launches are checked: 2L + 1
    norms each, L flash attentions in forward and prefill."""
    norms, layers = 2 * model.cfg.n_layers + 1, model.cfg.n_layers

    def run(name, fn, flash):
        before = kernels.launch_counts()
        with torch.inference_mode():
            result = fn()
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if steps is not None:
            if got != {**{k: 0 for k in KERNELS}, "rmsnorm": norms,
                       "flash_attention": flash}:
                raise AssertionError(f"{MODEL_PATH} {name}: launches {got}")
            steps[name] = got
        return result

    full = run("forward", lambda: model.forward(weights, {"tokens": toks}),
               layers)
    pre, cache = run("prefill", lambda: make_prefill_step(model)(
        weights, {"tokens": toks[:, :-1]}), layers)
    dec, _ = run("decode_step", lambda: make_decode_step(model)(
        weights, toks[:, -1:], cache), 0)
    return {"atol": atol,
            "prefill_max_abs_err": close("teacher forcing, prefill",
                                         pre[:, 0], full[:, -2], 3e-2, atol),
            "decode_max_abs_err": close("teacher forcing, decode", dec[:, 0],
                                        full[:, -1], 3e-2, atol)}


def check_full_width_on_two_layers() -> dict:
    """llama3.2-1b at its published widths cut to 2 layers, built from one
    set of numpy weights on the card (kernels) and on the CPU (plain
    versions): the logits of a (2, 64) forward at every position, at
    test_models.py:122-125's bf16 formula, rtol 3e-2 and atol
    4 * 2^-8 * sqrt(4 L + 2).  On the card also teacher forcing at the
    flat rtol = atol = 3e-2 that test_models.py:89-97 sets for its 2-layer
    smoke models."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    model = get_model(cfg)
    arrays = numpy_params(model, seed=7)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, MODEL_PROMPT)))
    logits = {}
    for dev in ("cuda", "cpu"):
        weights = model.bf16_copy(params_from_numpy(arrays, dev))
        with torch.inference_mode():
            logits[dev] = model.forward(weights, {"tokens": toks.to(dev)})
        if dev == "cuda":
            tf = teacher_forcing(model, weights, toks.to(dev), 3e-2)
        del weights
    atol = bf16_atol(cfg.n_layers)
    return {"layers": cfg.n_layers, "tokens": list(toks.shape),
            "atol": atol, "max_abs_err": close(
                "2-layer full width, card against CPU", logits["cuda"],
                logits["cpu"], 3e-2, atol), "teacher_forcing": tf}


def phase_model() -> dict:
    """serve:model: ``python -m repro_torch.launch.serve --arch llama3.2-1b
    --orchestrate`` at full size, every counter reset just before and read
    just after; then teacher forcing on the card at full depth, and the
    card against the CPU at full width and 2 layers.  Returns kernel ->
    launches of the run."""
    kernels.reset_launch_counts()
    out = serve.run_arch(ARCH, orchestrate=True, device="cuda")
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    model, weights, toks = out["model"], out["weights"], out["tokens"]
    cfg, stats = model.cfg, out["stats"]
    batch, prompt = toks.shape
    gen = out["out_tokens"].shape[1]
    n_prefill = batch * 4                        # the orchestrated requests
    n_decode = stats.result.completed - n_prefill
    if stats.result.completed != n_prefill * (1 + math.ceil(
            gen / DECODE_UNIT)):
        raise AssertionError(f"{MODEL_PATH}: {stats.result.completed} TAOs")
    norms, layers = 2 * cfg.n_layers + 1, cfg.n_layers
    want = {name: 0 for name in KERNELS}
    want["rmsnorm"] = norms * (1 + gen + n_prefill + n_decode)
    want["flash_attention"] = layers * (1 + n_prefill)
    if launched != want:
        raise AssertionError(f"{MODEL_PATH}: launches {launched}, want "
                             f"{want}")
    if not bool(torch.isfinite(out["logits"].float()).all()):
        raise AssertionError(f"{MODEL_PATH}: logits not finite")
    # teacher forcing at full depth, each call's launches counted on its
    # own.  The flat 3e-2 of test_models.py:89-97 is set for 2 layers; at 16
    # the decode path's error on an H100 reached 0.0791, so the check takes
    # the same file's bound for depth L (:114-125)
    steps = {}
    tf = teacher_forcing(model, weights, toks, bf16_atol(cfg.n_layers),
                         steps)
    params = model.param_count()
    times = {"prefill_s": out["prefill_s"], "decode_s": out["decode_s"]}
    del out, weights
    torch.cuda.empty_cache()
    parity = check_full_width_on_two_layers()
    emit({"phase": "model", "path": MODEL_PATH, "arch": cfg.name,
          "params": params, "layers": cfg.n_layers, "batch": batch,
          "prompt": prompt, "gen": gen,
          **times,
          "orchestrated_taos": stats.result.completed,
          "orchestrated_tokens_per_s": stats.tokens_per_s,
          "orchestrated_p99_sojourn_s": stats.p99_latency,
          "launches": launched, "launches_per_call": steps,
          "teacher_forcing": tf, "two_layer_card_vs_cpu": parity,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launched


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
    launches[MODEL_PATH] = phase_model()
    launches.update(phase_serve(times))
    entries = []
    for name, (src, replaces, _) in KERNELS.items():
        on_path = {p: launches[p][name] for p in KERNEL_PATHS[name]}
        if on_path and min(on_path.values()) == 0:
            raise AssertionError(f"{name} was not launched on {on_path}")
        main_t = times[name][MAIN_SHAPE[name]]
        # a kernel no path runs (triad: no caller in either package) shows
        # 0 launches and says so
        caller = {} if on_path else {"caller": None}
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": min(on_path.values(), default=0),
            **caller,
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
