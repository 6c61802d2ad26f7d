"""Time the port's kernels at the main paths' shapes, for this checkout of
the port or for two side by side on one card.

For each shape it prints one JSON line: the kernel's device time, its plain
version's and one PyTorch call's (``torch.matmul``,
``scaled_dot_product_attention``, ``empty_like().copy_()``, ``torch.sort``,
``rms_norm``, ``torch.add(y, x, alpha=a)``), the bound (the larger of the
bytes over HBM's rate and the operations over the peak rate for their type)
and the kernel's share of it.  Shapes: the mixed-mode DAG's 2048^3 product,
the zoo's projection (1024 x 2048 @ 2048^2) and decode GEMV (1 x 2048 @
2048^2, with L2 flushed between calls and warm), the zoo's causal prefill
attention (q 1 x 32 x 1024 x 64 over 8 kv heads), the decoder's (q 4 x 32
x 64 x 64) and a training step's (q 4 x 32 x 128 x 64), the mixed-mode
DAG's copy (16384 x 1024 fp32) and sort (1024 x 4096 fp32, L2 flushed, as
``chip_smoke.py`` times it), the zoo's KV-slab copy (4096 x 16384 bf16), a
copy of 16896 x 1024 fp32 (a size at which the first copy kernel's
grid-stride loop had no ragged tail on 132 SMs), the decoder's RMSNorm
(bf16 x, fp32 w, d = 2048, L2 flushed) at its four row counts (256:
serve:model's prefill; 1024: the zoo's prefill chunk; 4: a decode step;
512: a training step) and the triad at 16384 x 1024 fp32; and the
families' shapes: hubert-xlarge's bidirectional encode attention (q = k = v
4 x 16 x 500 x 80) and the RMSNorms of mamba2-780m (4000 x 1536 and its
gated 4000 x 3072), hymba-1.5b (4400 x 1600) and hubert (2000 x 1280).  A shape that a tree's kernel does not take
(the parent's flash kernel at head dim 80) prints its error in place of
times.  Bytes and operations are those ``chip_smoke.py`` holds each kernel
to.  Two more
lines: the floor, one empty kernel (``torch.cuda._sleep(0)``) timed the
same way, with L2 flushed and warm, the least any kernel's time can read;
and the host time
per call of two tiny products, one on each bf16 path of the matmul (their
difference is the wgmma path's tensor-map encoding).  The floor line also
times one round trip: the copy kernel on a decode step's 4 x 2048 bf16 rows
(16 KB), L2 flushed, the least a kernel that reads its input from HBM and
writes its output takes here.

    PYTHONPATH=src python -m repro_torch.kernel_bench
    # the parent commit's kernels against this checkout's, in turns
    # (old, new, new, old) in one process tree on one card:
    git archive PARENT | tar -x -C chip_check/parent
    PYTHONPATH=src python -m repro_torch.kernel_bench --old chip_check/parent
    # only some kernels (names as in ``kernels.launch_counts()``):
    PYTHONPATH=src python -m repro_torch.kernel_bench --kernels rmsnorm,triad

The kernels come from whichever ``repro_torch`` the import path finds, so
one file times either tree: ``--old`` reruns this file once per turn with
that tree's ``src`` (or this one's) first on ``PYTHONPATH``.  The summary
goes to ``chiprun_out/kernel_bench.json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM's rate and its operations over
# the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2 ** 20
REPS, WARMUP = 30, 5
SRC = Path(__file__).resolve().parents[1]  # this checkout's src/
# the decoder's RMSNorm: llama3.2-1b's width, and its rows at serve:model's
# prefill (batch 4 x prompt 64), the zoo's prefill chunk (1024 tokens), a
# decode step (batch 4) and a training step of launch.train's defaults
# (batch 4 x seq 128)
NORM_WIDTH = 2048
NORM_ROWS = {"serve:model": 256, "serve:zoo_prefill": 1024,
             "serve:decode": 4, "train": 512}
# the decoder's attention in a training step of launch.train's defaults:
# q (4, 32, 128, 64) over kv (4, 8, 128, 64), bf16, causal
TRAIN_ATTENTION = (4, 32, 8, 128, 64)
# hubert-xlarge's encode: q = k = v (4, 16, 500, 80), bf16, not causal
HUBERT_ATTENTION = (4, 16, 16, 500, 80)
# the families' norms (rows, width) at their serving prefills: mamba2-780m
# over 4 x 1000 tokens at d_model and at d_inner (its gated norm),
# hymba-1.5b over 4 x 1100 (all four of its norms at 1600), hubert-xlarge's
# encode of 4 x 500 frames
FAMILY_NORMS = {"serve:mamba2": (4000, 1536),
                "serve:mamba2_gate": (4000, 3072),
                "serve:hymba": (4400, 1600), "encode:hubert": (2000, 1280)}

_flush_buf: torch.Tensor | None = None


def flush_buffer() -> torch.Tensor:
    """64 MiB on the card, more than its L2: writing it evicts the operands
    of the call before."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")
        for _ in range(3):  # its first writes cost more than later ones
            _flush_buf.zero_()
    return _flush_buf


def device_ms(fn, cold: bool = False) -> float:
    """Median device time of one call, from CUDA events around each call.
    The calls queue behind a sleep kernel, so host launch gaps do not count.
    ``cold``: L2 is flushed before each call, outside its events, so the
    call reads its operands from HBM as a caller that has not just touched
    them would."""
    flush = flush_buffer() if cold else None
    for _ in range(WARMUP):
        if flush is not None:
            flush.zero_()
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: int, nops: int, dtype) -> tuple[float, str]:
    """The least time in ms the card could take, and what sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def attention_pairs(s: int, sk: int, causal: bool, window) -> int:
    """(row, col) pairs a mask lets through: the work of these inputs."""
    rows = np.arange(s)
    hi = np.minimum(rows, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(rows - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def sort_ops(rows: int, width: int) -> int:
    """Operations of the bitonic network on (rows, width): log2(width) *
    (log2(width) + 1) / 2 stages of width / 2 compare-exchanges a row, two
    operations (compare, select) each."""
    stages = width.bit_length() - 1
    return 2 * rows * (width // 2) * stages * (stages + 1) // 2


def tensor(shape, dtype, seed: int) -> torch.Tensor:
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a).to(device="cuda", dtype=dtype)


def sdpa(q, k, v, window: int | None = None, causal: bool = True):
    """``scaled_dot_product_attention`` over GQA heads, causal (top-left, as
    the kernel's mask at S = Sk) unless ``causal`` is False: the library
    yardstick, never called by the port.  SDPA takes no window: with
    ``window`` the causal band is a boolean mask, over k and v repeated to
    q's heads (built before the call, outside its time), as a masked SDPA
    takes them."""
    f = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        return lambda: f(q, k, v, is_causal=causal, enable_gqa=True)
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = (cols <= rows) & (cols > rows - window)
    group = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(group, dim=1) for t in (k, v))
    return lambda: f(q, kr, vr, attn_mask=mask)


def host_us(fn, calls: int = 400, batches: int = 5) -> float:
    """Wall time per call of back-to-back calls, the least over ``batches``
    batches of ``calls``: the host's cost where it exceeds the kernel's,
    with as little of other processes' interference as a batch saw."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


class Case(NamedTuple):
    kernel: str         # the kernel's name in ``kernels.launch_counts()``
    run: Callable       # one call of the kernel
    plain: Callable     # one call of its plain version
    library: Callable   # one PyTorch call of the same function
    nbytes: int         # bytes it must move: inputs read, output written
    nops: int           # operations these inputs need
    dtype: torch.dtype  # the operations' type
    shape: list
    cold: bool          # time with L2 flushed before each call


def cases() -> dict[str, Case]:
    """Shape key -> the case timed there."""
    from repro_torch import mixed_mode
    from repro_torch.kernels import (copy_stream, flash_attention, matmul,
                                     rmsnorm, sort_bitonic)
    from repro_torch.launch import zoo

    def mm(x, y, cold=False):
        return Case("matmul", lambda: matmul.matmul(x, y),
                    lambda: matmul.plain(x, y), lambda: torch.matmul(x, y),
                    (x.numel() + y.numel() + x.shape[0] * y.shape[1])
                    * x.element_size(),
                    2 * x.shape[0] * y.shape[1] * x.shape[1], x.dtype,
                    [list(x.shape), list(y.shape)], cold)

    def attn(b, hq, hkv, s, d, dtype, seed, causal=True):
        q = tensor((b, hq, s, d), dtype, seed)
        kv = tensor((b, hkv, s, d), dtype, seed + 1)
        return Case("flash_attention",
                    lambda: flash_attention.flash_attention(q, kv, kv,
                                                            causal=causal),
                    lambda: flash_attention.plain(q, kv, kv, causal=causal),
                    sdpa(q, kv, kv, causal=causal),
                    2 * (q.numel() + kv.numel()) * q.element_size(),
                    4 * d * b * hq * attention_pairs(s, s, causal, None),
                    dtype, [list(q.shape), list(kv.shape)], False)

    def copy(x):
        return Case("copy", lambda: copy_stream.copy(x),
                    lambda: copy_stream.plain(x),
                    lambda: torch.empty_like(x).copy_(x),
                    2 * x.numel() * x.element_size(), 0, x.dtype,
                    list(x.shape), False)

    def norm(rows, seed, width=NORM_WIDTH):
        # the decoder's operands: bf16 activations, fp32 weight, eps 1e-5;
        # four fp32 operations an element (square, sum, scale, weight)
        x = tensor((rows, width), torch.bfloat16, seed)
        w = tensor((width,), torch.float32, seed + 1)
        return Case("rmsnorm", lambda: rmsnorm.rmsnorm(x, w, eps=1e-5),
                    lambda: rmsnorm.plain(x, w, eps=1e-5),
                    lambda: torch.nn.functional.rms_norm(x, (width,), w,
                                                         1e-5),
                    2 * x.numel() * x.element_size()
                    + w.numel() * w.element_size(), 4 * x.numel(),
                    torch.float32, [list(x.shape), list(w.shape)], True)

    xt, yt = (tensor((16384, 1024), torch.float32, seed) for seed in (18, 19))
    shapes, dtypes = mixed_mode.PAPER_SHAPES, mixed_mode.DTYPES
    xm = tensor(shapes["matmul"], dtypes["matmul"], 7)
    xs = tensor(shapes["sort"], dtypes["sort"], 9)
    sv = zoo.SERVE_SHAPES
    w = tensor((sv.width, sv.width), sv.dtype, 12)
    xp = tensor((sv.seq, sv.width), sv.dtype, 13)
    x1 = tensor((1, sv.width), sv.dtype, 14)
    return {
        "mixed_mode": mm(xm, xm),
        "serve:projection": mm(xp, w),
        "serve:gemv": mm(x1, w, cold=True),
        "serve:gemv_warm": mm(x1, w),
        "serve": attn(sv.batch, sv.q_heads, sv.kv_heads, sv.seq,
                      sv.head_dim, sv.dtype, 10),
        "serve:model": attn(4, sv.q_heads, sv.kv_heads, 64, sv.head_dim,
                            sv.dtype, 20),
        "train": attn(*TRAIN_ATTENTION, sv.dtype, 22),
        "mixed_mode:copy": copy(tensor(shapes["copy"], dtypes["copy"], 8)),
        "serve:slab": copy(tensor((sv.cache_rows, sv.cache_cols), sv.dtype,
                                  15)),
        "copy:tail_free": copy(tensor((16896, 1024), torch.float32, 16)),
        "mixed_mode:sort": Case(
            "sort_rows", lambda: sort_bitonic.sort_rows(xs),
            lambda: sort_bitonic.plain(xs), lambda: torch.sort(xs, dim=-1),
            2 * xs.numel() * xs.element_size(), sort_ops(*xs.shape),
            xs.dtype, list(xs.shape), True),
        **{f"rmsnorm:{key}": norm(rows, 40 + i)
           for i, (key, rows) in enumerate(NORM_ROWS.items())},
        # the families (slice 9): hubert-xlarge's encode, 4 clips of 500
        # frames at 16 heads of 80, bidirectional; their norms
        "encode:hubert": attn(*HUBERT_ATTENTION, sv.dtype, 24, causal=False),
        **{f"rmsnorm:{key}": norm(rows, 60 + 2 * i, width)
           for i, (key, (rows, width)) in enumerate(FAMILY_NORMS.items())},
        "triad:stream": Case(
            "triad", lambda: copy_stream.triad(-2.5, xt, yt),
            lambda: copy_stream.plain_triad(-2.5, xt, yt),
            lambda: torch.add(yt, xt, alpha=-2.5),
            3 * xt.numel() * xt.element_size(), 2 * xt.numel(), xt.dtype,
            [list(xt.shape), list(yt.shape)], False),
    }


def measure(label: str, only=None) -> list[dict]:
    """One turn: every case of this import path's kernels (of the kernels
    named in ``only``, if given)."""
    from repro_torch.kernels import _build, copy_stream, matmul

    _build.load()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    rows = []
    for key, c in cases().items():
        if only and c.kernel not in only:
            continue
        b_ms, b_by = bound(c.nbytes, c.nops, c.dtype)
        t = {"label": label, "at": key, "kernel": c.kernel, "shape": c.shape,
             "card": card, "l2": "flushed" if c.cold else "warm"}
        try:
            kernel_ms = device_ms(c.run, c.cold)
        except ValueError as e:  # a shape this tree's kernel does not take
            t["unsupported"] = str(e)
            print(json.dumps(t), flush=True)
            continue
        t.update(kernel_ms=kernel_ms, plain_ms=device_ms(c.plain, c.cold),
                 library_ms=device_ms(c.library, c.cold), bound_ms=b_ms,
                 bound_by=b_by)
        t["share_of_bound"] = b_ms / t["kernel_ms"]
        rows.append(t)
        print(json.dumps(t), flush=True)
    # the floor: an empty kernel behind the same events and flush; and one
    # round trip, the copy of a decode step's 4 x 2048 bf16 rows (16 KB)
    # read from HBM and written back
    x4 = tensor((NORM_ROWS["serve:decode"], NORM_WIDTH), torch.bfloat16, 45)
    empty = {"label": label, "at": "floor", "card": card,
             "kernel": "empty (torch.cuda._sleep(0))",
             "flushed_ms": device_ms(lambda: torch.cuda._sleep(0), True),
             "warm_ms": device_ms(lambda: torch.cuda._sleep(0)),
             "round_trip_ms": device_ms(lambda: copy_stream.copy(x4), True)}
    rows.append(empty)
    print(json.dumps(empty), flush=True)
    # tiny products, so the host sets the pace: at m = 32 the call encodes
    # two tensor maps (the wgmma path), at m = 1 none (the streaming path)
    y = tensor((64, 64), torch.bfloat16, 31)
    host = {"label": label, "at": "host", "card": card,
            "host_us_per_call": {
                f"matmul ({m}x64 @ 64x64)": host_us(
                    lambda x=tensor((m, 64), torch.bfloat16, 30):
                    matmul.matmul(x, y))
                for m in (32, 1)}}
    rows.append(host)
    print(json.dumps(host), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="a checkout of the parent commit: time its kernels "
                         "and this checkout's in turns (old, new, new, old)")
    ap.add_argument("--label", default="new")
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernel names: time only these")
    args = ap.parse_args(argv)
    only = [k for k in args.kernels.split(",") if k]
    if not torch.cuda.is_available():
        sys.exit("kernel_bench: no CUDA device")
    if args.old is None:
        measure(args.label, only)
        return
    rows = []
    for label, src in (("old", args.old / "src"), ("new", SRC),
                       ("new", SRC), ("old", args.old / "src")):
        env = dict(os.environ, PYTHONPATH=str(src))
        out = subprocess.run(
            [sys.executable, __file__, "--label", label, "--kernels",
             args.kernels], env=env,
            check=True, capture_output=True, text=True).stdout
        rows += [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
    summary = {}
    for r in rows:
        if r["at"] == "floor":
            for k in ("flushed_ms", "warm_ms", "round_trip_ms"):
                summary.setdefault(f"floor {k}", {}).setdefault(
                    r["label"], []).append(r[k])
            continue
        if r["at"] == "host":
            for k, us in r["host_us_per_call"].items():
                summary.setdefault(f"host {k}", {}).setdefault(
                    r["label"], []).append(us)
            continue
        s = summary.setdefault(r["at"], {"shape": r["shape"],
                                         "l2": r["l2"]})
        if "unsupported" in r:  # an older tree's kernel lacks the shape
            s[f"{r['label']}_unsupported"] = r["unsupported"]
            continue
        s.setdefault(f"{r['label']}_kernel_ms", []).append(r["kernel_ms"])
        for k in ("plain_ms", "library_ms"):
            s.setdefault(k, []).append(r[k])
        s["bound_ms"], s["bound_by"] = r["bound_ms"], r["bound_by"]
    for s in summary.values():
        if "new_kernel_ms" in s:
            s["share_of_bound_new"] = [s["bound_ms"] / t
                                       for t in s["new_kernel_ms"]]
    out = {"card": rows[0]["card"], "turns": "old, new, new, old",
           "by_shape": summary}
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/kernel_bench.json").write_text(json.dumps(out,
                                                                indent=1))
    print(json.dumps(out))
    worst = max((x for s in summary.values()
                 for x in s.get("share_of_bound_new", [])), default=0.0)
    if not math.isfinite(worst) or worst > 1.05:
        sys.exit(f"kernel_bench: a share of the bound reads {worst} > 1.05")


if __name__ == "__main__":
    main()
