"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface.  ``load()`` compiles each source
with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all started at
once), links the objects into one shared library and loads it with
``ctypes``.  The library's file name carries a hash of the sources and the
flags, so a library built from other sources is never loaded.  It goes into
``build/`` beside this module, which ``.gitignore`` lists.

The build runs at first use, under a lock: the eight worker threads of the
threaded runtime may all make that first call at once.  Nothing here runs at
import, so the CPU tests import every module without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F = ctypes.c_float
# Every entry point returns cudaGetLastError() as an int.  Pointers and the
# stream are c_void_p: without argtypes ctypes would pass a Python int as a
# 32-bit C int and cut the pointer.
SIGNATURES = {
    # src, dst, nbytes, device, stream
    "repro_copy": (_P, _P, _I64, _I, _P),
    # x, y, out, n, dtype, a, device, stream
    "repro_triad": (_P, _P, _P, _I64, _I, _F, _I, _P),
    # x, y, out, m, n, k, in_dtype, out_dtype, device, stream
    "repro_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, out, rows, n, dtype, device, stream
    "repro_sort_rows": (_P, _P, _I, _I, _I, _I, _P),
    # q, k, v, out, batch, q_heads, kv_heads, seq_q, seq_k, head_dim, dtype,
    # causal, has_window, window, sm_scale, device, stream
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _F, _I, _P),
    # x, w, out, rows, d, x_dtype, w_dtype, eps, device, stream
    "repro_rmsnorm": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # time this process spent building
build_log = ""                      # nvcc's output (ptxas register counts)


class LaunchCounter:
    """Launches of one kernel: a plain integer ``count``.  Worker threads
    launch at once, so the increment takes a lock."""

    def __init__(self) -> None:
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library built from the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def _compile(target: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place atomically (a concurrent process sees all of it or none)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = tmp / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib = tmp / target.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, target)
        return "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                t0 = time.perf_counter()
                build_log = _compile(path)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = (ctypes.c_int,)
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
