"""Tenant zoo: the port's payloads behind the serving orchestrator.  Twin of
``repro.launch.zoo``.

Each serving tenant runs one *flavor*: the ``transformer`` flavor serves the
llama3.2-1b decoder of the port's model zoo through its ``prefill`` and
``decode_step``; the raw ``kernel`` flavor binds ``kernels.ops`` directly (a
prefill slab of flash attention and a projection matmul, a decode burst of
KV-slab copies and a one-row GEMV); the ``ssm`` flavor serves mamba2-780m
and the ``hybrid`` flavor hymba-1.5b, each as the transformer flavor serves
its decoder.  A :class:`ZooTenant` builds
the kernels and runs its payloads once in ``warm()``; every payload shape is
fixed, so no request ever builds on a worker thread.

One prefill *chunk* stands for ``slab_tokens`` prompt tokens: a request's
prefill TAO carries ``ceil(prompt_len / slab_tokens)`` chunks, each chunk one
slab call.  Decode bursts stay single-chunk.  On the card each chunk runs on
its worker thread's own stream and returns once the stream has drained
(``workers.on_own_stream``), so the PTT learns device time.

Shapes.  ``ZOO_SHAPES`` are the JAX tenants' own (zoo.py:83-90, 126-128),
which the tests use: the kernel flavor's small fp32 operands, and each
model flavor's smoke config over 16 prompt tokens.  At those an H100
does a few microseconds of work per launch, so the card runs
``SERVE_SHAPES``: the kernel flavor at the widths of llama3.2-1b (d_model
2048, 32 query heads and 8 kv heads of 64; one chunk is the attention and
output projection of 1024 prompt tokens, the decode slab the KV cache of a
4096-token context), and each model flavor as its full model (llama3.2-1b,
mamba2-780m, hymba-1.5b) over the 1024 prompt tokens that one chunk stands
for.

Use with the orchestrator's general threaded entry point::

    zoo = default_zoo()
    warm_zoo(zoo)
    stats = run_serving_workload_threaded(reqs, spec, policy, zoo_binder(zoo))
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.dag import TAO, ImplVariant
from ..core.runtime import ChunkedWork
from ..core.serve_orchestrator import ServeRequest
from ..kernels import ops, reset_launch_counts
from ..models import (ModelConfig, get_model, make_decode_step,
                      make_prefill_step)
from ..workers import ChunkLog, on_own_stream, resolve_device

# flavor -> model-zoo architecture serving it
FLAVOR_ARCHS = {
    "transformer": "llama3.2-1b",
    "ssm": "mamba2-780m",
    "hybrid": "hymba-1.5b",
}
FLAVORS = ("kernel",) + tuple(FLAVOR_ARCHS)


@dataclasses.dataclass(frozen=True)
class ZooShapes:
    """The payloads' shapes.  Kernel flavor: q (batch, q_heads, seq,
    head_dim), one kv tensor (batch, kv_heads, seq, head_dim) serving as k
    and v, the projection w (width, width) with width = q_heads * head_dim,
    the decode slab (cache_rows, cache_cols) and the decode row x1
    (1, width), all in ``dtype``.  Model flavors: the architecture's smoke
    config if ``smoke_model`` else its full one, over ``model_prompt`` prompt
    tokens of one request."""

    batch: int
    q_heads: int
    kv_heads: int
    seq: int
    head_dim: int
    cache_rows: int
    cache_cols: int
    dtype: torch.dtype
    smoke_model: bool
    model_prompt: int

    @property
    def width(self) -> int:
        return self.q_heads * self.head_dim


# the JAX tenants': B, H, S, D = 1, 4, 256, 64 and a 4*S x H*D slab, fp32;
# the smoke model over tokens (1, 16)
ZOO_SHAPES = ZooShapes(1, 4, 4, 256, 64, 4 * 256, 4 * 64, torch.float32,
                       smoke_model=True, model_prompt=16)
# llama3.2-1b (configs/llama3_2_1b.py): one 1024-token chunk of 32 q heads
# over 8 kv heads of 64; the slab is 4*S = 4096 tokens of KV cache at 2 (K, V)
# x 16 layers x 8 kv heads x 64 values = 16384 bf16 (32 KiB) per token; the
# full model over the chunk's 1024 tokens
SERVE_SHAPES = ZooShapes(1, 32, 8, 1024, 64, 4 * 1024, 2 * 16 * 8 * 64,
                         torch.bfloat16, smoke_model=False, model_prompt=1024)


def kernel_arrays(shapes: ZooShapes = SERVE_SHAPES,
                  seed: int = 0) -> dict[str, np.ndarray]:
    """The kernel flavor's operands as float32 standard normals from a numpy
    seed: ``q, kv, w, cache_slab, x1``."""
    rng = np.random.default_rng(seed)
    s = shapes
    dims = {"q": (s.batch, s.q_heads, s.seq, s.head_dim),
            "kv": (s.batch, s.kv_heads, s.seq, s.head_dim),
            "w": (s.width, s.width),
            "cache_slab": (s.cache_rows, s.cache_cols),
            "x1": (1, s.width)}
    return {name: rng.standard_normal(d, dtype=np.float32)
            for name, d in dims.items()}


def kernel_operands_from_numpy(arrays: dict[str, np.ndarray], device="cuda",
                               dtype: torch.dtype = torch.bfloat16
                               ) -> dict[str, torch.Tensor]:
    """The tenant's tensors from numpy ``q, kv, w, cache_slab, x1``, on
    ``device`` in ``dtype`` (bf16 rounds to nearest even, as in JAX)."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(arrays[name], np.float32)).to(
        device=dev, dtype=dtype) for name in ("q", "kv", "w", "cache_slab",
                                              "x1")}


def model_config(flavor: str, shapes: ZooShapes = SERVE_SHAPES
                 ) -> ModelConfig:
    """The config a model flavor serves at ``shapes``."""
    arch = FLAVOR_ARCHS[flavor]
    return get_smoke_config(arch) if shapes.smoke_model else get_config(arch)


class ZooTenant:
    """One tenant's serving engine (a flavor and its payloads).

    ``prefill_slab()`` and ``decode_burst()`` are the two kernel classes the
    scheduler sees: the slab is compute-bound (flash attention and matmul),
    the burst memory-bound (the copy class, or a decode step streaming its
    weights).  ``decode_steps`` repeats the decode call inside one burst.
    Each returns what its last op computed.

    Kernel flavor: the operands come from ``kernel_arrays(shapes, seed)``
    unless ``operands`` (``kernel_operands_from_numpy``'s) are given.  Model
    flavors: ``model_config(flavor, shapes)`` unless ``config`` is given,
    parameters from ``init`` on a ``torch.Generator`` seeded ``seed`` unless
    ``params`` are given, tokens (1, ``shapes.model_prompt``) from one seeded
    ``seed + 1`` unless ``tokens`` are given.  ``device`` defaults to the
    card; without one it raises unless ``"cpu"`` is asked for, where the ops
    take their plain versions.
    """

    def __init__(self, name: str, flavor: str = "kernel",
                 slab_tokens: int = 1024, decode_steps: int = 1,
                 seed: int = 0, multi_impl: bool = False, *,
                 device="cuda", shapes: ZooShapes = SERVE_SHAPES,
                 operands: dict[str, torch.Tensor] | None = None,
                 config: ModelConfig | None = None,
                 params: dict | None = None,
                 tokens: torch.Tensor | None = None):
        if flavor not in FLAVORS:
            raise ValueError(f"unknown flavor {flavor!r}; known: {FLAVORS}")
        self.name = name
        self.flavor = flavor
        self.slab_tokens = max(1, int(slab_tokens))
        self.decode_steps = max(1, int(decode_steps))
        self.device = resolve_device(device)
        # multi_impl: bind every host-available kernel implementation
        # (ops.available_impls(): "ref" everywhere, as JAX's registry offers
        # it on every host, and "cuda" on the card) as TAO variants, so the
        # scheduler picks the impl jointly with (leader, width) and the PTT
        # learns each under its own key.  Kernel flavor only, as in JAX: the
        # model flavors run whole-model payloads with no variant axis.  Off
        # by default.
        self.multi_impl = bool(multi_impl) and flavor == "kernel"
        self._impl_payloads: dict = {}
        # the JAX formula (zoo.py:160-169): the kernel flavor's decode slab
        # over the slab_tokens it stands for; model flavors share the figure
        self._slab_bytes = shapes.cache_rows * shapes.cache_cols * \
            torch.empty((), dtype=shapes.dtype).element_size()
        if flavor == "kernel":
            if operands is None:
                operands = kernel_operands_from_numpy(
                    kernel_arrays(shapes, seed), self.device, shapes.dtype)
            self._build_kernel_payloads(operands)
        else:
            self._build_model_payloads(
                config or model_config(flavor, shapes), seed, params, tokens,
                shapes.model_prompt)
        # (impl, TAO type) -> the payload as a worker thread's chunk; impl
        # None is the default payload
        payloads = {(None, "prefill"): self.prefill_slab,
                    (None, "decode"): self.decode_burst}
        for name, (pf, df) in self._impl_payloads.items():
            payloads[name, "prefill"], payloads[name, "decode"] = pf, df
        self._chunks = on_own_stream(
            {key: lambda i, fn=fn: fn() for key, fn in payloads.items()},
            self.device)

    # -- payload construction -------------------------------------------
    def _build_kernel_payloads(self, operands: dict[str, torch.Tensor]
                               ) -> None:
        """kernels.ops, no model: the two classes in their pure form."""
        q, kv, w = operands["q"], operands["kv"], operands["w"]
        self.cache_slab, x1 = operands["cache_slab"], operands["x1"]
        b, hq, s, d = q.shape
        if b != 1:
            # the slab's raw reshape below needs B * Hq * S * D = S * Hq * D
            raise ValueError(f"the kernel flavor takes batch 1, got q "
                             f"{tuple(q.shape)}")

        def make_prefill(attn_op, mm_op) -> Callable[[], torch.Tensor]:
            def prefill_slab() -> torch.Tensor:
                attn = attn_op(q, kv, kv)
                # the JAX tenant's raw reshape of the head-major (1, H, S, D)
                # output, which mixes heads and positions (zoo.py:95)
                return mm_op(attn.reshape(s, hq * d), w)
            return prefill_slab

        def make_decode(copy_op, mm_op) -> Callable[[], tuple]:
            # The GEMV is one row: bm=1 passes the tiling check (the Pallas
            # matmul cannot tile m = 1), and the matmul kernel takes m <= 16
            # to its streaming path, which reads w once in one launch.
            def decode_burst() -> tuple:
                for _ in range(self.decode_steps):
                    moved = copy_op(self.cache_slab)
                    y = mm_op(x1, w, bm=1)
                return moved, y
            return decode_burst

        self.prefill_slab = make_prefill(ops.flash_attention, ops.matmul)
        self.decode_burst = make_decode(ops.copy, ops.matmul)
        if self.multi_impl:
            # JAX's variant swaps only the copy kernel and leaves the GEMV
            # on auto dispatch, since its Pallas matmul cannot tile one row.
            # The port's GEMV is a kernel launch, so a variant pins it too:
            # a "ref" chunk runs the plain versions alone.
            for im in ops.available_impls():
                self._impl_payloads[im.name] = (
                    make_prefill(im.op("flash_attention"), im.op("matmul")),
                    make_decode(im.op("copy"), im.op("matmul")))

    def _build_model_payloads(self, cfg: ModelConfig, seed: int,
                              params: dict | None,
                              tokens: torch.Tensor | None,
                              prompt: int) -> None:
        """The model's prefill over one request's prompt and its decode step
        (zoo.py:120-146).  The decode state is fixed: the prefill's cache,
        reused by every burst (serving-shape work, not a token-by-token
        generation).  ``decode_step`` is functional, so the worker threads
        may all step from it at once.  The weights are held as
        ``bf16_copy``'s: the values JAX computes with, cast once."""
        self.config = cfg
        self.model = model = get_model(cfg)
        dev = self.device
        if params is None:
            params = model.init(torch.Generator(dev).manual_seed(seed))
        weights = model.bf16_copy(
            {k: v.to(dev) for k, v in params.items()})
        if tokens is None:
            tokens = torch.randint(
                0, cfg.vocab_size, (1, prompt), device=dev,
                generator=torch.Generator(dev).manual_seed(seed + 1))
        toks = tokens.to(dev)
        last = toks[:, -1:]
        # the steps enter inference mode on the worker thread that runs them
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        _, self.cache0 = prefill(weights, {"tokens": toks})
        self.weights, self.tokens = weights, toks

        def prefill_slab() -> torch.Tensor:
            return prefill(weights, {"tokens": toks})[0]

        def decode_burst() -> torch.Tensor:
            for _ in range(self.decode_steps):
                logits, _ = decode(weights, last, self.cache0)
            return logits

        self.prefill_slab = prefill_slab
        self.decode_burst = decode_burst

    # -- serving interface ----------------------------------------------
    def warm(self) -> None:
        """Run every payload once on the calling thread, which builds the
        kernels, so that no build lands on a worker thread or in a PTT
        cell; then zero the launch counters."""
        self.prefill_slab()
        self.decode_burst()
        for pf, df in self._impl_payloads.values():
            pf()
            df()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        reset_launch_counts()

    def prefill_chunks(self, r: ServeRequest) -> int:
        return max(1, math.ceil(r.prompt_len / self.slab_tokens))

    def kv_bytes_per_token(self) -> float:
        """Per-token KV-cache bytes this tenant's decode streams: the kernel
        flavor's decode slab over the ``slab_tokens`` tokens it stands for
        (the JAX formula, which model flavors share; 1024 at
        ``ZOO_SHAPES``, as in JAX)."""
        return self._slab_bytes / float(self.slab_tokens)

    def bind(self, tao: TAO, r: ServeRequest,
             log: ChunkLog | None = None) -> None:
        """Attach this tenant's ChunkedWork payload to one serving TAO.

        With ``multi_impl`` the TAO also carries one ``ImplVariant`` per
        host-available kernel implementation, with the same chunks, and the
        policies choose which one runs.  With a ``log`` every chunk notes
        itself there."""
        n = self.prefill_chunks(r) if tao.type == "prefill" else 1

        def work(impl) -> ChunkedWork:
            fn = self._chunks[impl, tao.type]
            return ChunkedWork(fn if log is None else log.wrap(fn, tao), n)

        tao.work = work(None)
        if self._impl_payloads:
            tao.impls = tuple(ImplVariant(name, work(name))
                              for name in self._impl_payloads)
            tao.assigned_impl = tao.impls[0].name


def default_zoo(flavors: dict | None = None, slab_tokens: int = 1024,
                decode_steps: int = 1, seed: int = 0,
                multi_impl: bool = False, *, device="cuda",
                shapes: ZooShapes = SERVE_SHAPES) -> dict:
    """``tenant name -> ZooTenant``.  The default pairing is the JAX one:
    the latency-sensitive ``steady`` tenant serves a transformer, the
    ``burst`` tenant hammers the raw kernels.  ``multi_impl=True`` lets
    kernel-flavor tenants expose every host-available implementation as
    schedulable TAO variants."""
    flavors = flavors or {"steady": "transformer", "burst": "kernel"}
    return {name: ZooTenant(name, flavor=fl, slab_tokens=slab_tokens,
                            decode_steps=decode_steps, seed=seed + i,
                            multi_impl=multi_impl, device=device,
                            shapes=shapes)
            for i, (name, fl) in enumerate(flavors.items())}


def warm_zoo(zoo: dict) -> None:
    for tenant in zoo.values():
        tenant.warm()


def zoo_binder(zoo: dict, log: ChunkLog | None = None
               ) -> Callable[[TAO, ServeRequest], None]:
    """Binder for ``run_serving_workload_threaded``: dispatch each request's
    TAOs to its tenant's payloads (noting each chunk in ``log``, if given)."""
    def binder(tao: TAO, r: ServeRequest) -> None:
        if r.tenant not in zoo:
            raise KeyError(f"request {r.id}: no tenant {r.tenant!r} in zoo "
                           f"(have {sorted(zoo)})")
        zoo[r.tenant].bind(tao, r, log)
    return binder
