"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) of the port.  Twin of
``repro.models.mamba2``.

Chunked dual form: the sequence is split into chunks of Q tokens; within a
chunk the computation is a masked, decay-weighted, attention-like product,
and across chunks a short recurrence over the (H, N, P) states, a loop over
the chunks where JAX takes ``lax.associative_scan`` (the same sums up to
fp32 summation order).  Decode is the O(1)-state recurrent step.

Block layout, as the reference's: in_proj -> [z | x | B | C | dt],
depthwise causal conv over (x, B, C), SSD, gated RMSNorm, out_proj.  Both
norms of a layer and the final norm run the RMSNorm kernel; the scan, the
conv and the gating are plain PyTorch, as the JAX package writes them in
jnp (mamba2.py:28-131) and leaves them to XLA.  While a profiler records,
the conv and the scan run in the spans ``ssm.conv`` and ``ssm.scan``, which
``trace_main_path --families-only`` reads.

Numerics follow JAX: activations are bf16 (the embedding gathered, then
cast), the projections, the head and the conv weights are cast to the
activations' dtype where they are used, the SSD runs in fp32 and returns in
x's dtype, and ``a_log``, ``dt_bias``, ``d_skip`` and the norm weights are
read in fp32.  ``bf16_copy`` casts what JAX casts, once, with identical
values.

The cache holds, a layer, the conv's last K - 1 inputs (bf16) and the SSD
state (fp32), and ``pos``, a 0-dim int32 on the CPU.  ``prefill`` takes
``max_len`` and ignores it: an SSM cache has nothing to pad.  The reference's
``prefill`` takes no ``max_len``, so its ``serve --arch mamba2-780m`` stops
with a TypeError (ROADMAP.md, Queue 3, fault 6).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..parallel.sharding import (act_mesh_dim, constrain, from_blocks,
                                 is_shard, is_sharded, logical_spec,
                                 on_local_shards, placements, rows_of,
                                 split_blocked, summed_to_rows, to_blocks,
                                 weight_blocks, whole_over)
from .layers import (_span, embed, merge_heads, out_proj, remat, rmsnorm,
                     split_heads)
from .losses import lm_cross_entropy
from .model_api import (BaseModel, ParamDef, cache_pos, cache_tensor,
                        split_params, unbound)

ACT_DTYPE = torch.bfloat16
# read in fp32 where used: the norm weights and the SSD's scalars a head
_FP32 = ("final_norm.w", "layers.norm.w", "layers.gate_norm.w",
         "layers.a_log", "layers.d_skip", "layers.dt_bias")
# the logical names of the caches' conv and SSD states (mamba2.py:236-255),
# shared with the hybrid
CONV_NAMES = ("layers", "batch", None, "ff")
SSD_NAMES = ("layers", "batch", None, None, None)


def stacked_states(convs: list, ssds: list) -> dict:
    """The cache's ``conv`` and ``ssd`` from each layer's states, laid out
    by their names under a mesh (as ``init_cache`` lays them out): each
    layer's state taken to its slice of that layout and stacked on each
    rank's local shards (``on_local_shards``), where a release of DTensor
    would choose where to place the stack.  The states that a decode
    step makes are in that layout already (``ssm_branch_step``), so no
    collective runs; a prefill's SSD states, split over the heads, are
    gathered once each."""
    return {"conv": _stacked(convs, CONV_NAMES),
            "ssd": _stacked(ssds, SSD_NAMES)}


def _stacked(states: list, names: tuple) -> torch.Tensor:
    """``torch.stack(states)`` laid out by ``names``; under a mesh on
    local shards."""
    if not is_sharded(states[0]):
        return constrain(torch.stack(states), *names)
    from torch.distributed.tensor import Shard

    mesh, shape = states[0].device_mesh, (len(states), *states[0].shape)
    pls = placements(logical_spec(shape, names), mesh)
    # each state's placements: the stack's, a dim nearer the front
    one = [type(p)(p.dim - 1, **({"split_factor": p.split_factor}
                                 if type(p) is not Shard else {}))
           if is_shard(p) else p for p in pls]
    return on_local_shards(lambda *ts: torch.stack(ts),
                           [(t, one) for t in states], [pls])[0]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                chunk: int, shard_acts: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD in the chunked dual form (mamba2.py:28-115).

    x (B, L, H, P) inputs a head; dt (B, L, H) softplus'd step sizes; a_log
    (H,), -A = exp(a_log) > 0; b, c (B, L, N) input and output projections
    (one group, shared over the heads); d_skip (H,) the skip connection.
    Returns y (B, L, H, P) in x's dtype and the final state (B, H, N, P) in
    fp32.

    A tail short of a chunk is zero-padded: dt = 0 there makes the decay
    exp(0) = 1 and the contribution 0, so the outputs (sliced back) and the
    final state are exact.  The intra-chunk decay exp(La_i - La_j) is taken
    of -inf above the diagonal, where JAX takes ``where(causal, exp(diff),
    0)``: the same values, and no inf * 0 in the backward where the masked
    exponent overflows.

    Under a mesh the scan runs on each rank's (batch, heads) piece
    (``_ssd_sharded``).  ``shard_acts`` (``cfg.ssd_shard_acts``) is taken
    and changes nothing: the reference constrains the intra-chunk
    temporaries to the batch sharding (mamba2.py:75-84), and the port's are
    each rank's local piece, split over the batch and the heads, already."""
    if is_sharded(x):
        return _ssd_sharded(x, dt, a_log, b, c, d_skip, chunk)
    return _ssd(x, dt, a_log, b, c, d_skip, chunk=chunk)


def _pad_tail(t: torch.Tensor, pad: int) -> torch.Tensor:
    """t (B, L, ...) zero-padded by ``pad`` positions after L."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def _ssd(x, dt, a_log, b, c, d_skip, cb=None, *, chunk: int):
    """``ssd_chunked``'s body on plain tensors; ``cb`` the chunks' C . B
    products (B, nc, q, q) where the caller made them."""
    bsz, L, H, P = x.shape
    N = b.shape[-1]
    L_orig = L
    if L % chunk:
        pad = chunk - L % chunk
        x, dt, b, c = (_pad_tail(t, pad) for t in (x, dt, b, c))
        L += pad
    nc, q = L // chunk, chunk

    A = -torch.exp(a_log.float())                        # (H,)
    dt = dt.float()
    xr = x.reshape(bsz, nc, q, H, P).float()
    br = b.reshape(bsz, nc, q, N).float()
    cr = c.reshape(bsz, nc, q, N).float()
    dtr = dt.reshape(bsz, nc, q, H)
    # cumulative log-decay within each chunk
    La = torch.cumsum(dtr * A, dim=2)                    # (B, nc, q, H)

    # ---- intra-chunk: y_i = sum_{j <= i} (C_i . B_j) decay(i<-j) dt_j x_j
    Lh = La.transpose(2, 3)                              # (B, nc, H, q)
    ii = torch.arange(q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    decay = torch.exp((Lh[..., :, None] - Lh[..., None, :]).masked_fill(
        ~causal, float("-inf")))                         # (B, nc, H, i, j)
    if cb is None:
        cb = torch.einsum("bcin,bcjn->bcij", cr, br)     # (B, nc, q, q)
    w = cb[:, :, None] * decay * dtr.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.matmul(w, xr.transpose(2, 3))        # (B, nc, H, q, P)

    # ---- chunk states: S_c = sum_j exp(La_last - La_j) dt_j B_j x_j^T
    last = La[:, :, -1:, :]                              # (B, nc, 1, H)
    w_state = torch.exp(last - La) * dtr                 # (B, nc, q, H)
    s_loc = torch.einsum("bcjn,bcjhp->bchnp", br,
                         xr * w_state[..., None])        # (B, nc, H, N, P)

    # ---- inter-chunk recurrence: S_k = g_k S_{k-1} + s_loc_k
    g = torch.exp(last[:, :, 0, :])                      # (B, nc, H)
    state = torch.zeros_like(s_loc[:, 0])
    entering = []  # the state entering chunk k is S_{k-1}
    for k in range(nc):
        entering.append(state)
        state = g[:, k, :, None, None] * state + s_loc[:, k]
    s_prev = torch.stack(entering, dim=1)                # (B, nc, H, N, P)

    # ---- inter-chunk output: y_i = exp(La_i) C_i . S_prev
    y_inter = torch.einsum("bcin,bchnp->bchip", cr, s_prev) \
        * torch.exp(Lh)[..., None]                       # (B, nc, H, q, P)

    y = (y_intra + y_inter).transpose(2, 3).reshape(bsz, L, H, P)
    y = y + d_skip.float()[None, None, :, None] * x.float()
    return y[:, :L_orig].to(x.dtype), state


def _ssd_sharded(x, dt, a_log, b, c, d_skip, chunk: int):
    """``ssd_chunked`` on DTensors: ``_ssd`` on each rank's local shards
    (``on_local_shards``), its heads split over the heads' mesh dim where
    H divides it and whole on each rank where not, its batch as x's, B and
    C whole over the heads' dim.  Heads never mix, and every head reads the
    same B and C.  DTensor 2.11 refuses three of the scan's ops on a tensor
    split over two mesh dims: the tail's ``F.pad``, ``torch.matmul``'s view
    that merges the split batch and heads, and the ``flip`` of cumsum's
    backward; a local shard is a plain tensor.

    The chunks' C . B products read no head, so a rank of every heads
    piece would compute the same ones, and a count of the world's FLOPs
    (``local_split``) would take them once a piece.  They are made first,
    in a body of their own split over the batch alone (the tail's pad in
    it), and passed in: the world computes them once.  B's, C's and the
    products' grads come back as partial sums over the heads' dim, x's and
    dt's as shards.  The products' body keeps its cotangent a partial sum
    (``partial_grads``): its B and C grads add into the scan's unreduced,
    before the one reduction of each (``whole_over``)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, (bsz, L, H, P) = x.device_mesh, x.shape
    batch = rows_of(x)
    heads = [Replicate()] * mesh.ndim
    x_pls, state_pls = list(batch), list(batch)
    m = act_mesh_dim("act_heads", x)
    if m is not None and H % mesh.size(m) == 0:
        x_pls[m], state_pls[m], heads[m] = Shard(2), Shard(1), Shard(0)
    cb = on_local_shards(functools.partial(_chunk_products, chunk=chunk),
                         [(b, batch), (c, batch)], [batch],
                         partial_grads=True)[0]
    return on_local_shards(
        functools.partial(_ssd, chunk=chunk),
        [(x, x_pls), (dt, x_pls), (a_log, heads), (b, batch), (c, batch),
         (d_skip, heads), (cb, batch)], [x_pls, state_pls])


def _chunk_products(b, c, *, chunk: int) -> torch.Tensor:
    """The chunks' C . B products (B, nc, q, q) in fp32 of b, c (B, L, N),
    a tail short of a chunk zero-padded, as ``_ssd`` makes them."""
    pad = -b.shape[1] % chunk
    if pad:
        b, c = _pad_tail(b, pad), _pad_tail(c, pad)
    return torch.einsum("bcin,bcjn->bcij",
                        c.unflatten(1, (-1, chunk)).float(),
                        b.unflatten(1, (-1, chunk)).float())


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, a_log: torch.Tensor,
                    b_t: torch.Tensor, c_t: torch.Tensor,
                    d_skip: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step (mamba2.py:118-128).  state (B, H, N, P) fp32;
    x_t (B, H, P); dt_t (B, H); b_t, c_t (B, N).  Returns (y_t in x_t's
    dtype, the new state)."""
    A = -torch.exp(a_log.float())
    dt = dt_t.float()
    dA = torch.exp(dt * A[None, :])                      # (B, H)
    xf = x_t.float()
    upd = torch.einsum("bn,bh,bhp->bhnp", b_t.float(), dt, xf)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c_t.float(), new_state)
    y = y + d_skip.float()[None, :, None] * xf
    return y.to(x_t.dtype), new_state


def _ssd_step_local(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """``ssd_decode_step`` on DTensors, on each rank's local shards: the
    state stays in the cache's layout (``SSD_NAMES``: its batch rows, every
    head whole), the step's inputs take its rows (a ``Partial`` input is
    reduced there, never the state it makes), ``a_log`` and ``d_skip``
    whole.  The new state comes out in the cache's layout, as a state that
    is no partial sum."""
    from torch.distributed.tensor import Replicate

    rows = rows_of(state)
    whole = [Replicate()] * state.device_mesh.ndim
    return on_local_shards(
        ssd_decode_step, [(state, rows), (x_t, rows), (dt_t, rows),
                          (a_log, whole), (b_t, rows), (c_t, rows),
                          (d_skip, whole)], [rows, rows])


def _dt_softplus(dt: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """softplus(dt + dt_bias) in fp32.  A serving step (no graph recorded)
    under a mesh runs it on each rank's local shards, one op, where
    DTensor 2.11 decomposes softplus into four (B, S, H) temporaries; a
    training step keeps DTensor's op."""
    if not is_sharded(dt) or torch.is_grad_enabled():
        return F.softplus(dt.float() + dt_bias.float())
    from torch.distributed.tensor import Replicate, Shard

    last = dt.ndim - 1
    pls = [p if is_shard(p) else Replicate() for p in dt.placements]
    bias = [Shard(0) if is_shard(p) and p.dim == last else Replicate()
            for p in pls]
    return on_local_shards(lambda d, b: F.softplus(d.float() + b.float()),
                           [(dt, pls), (dt_bias, bias)], [pls])[0]


# ---------------------------------------------------------------------------
# the SSM branch, shared with the hybrid
# ---------------------------------------------------------------------------
def split_proj(proj: torch.Tensor, d_inner: int, n: int):
    """in_proj's output -> (z, x, B, C, dt) along the last dim."""
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner],
            proj[..., 2 * d_inner:2 * d_inner + n],
            proj[..., 2 * d_inner + n:2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def _offsets(widths) -> list:
    return [sum(widths[:i]) for i in range(len(widths))]


def proj_blocks(h: torch.Tensor, in_proj: torch.Tensor, widths, m: int
                ) -> list:
    """``h @ in_proj`` under a mesh as its blocks of ``widths`` (z, x, B,
    C, dt), none gathered: the blocks whose widths divide mesh dim ``m``
    come from one product by in_proj's columns in the blocked order
    (``weight_blocks``, joined), each split over ``m``; any other block
    from a product by its own columns, whole on each rank (gathered where
    DTensor splits the product unevenly).  Otherwise only the weight moves
    (gathered over ``m``), where slicing the product of the stored column
    order would gather it whole once a slice; its grad is reduced to
    in_proj's placements in one closed form, never gathered over ``m``
    where in_proj is split there.
    A product that DTensor leaves a partial sum (a batch of one: h whole
    on each rank, in_proj's M split over ``data``) is reduced first
    (``summed_to_rows``): the conv, the gate and the step read the blocks,
    none of them linear."""
    T = h.device_mesh.size(m)
    spans = list(zip(_offsets(widths), widths))
    split = [n % T == 0 for n in widths]
    ws = iter(weight_blocks(in_proj.to(h.dtype), spans, split, m,
                            joined=True))
    got = {}
    if any(split):
        got = dict(zip((i for i, s in enumerate(split) if s), split_blocked(
            summed_to_rows(h @ next(ws)), [n for n, s in zip(widths, split)
                                           if s], m)))
    return [got[i] if s else whole_over(summed_to_rows(h @ next(ws)), m)
            for i, s in enumerate(split)]


def conv_blocks(blocks, conv_w: torch.Tensor, conv_b: torch.Tensor, fn,
                m: int, out_ndim: int) -> list:
    """``fn(block, its conv weight columns, its bias)``, a tensor of
    ``out_ndim`` dims, for each of ``blocks`` (x, B, C), whose last dims
    take the conv's channels in turn.  ``fn`` runs on each rank's local
    shards (``on_local_shards``): a depthwise conv mixes no channels, and
    DTensor 2.11 cannot pad a tensor split on another dim.  A block split
    over mesh dim ``m`` meets its weight columns split there too (the
    weights cast to the blocks' dtype, as ``causal_conv`` casts them, and
    gathered over ``m`` first: they are small; ``weight_blocks``, whose
    grads are reduced to the weights' placements in one closed form)."""
    from torch.distributed.tensor import Shard

    dtype = blocks[0].dtype
    widths = [t.shape[-1] for t in blocks]
    spans = list(zip(_offsets(widths), widths))
    split = [is_shard(t.placements[m]) for t in blocks]
    out = []
    for t, w, b in zip(blocks, weight_blocks(conv_w.to(dtype), spans, split,
                                             m),
                       weight_blocks(conv_b.to(dtype), spans, split, m)):
        pls = tuple(t.placements)
        out_pls = [Shard(out_ndim - 1) if is_shard(p) and p.dim == t.ndim - 1
                   else p for p in pls]
        out.append(on_local_shards(fn, [(t, pls), (w, w.placements),
                                        (b, b.placements)], [out_pls])[0])
    return out


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """silu(depthwise causal conv of xbc (B, S, C) by w (K, C) + bias), in
    xbc's dtype, its K shifted products summed in order from the oldest, as
    the reference's Python ``sum`` adds them (mamba2.py:186-189)."""
    w = w.to(xbc.dtype)
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = pad[:, :S] * w[0]
    for i in range(1, K):
        conv = conv + pad[:, i:i + S] * w[i]
    return F.silu(conv + bias.to(conv.dtype))


def conv_step(hist: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
              ) -> torch.Tensor:
    """The conv's one output of a decode step: silu(the K inputs hist (B,
    K, C) by w (K, C) + bias) (mamba2.py:296-300)."""
    conv = torch.einsum("bkc,kc->bc", hist, w.to(hist.dtype))
    return F.silu(conv + bias.to(conv.dtype))


def ssm_branch_full(h: torch.Tensor, in_proj: torch.Tensor,
                    conv_w: torch.Tensor, conv_b: torch.Tensor,
                    a_log: torch.Tensor, dt_bias: torch.Tensor,
                    d_skip: torch.Tensor, *, d_inner: int, n: int,
                    head_dim: int, chunk: int, shard_acts: bool = False):
    """The SSM branch over a whole sequence, up to the gate: h (B, S, M)
    -> (y * silu(z) (B, S, d_inner) in h's dtype, (conv state (B, K - 1,
    conv_dim) in ``ACT_DTYPE``, SSD state (B, H, N, P) fp32)).
    mamba2.py:180-198 and hybrid.py:85-107 are this function.

    Under a mesh the branch keeps in_proj's blocks and the conv's outputs
    split over ``act_ff``'s mesh dim (``proj_blocks``, ``conv_blocks``);
    B and C are gathered once each, for the SSD, which every head reads,
    their grads reduced by one reduce-scatter each (``whole_over``), and the
    conv state takes the cache's column order by one all-to-all of its
    K - 1 rows (``from_blocks``)."""
    S = h.shape[1]
    H = d_inner // head_dim
    K = conv_w.shape[0]
    m = act_mesh_dim("act_ff", h)
    if m is None:
        proj = h @ in_proj.to(h.dtype)
        z, xs, b, c, dt = split_proj(proj, d_inner, n)
        xbc = torch.cat([xs, b, c], dim=-1)               # (B, S, conv_dim)
        with _span("ssm.conv"):
            conv = causal_conv(xbc, conv_w, conv_b)
        xs, b, c = (conv[..., :d_inner], conv[..., d_inner:d_inner + n],
                    conv[..., d_inner + n:])
        tail = xbc[:, -(K - 1):]
    else:
        z, xs, b, c, dt = proj_blocks(h, in_proj,
                                      (d_inner, d_inner, n, n, H), m)
        tail = from_blocks([t[:, -(K - 1):] for t in (xs, b, c)], m)
        with _span("ssm.conv"):
            xs, b, c = conv_blocks((xs, b, c), conv_w, conv_b, causal_conv,
                                   m, out_ndim=3)
        b, c = whole_over(b, m), whole_over(c, m)
    dt = constrain(dt, "batch", "seq", "act_heads")   # as ssm_branch_step
    dt = _dt_softplus(dt, dt_bias)
    with _span("ssm.scan"):
        y, final = ssd_chunked(split_heads(xs, H), dt, a_log, b, c, d_skip,
                               chunk=min(chunk, S), shard_acts=shard_acts)
    y = merge_heads(y) * F.silu(z.float()).to(y.dtype)
    return y, (tail.to(ACT_DTYPE), final)


def ssm_branch_step(h: torch.Tensor, conv_c: torch.Tensor,
                    ssd_c: torch.Tensor, in_proj: torch.Tensor,
                    conv_w: torch.Tensor, conv_b: torch.Tensor,
                    a_log: torch.Tensor, dt_bias: torch.Tensor,
                    d_skip: torch.Tensor, *, d_inner: int, n: int,
                    head_dim: int):
    """One decode step of the SSM branch, up to the gate: h (B, M) ->
    (y * silu(z) (B, d_inner), (new conv state, new SSD state)).
    mamba2.py:293-309 and hybrid.py:203-223 are this function.  Under a
    mesh, as ``ssm_branch_full``: the cached conv state is taken to the
    blocks' layout and back by an all-to-all of its K - 1 rows
    (``to_blocks``, ``from_blocks``), and the conv runs on each block."""
    H = d_inner // head_dim
    m = act_mesh_dim("act_ff", h)
    if m is None:
        proj = h @ in_proj.to(h.dtype)                   # (B, d_in_proj)
        z, xs, b, c, dt = split_proj(proj, d_inner, n)
        xbc = torch.cat([xs, b, c], dim=-1)               # (B, conv_dim)
        hist = torch.cat([conv_c, xbc[:, None]], dim=1)   # (B, K, conv_dim)
        with _span("ssm.conv"):
            conv = conv_step(hist, conv_w, conv_b)
        xs_c, b_c, c_c = (conv[:, :d_inner], conv[:, d_inner:d_inner + n],
                          conv[:, d_inner + n:])
        hist = hist[:, 1:]
    else:
        z, xs, b, c, dt = proj_blocks(h, in_proj,
                                      (d_inner, d_inner, n, n, H), m)
        hists = [torch.cat([old, new[:, None]], dim=1) for old, new in
                 zip(to_blocks(conv_c, (d_inner, n, n), m), (xs, b, c))]
        with _span("ssm.conv"):
            xs_c, b_c, c_c = conv_blocks(hists, conv_w, conv_b, conv_step,
                                         m, out_ndim=2)
        hist = from_blocks([t[:, 1:] for t in hists], m)
        b_c, c_c = whole_over(b_c, m), whole_over(c_c, m)
    # the step runs in the SSD cache's layout (SSD_NAMES: a rank holds
    # every head of its batch shard), so the new state is written where
    # the cache keeps it: the step's (B, d_inner) and (B, H) inputs are
    # replicated over the heads, where a state updated over sharded heads
    # would be gathered whole for the cache at every step
    dt = constrain(dt, "batch", None)
    dt = _dt_softplus(dt, dt_bias)
    xs_c = constrain(xs_c, "batch", None)
    step = ssd_decode_step if m is None else _ssd_step_local
    with _span("ssm.scan"):
        y, new_ssd = step(ssd_c, xs_c.reshape(-1, H, head_dim), dt, a_log,
                          b_c, c_c, d_skip)
    y = merge_heads(y) * F.silu(z.float()).to(y.dtype)
    return y, (hist.to(ACT_DTYPE), new_ssd)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
class Mamba2LM(BaseModel):
    """The attention-free SSD language model (mamba2-780m)."""

    def param_defs(self) -> dict:
        cfg = self.cfg
        L, M, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
        DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = DI + 2 * N
        d_in_proj = 2 * DI + 2 * N + H
        return {
            "embed.w": ParamDef((V, M), ("vocab", "embed")),
            "final_norm.w": ParamDef((M,), (None,), init="ones"),
            "head.w": ParamDef((M, V), ("embed", "vocab")),
            "layers.norm.w": ParamDef((L, M), ("layers", None), init="ones"),
            "layers.in_proj.w": ParamDef((L, M, d_in_proj),
                                         ("layers", "embed", "ff")),
            "layers.conv.w": ParamDef((L, cfg.ssm_conv, conv_dim),
                                      ("layers", None, "ff")),
            "layers.conv.b": ParamDef((L, conv_dim), ("layers", "ff"),
                                      init="zeros"),
            "layers.a_log": ParamDef((L, H), ("layers", None), init="ssm_a"),
            "layers.d_skip": ParamDef((L, H), ("layers", None), init="ones"),
            "layers.dt_bias": ParamDef((L, H), ("layers", None),
                                       init="ssm_dt"),
            "layers.gate_norm.w": ParamDef((L, DI), ("layers", "ff"),
                                           init="ones"),
            "layers.out_proj.w": ParamDef((L, DI, M),
                                          ("layers", "ff", "embed")),
        }

    @staticmethod
    def bf16_copy(params: dict) -> dict:
        """``params`` with every weight that JAX casts to bf16 at use
        (mamba2.py:181, 185, 189, 201, 212, 226) cast once; the norm
        weights, ``a_log``, ``dt_bias`` and ``d_skip`` stay fp32."""
        return {k: v if k in _FP32 else v.to(ACT_DTYPE)
                for k, v in params.items()}

    def _branch_kw(self) -> dict:
        cfg = self.cfg
        return dict(d_inner=cfg.d_inner, n=cfg.ssm_state,
                    head_dim=cfg.ssm_head_dim)

    # ------------------------------------------------------------- layer --
    def _layer_full(self, p: dict, x: torch.Tensor):
        """x + out_proj(gate_norm(ssm(norm(x)))) over the whole sequence;
        returns (x, (conv state, SSD state))."""
        cfg = self.cfg
        h = rmsnorm(x, p["norm.w"], cfg.norm_eps)
        y, state = ssm_branch_full(
            h, p["in_proj.w"], p["conv.w"], p["conv.b"], p["a_log"],
            p["dt_bias"], p["d_skip"], chunk=cfg.ssm_chunk,
            shard_acts=cfg.ssd_shard_acts, **self._branch_kw())
        y = rmsnorm(y, p["gate_norm.w"], cfg.norm_eps)
        y = constrain(y, "batch", "seq", "act_ff")
        x = constrain(x + y @ p["out_proj.w"].to(y.dtype),
                      "batch", "seq", "act_embed")
        return x, state

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return embed(params["embed.w"], tokens, ACT_DTYPE)

    def _layers(self, params: dict, tokens: torch.Tensor):
        """Backbone over ``tokens``: yields (x, state) after each layer."""
        _, stacked = split_params(params)
        x = self._embed(params, tokens)
        for p in unbound(stacked):
            x, state = self._layer_full(p, x)
            yield x, state

    def _head(self, params: dict, x: torch.Tensor, last: bool = False
              ) -> torch.Tensor:
        """Final norm and LM head; ``last``: the head of the last position
        alone (the norm runs over every position first, as in JAX)."""
        x = rmsnorm(x, params["final_norm.w"], self.cfg.norm_eps)
        if last:
            x = x[:, -1:]
        return x @ params["head.w"].to(x.dtype)

    # ----------------------------------------------------------- forward --
    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, V).  Under ``cfg.remat``
        each layer runs under ``remat``, policy ``"nothing"`` whatever
        ``remat_policy`` says, as the reference's forward does
        (mamba2.py:216-218)."""
        _, stacked = split_params(params)
        x = self._embed(params, batch["tokens"])

        def layer(p, x):
            return self._layer_full(p, x)[0]

        if self.cfg.remat:
            layer = remat(layer)
        for p in unbound(stacked):
            x = layer(p, x)
        return constrain(self._head(params, x), "batch", "seq", "vocab")

    def loss(self, params: dict, batch: dict):
        loss = lm_cross_entropy(self.forward(params, batch),
                                batch["targets"], onehot=self.cfg.ce_onehot)
        return loss, {"loss": loss}

    # ------------------------------------------------------------- serve --
    def init_cache(self, batch_size: int, max_len: int, *, device
                   ) -> dict:
        """An empty cache (mamba2.py:236-255): ``conv`` (L, B, K - 1,
        conv_dim) in ``ACT_DTYPE`` (bf16) and ``ssd`` (L, B, H, N, P) fp32
        on ``device``, ``pos`` a 0-dim int32 on the CPU; on ``"meta"`` an
        abstract cache, sharded by JAX's names.  ``max_len`` does not
        matter."""
        cfg = self.cfg
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        return {
            "conv": cache_tensor(
                (cfg.n_layers, batch_size, cfg.ssm_conv - 1, conv_dim),
                CONV_NAMES, ACT_DTYPE, device),
            "ssd": cache_tensor(
                (cfg.n_layers, batch_size, cfg.ssm_heads, cfg.ssm_state,
                 cfg.ssm_head_dim), SSD_NAMES, torch.float32, device),
            "pos": cache_pos(device)}

    def prefill(self, params: dict, batch: dict, max_len: int | None = None):
        """Encode the prompt: (last-token logits (B, 1, V), the cache of
        each layer's final conv and SSD states), ``pos`` the prompt length
        (mamba2.py:257-279).  ``max_len`` is taken and ignored (fault 6 of
        the reference, whose prefill does not take it)."""
        tokens = batch["tokens"]
        convs, ssds = [], []
        x = None
        for x, (conv, ssd) in self._layers(params, tokens):
            convs.append(conv)
            ssds.append(ssd)
        logits = self._head(params, x, last=True)
        return logits, {**stacked_states(convs, ssds),
                        "pos": torch.tensor(tokens.shape[1],
                                            dtype=torch.int32)}

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """One-token recurrent step, tokens (B, 1) -> (logits (B, 1, V), a
        new cache); ``cache`` is left as it was (mamba2.py:281-319)."""
        cfg = self.cfg
        top, stacked = split_params(params)
        x = embed(top["embed.w"], tokens[:, 0], ACT_DTYPE)  # (B, M)
        convs, ssds = [], []
        for p, conv_c, ssd_c in zip(unbound(stacked), cache["conv"],
                                    cache["ssd"]):
            h = rmsnorm(x, p["norm.w"], cfg.norm_eps)
            y, (conv, ssd) = ssm_branch_step(
                h, conv_c, ssd_c, p["in_proj.w"], p["conv.w"], p["conv.b"],
                p["a_log"], p["dt_bias"], p["d_skip"], **self._branch_kw())
            y = rmsnorm(y, p["gate_norm.w"], cfg.norm_eps)
            x = x + out_proj(y, p["out_proj.w"].to(y.dtype), x)
            convs.append(conv)
            ssds.append(ssd)
        logits = self._head(top, x)[:, None, :]
        return logits, {**stacked_states(convs, ssds),
                        "pos": torch.tensor(int(cache["pos"]) + 1,
                                            dtype=torch.int32)}
