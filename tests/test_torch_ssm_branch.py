"""The SSM branch of mamba2 and hymba (``repro_torch.models.mamba2.
ssm_branch_full`` and ``ssm_branch_step``) outside any mesh, on the CPU:
its outputs and grads equal, bit for bit, those of an inline copy of the
branch as it ran before it learned to keep in_proj's blocks split over a
mesh (one product, its output sliced into z, x, B, C and dt, the conv over
the concatenated x, B and C).  Without a mesh the branch runs those very
ops: the card's path does not change.  Inputs come from numpy with a seed,
at the smoke mamba2-780m's and hymba-1.5b's widths, in fp32 and bf16."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.models import mamba2
from repro_torch.models.layers import merge_heads, split_heads

B, S = 2, 24   # a chunk edge (ssm_chunk 16) inside the sequence


def _old_full(h, in_proj, conv_w, conv_b, a_log, dt_bias, d_skip, *,
              d_inner, n, head_dim, chunk):
    """The branch over a sequence as it was written before the blocked
    layout: one product sliced into its blocks, the conv over the
    concatenated x, B and C."""
    S = h.shape[1]
    H = d_inner // head_dim
    proj = h @ in_proj.to(h.dtype)
    z, xs, b, c, dt = (proj[..., :d_inner], proj[..., d_inner:2 * d_inner],
                       proj[..., 2 * d_inner:2 * d_inner + n],
                       proj[..., 2 * d_inner + n:2 * d_inner + 2 * n],
                       proj[..., 2 * d_inner + 2 * n:])
    xbc = torch.cat([xs, b, c], dim=-1)
    w = conv_w.to(xbc.dtype)
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = pad[:, :S] * w[0]
    for i in range(1, K):
        conv = conv + pad[:, i:i + S] * w[i]
    conv = F.silu(conv + conv_b.to(conv.dtype))
    xs, b, c = (conv[..., :d_inner], conv[..., d_inner:d_inner + n],
                conv[..., d_inner + n:])
    dt = F.softplus(dt.float() + dt_bias.float())
    y, final = mamba2.ssd_chunked(split_heads(xs, H), dt, a_log, b, c,
                                  d_skip, chunk=min(chunk, S))
    y = merge_heads(y) * F.silu(z.float()).to(y.dtype)
    return y, (xbc[:, -(K - 1):].to(mamba2.ACT_DTYPE), final)


def _old_step(h, conv_c, ssd_c, in_proj, conv_w, conv_b, a_log, dt_bias,
              d_skip, *, d_inner, n, head_dim):
    """One decode step as it was written before the blocked layout."""
    H = d_inner // head_dim
    proj = h @ in_proj.to(h.dtype)
    z, xs, b, c, dt = (proj[..., :d_inner], proj[..., d_inner:2 * d_inner],
                       proj[..., 2 * d_inner:2 * d_inner + n],
                       proj[..., 2 * d_inner + n:2 * d_inner + 2 * n],
                       proj[..., 2 * d_inner + 2 * n:])
    xbc = torch.cat([xs, b, c], dim=-1)
    hist = torch.cat([conv_c, xbc[:, None]], dim=1)
    conv = torch.einsum("bkc,kc->bc", hist, conv_w.to(hist.dtype))
    conv = F.silu(conv + conv_b.to(conv.dtype))
    xs_c, b_c, c_c = (conv[:, :d_inner], conv[:, d_inner:d_inner + n],
                      conv[:, d_inner + n:])
    dt = F.softplus(dt.float() + dt_bias.float())
    y, new_ssd = mamba2.ssd_decode_step(ssd_c, xs_c.reshape(-1, H, head_dim),
                                        dt, a_log, b_c, c_c, d_skip)
    y = merge_heads(y) * F.silu(z.float()).to(y.dtype)
    return y, (hist[:, 1:].to(mamba2.ACT_DTYPE), new_ssd)


def _dims(arch: str) -> dict:
    cfg = get_smoke_config(arch)
    d_inner = cfg.d_inner if cfg.family == "ssm" else cfg.d_inner_hybrid
    return dict(M=cfg.d_model, d_inner=d_inner, n=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim, K=cfg.ssm_conv,
                chunk=cfg.ssm_chunk)


def _inputs(arch: str, dtype: torch.dtype, step: bool) -> tuple:
    """(tensors that take grads, the branch's keyword widths)."""
    d = _dims(arch)
    M, DI, N, K = d["M"], d["d_inner"], d["n"], d["K"]
    H = DI // d["head_dim"]
    rng = np.random.default_rng(5)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dt).requires_grad_()

    ts = {"h": t(B, M) if step else t(B, S, M),
          "in_proj": t(M, 2 * DI + 2 * N + H, scale=M ** -0.5),
          "conv_w": t(K, DI + 2 * N, scale=0.5),
          "conv_b": t(DI + 2 * N, scale=0.1),
          "a_log": t(H, scale=0.5, dt=torch.float32),
          "dt_bias": t(H, scale=0.5, dt=torch.float32),
          "d_skip": t(H, dt=torch.float32)}
    if step:
        ts["conv_c"] = t(B, K - 1, DI + 2 * N, dt=mamba2.ACT_DTYPE)
        ts["ssd_c"] = t(B, H, N, d["head_dim"], dt=torch.float32)
    kw = dict(d_inner=DI, n=N, head_dim=d["head_dim"])
    if not step:
        kw["chunk"] = d["chunk"]
    return ts, kw


def _outputs_and_grads(fn, ts: dict, kw: dict, step: bool) -> list:
    order = (("h", "conv_c", "ssd_c") if step else ("h",)) + (
        "in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip")
    y, (conv, ssd) = fn(*(ts[k] for k in order), **kw)
    rng = np.random.default_rng(9)
    outs = [y, conv, ssd]
    cot = [torch.from_numpy(rng.standard_normal(o.shape).astype(
        np.float32)).to(o.dtype) for o in outs]
    grads = torch.autograd.grad(outs, [ts[k] for k in order], cot,
                                allow_unused=True)
    return [o.detach() for o in outs] + list(grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
@pytest.mark.parametrize("step", [False, True], ids=["full", "step"])
def test_without_a_mesh_the_branch_is_the_old_one_bit_for_bit(arch, dtype,
                                                               step):
    """y, the conv state, the SSD state, and the grads of every input (h,
    the caches in a step, in_proj, the conv's weight and bias, a_log,
    dt_bias, d_skip), each ``torch.equal`` to the old branch's."""
    ts, kw = _inputs(arch, dtype, step)
    new, old = (mamba2.ssm_branch_step, _old_step) if step else \
        (mamba2.ssm_branch_full, _old_full)
    got = _outputs_and_grads(new, ts, kw, step)
    want = _outputs_and_grads(old, ts, kw, step)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), i
