"""The dry run's temp holds each layer's residual once (ROADMAP.md, Queue 3,
fault H), on the CPU; imports no jax, so it runs on any host of the port.

On a device a collective's result lives on behind funcol's autograd
wrapper (``_c10d_functional._wrap_tensor_autograd``), whose meta kernel
allocates a new tensor.  ``StepCounter`` counts the wrapper at 0 bytes and
keeps the result's storage live for as long as the wrapper lives.  A
sharded layer whose output leaves an all-reduce or an all-gather (the
residual add run on partial sums, then reduced) is then counted once, as
remat saves it; counted at 0 with its storage let go, the step's temp
lost one residual a layer.

Held here, on the smoke configs of the five families on a fake 2x2 (data,
model) world, at depths 2 and 4 (the peak's place does not move with the
depth): a train step's temp grows by one residual a layer under remat
``"nothing"``, and under ``"dots"`` by the residual and the products
``"dots"`` keeps (their outputs at local shapes); the storages of the
residual's local size at the peak are one more a layer; a prefill's peak
holds the same residual-sized buffers at every depth.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Partial, Replicate
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.parallel.sharding import abstract_tensor, use_sharding

FAMILIES = ["llama3.2-1b", "mixtral-8x22b", "mamba2-780m", "hymba-1.5b",
            "hubert-xlarge"]
S, B, MODEL = 256, 16, 2     # B over data=2: 8 rows a rank
DEPTHS = (2, 4)


def _mesh():
    return DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))


def test_a_collectives_result_is_held_behind_its_wrapper():
    """A (8, 32) fp32 partial sum all-reduced: its result is held while
    the DTensor that wraps it lives, and let go with it."""
    row = 8 * 4
    with fake_world(4):
        m = _mesh()
        partial = abstract_tensor((8, 32), torch.float32,
                                  (m, [Partial(), Replicate()]))
        wide = abstract_tensor((8, 96), torch.float32,
                               (m, [Replicate(), Replicate()]))
        counter = dryrun.StepCounter((partial, wide))
        with use_sharding(m), counter:
            y = partial.redistribute(m, [Replicate(), Replicate()])
            z = y * 2
            assert counter.peak_bytes == 2 * 32 * row   # y's result and z
            del y, z
            w = wide * 3
        assert w.to_local().shape == (8, 96)
        assert counter.peak_bytes == 96 * row
    assert not dist.is_initialized()


class _Sizes(dryrun.StepCounter):
    """``StepCounter`` that keeps each storage's numel and dtype, as the
    op that made it saw them, and those of the storages live at the
    peak."""

    def __init__(self, args):
        super().__init__(args)
        self.kind, self.at_peak = {}, []

    def _made(self, out, *how, **kw):
        held, peak = set(self._live), self.peak_bytes
        super()._made(out, *how, **kw)
        for t in dryrun._locals(out):
            ref = StorageWeakRef(t.untyped_storage())
            if ref in self._live and ref not in held:
                self.kind[ref] = (t.numel(), t.dtype)
        if self.peak_bytes > peak:
            # raising the peak swept the dead storages out of ``_live``
            self.at_peak = [self.kind.get(r) for r, n in self._live.items()
                            if n]


def _peak(arch: str, kind: str, policy: str, depth: int):
    """(temp bytes, storages at the peak of the residual's local numel in
    bf16, the residual's local bytes) of ``arch``'s smoke step at
    ``depth`` layers on the fake 2x2 world."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), remat=True,
                              remat_policy=policy, n_layers=depth)
    with fake_world(4):
        with use_sharding(_mesh()):
            step, args, _ = dryrun.build_step_and_specs(
                cfg, tconfigs.ShapeSpec("t", kind, S, B))
            counter = _Sizes(args)
            with dryrun.native_all_to_all(), counter:
                step(*args)
    numel = B // 2 * S * cfg.d_model
    held = counter.at_peak.count((numel, torch.bfloat16))
    return counter.peak_bytes, held, 2 * numel


def _saved_a_token(cfg, policy: str) -> int:
    """Bytes a layer keeps for the backward a token, at a rank's local
    shapes: its input (bf16, d_model) under ``"nothing"``, which the SSM and
    hybrid forwards take whatever the policy; under ``"dots"`` also the
    outputs of its products without batch dims, in bf16: q, k and v (heads
    over ``model``), the attention's out projection, the dense FFN's w1
    and w3 (hidden over ``model``) and w2, or the MoE router's fp32 logits
    over the rank's experts (its experts' products have a batch dim)."""
    d = cfg.d_model
    if policy != "dots" or cfg.family in ("ssm", "hybrid"):
        return 2 * d
    attn = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd // MODEL + d
    if cfg.is_moe:
        return 2 * (d + attn) + 4 * cfg.n_experts // MODEL
    return 2 * (d + attn + 2 * cfg.d_ff // MODEL + d)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_a_train_step_holds_one_residual_a_layer(arch, policy):
    """Two more layers raise the sharded train step's temp by two layers'
    saved bytes (``_saved_a_token`` over the rank's B/2 x S tokens), and
    under ``"nothing"`` the storages of the residual's size at the peak by
    two."""
    (t0, n0, res), (t1, n1, _) = (_peak(arch, "train", policy, L)
                                  for L in DEPTHS)
    cfg = tconfigs.get_smoke_config(arch)
    per_layer = _saved_a_token(cfg, policy) * B // 2 * S
    assert t1 - t0 == (DEPTHS[1] - DEPTHS[0]) * per_layer, \
        (t0, t1, (t1 - t0) / res)
    if _saved_a_token(cfg, policy) == 2 * cfg.d_model:
        assert n1 - n0 == DEPTHS[1] - DEPTHS[0], (n0, n1)


# residual-sized bf16 buffers at a prefill's peak: the layer's input and
# its norm's output; mamba2 also in_proj's x block and the conv's output
# (d_inner / model = d_model columns a rank)
PREFILL_HELD = {"mamba2-780m": 4}


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_prefill_holds_its_residuals_at_every_depth(arch):
    """A sharded prefill keeps no residual from one layer to the next: at
    its peak the same residual-sized buffers live at depth 2 and 4."""
    held = [_peak(arch, "prefill", "nothing", L)[1] for L in DEPTHS]
    assert held == [PREFILL_HELD.get(arch, 2)] * 2
