"""AdamW with global-norm clipping, functional.  Twin of
``repro.optimizer.adamw``.

Parameters, gradients and moments are dicts of tensors keyed alike; the
moments are fp32 whatever the parameters' dtype.  ``adamw_update`` returns
new parameters and a new state and leaves its inputs as they were, as the
JAX update does, so the state is data that a checkpoint holds
(``torch.optim`` keeps it hidden and orders the update otherwise).  Every
formula is the JAX package's, in its order; leaves are taken in sorted key
order, as JAX flattens a dict, so sums over them agree too.
"""
from __future__ import annotations

import dataclasses

import torch

from ..parallel.sharding import abstract_tensor, is_sharded


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor   # int32 0-d, on the parameters' device
    mu: dict             # first moments (fp32)
    nu: dict             # second moments (fp32)


def adamw_init(params: dict) -> AdamWState:
    """Zero moments and step; on DTensor parameters (under a mesh) each
    moment takes its parameter's placements and the step is replicated, as
    ``abstract_opt_state`` lays them out."""
    first = next(iter(params.values()))
    if is_sharded(first):
        from torch.distributed.tensor import Replicate, zeros

        mesh = first.device_mesh
        step = zeros((), dtype=torch.int32, device_mesh=mesh,
                     placements=[Replicate()] * mesh.ndim)
        return AdamWState(
            step=step,
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()})
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()})


def abstract_opt_state(abstract_params: dict) -> AdamWState:
    """The state ``adamw_init`` would give ``abstract_params``, without
    allocating (twin of src/repro/launch/dryrun.py:95-102): fp32 meta
    moments, each a DTensor with its parameter's mesh and placements where
    the parameter is one, and a meta int32 0-d step, replicated under a
    mesh context."""
    def f32(p):
        sharding = (p.device_mesh, list(p.placements)) if is_sharded(p) \
            else None
        return abstract_tensor(p.shape, torch.float32, sharding)

    first = next(iter(abstract_params.values()))
    step_sharding = None
    if is_sharded(first):
        from torch.distributed.tensor import Replicate
        mesh = first.device_mesh
        step_sharding = (mesh, [Replicate()] * mesh.ndim)
    return AdamWState(step=abstract_tensor((), torch.int32, step_sharding),
                      mu={k: f32(p) for k, p in abstract_params.items()},
                      nu={k: f32(p) for k, p in abstract_params.items()})


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / (norm + 1e-9))``, each cast
    back to its dtype, and the global norm (fp32 sum of squares)."""
    sq = sum(torch.sum(torch.square(grads[k].float())) for k in sorted(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    # g in fp32 times the fp32 scale, as JAX promotes a bf16 g
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> tuple[dict, AdamWState]:
    """One AdamW step at ``lr`` (a float or an fp32 0-d tensor)."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        m = b1 * state.mu[k] + (1 - b1) * g32
        v = b2 * state.nu[k] + (1 - b2) * torch.square(g32)
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v)
