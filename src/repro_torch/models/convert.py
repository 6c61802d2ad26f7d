"""Parameters as numpy arrays, for running one set of weights twice.

``params_from_numpy`` turns a JAX parameter dict, as numpy arrays (for
example ``{k: np.asarray(v) for k, v in jax_params.items()}``), into the
port's, under the same names and shapes and in the same dtypes, so that both
packages can run the same weights.  ``numpy_params`` draws a model's
parameters as such arrays from one seed, so that the card and the CPU can
run the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..workers import resolve_device
from .model_api import SSM_INITS, ssm_init


def params_from_numpy(np_params: dict, device="cuda") -> dict:
    """``{name: array}`` -> ``{name: tensor on device}`` (each array copied,
    so the tensor owns writable memory)."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(a)).to(dev)
            for name, a in np_params.items()}


def numpy_params(model, seed: int) -> dict:
    """Every parameter of ``model`` as a float32 numpy array from one seed:
    normal draws at each ParamDef's scale, norm weights (and the ssm skips,
    also initialised to ones) 1 plus a tenth of a normal draw (so that the
    weight matters), the ssm inits as JAX draws them: A_log = log U[1, 16),
    the dt bias softplus^-1 U[1e-3, 1e-1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in sorted(model.param_defs().items()):
        if d.init in SSM_INITS:
            lo, hi = SSM_INITS[d.init]
            u = rng.uniform(lo, hi, d.shape).astype(np.float32)
            out[name] = ssm_init(d.init, u).astype(np.float32)
            continue
        a = rng.standard_normal(d.shape, dtype=np.float32)
        out[name] = 1 + np.float32(0.1) * a if d.init == "ones" \
            else np.float32(d.scale) * a
    return out
