"""No train step of the port leaves a tensor in a reference cycle, on the
CPU; imports no jax, so it runs on any host of the port.

A tensor in a cycle lives until Python's next full collection, which may
come many steps later: the memory a step holds then depends on when the
collector last ran.  torch's ``checkpoint`` (the models' remat) imports
``torch._dynamo`` at its first call, and that import leaves frames in a
cycle whose ``f_back`` chain held the first train step's frames, each with
its last locals (params, grads, activations), until such a collection;
``models.layers`` now imports it first.

Held here: in a fresh interpreter the first and second train steps of the
smoke llama3.2-1b (remat on) and mamba2-780m leave no tensor that only a
cycle keeps; on 4 gloo ranks (a 2x2 data x model mesh) neither do the
sharded steps of the smoke mamba2-780m and hymba-1.5b, whose SSM branch
runs its closed forms on local shards (``on_local_shards`` keeps each
body's local graph for its backward).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
RANKS_TIMEOUT_S = 300

# a fresh interpreter: two train steps of ``arch``'s smoke config, each
# with the collector off, then one collection that keeps what it finds
# (DEBUG_SAVEALL); prints, a step each, the tensors among it
_FRESH = """
import gc, json, sys
import numpy as np, torch
from repro_torch import configs
from repro_torch.models import get_model, make_train_step
from repro_torch.optimizer import adamw_init

cfg = configs.get_smoke_config(sys.argv[1])
model = get_model(cfg)
params = model.init(torch.Generator().manual_seed(0))
toks = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (2, 33)))
batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
step, opt, found = make_train_step(model), adamw_init(params), []
for _ in range(2):
    gc.collect()
    gc.disable()
    params, opt, _ = step(params, opt, batch)
    gc.set_debug(gc.DEBUG_SAVEALL)
    gc.collect()
    gc.set_debug(0)
    found.append(sum(isinstance(o, torch.Tensor) for o in gc.garbage))
    gc.garbage.clear()
    gc.enable()
print(json.dumps(found))
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), *filter(None, [env.get("PYTHONPATH")])])
    return env


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
def test_a_fresh_process_train_steps_leave_no_tensor_in_a_cycle(arch):
    """The first train step of a process (the one that imports torch's
    lazy modules) and the second leave no tensor that only a cycle
    keeps."""
    got = subprocess.run([sys.executable, "-c", _FRESH, arch],
                         capture_output=True, text=True, env=_env(),
                         timeout=RANKS_TIMEOUT_S)
    assert got.returncode == 0, got.stderr[-4000:]
    assert json.loads(got.stdout.splitlines()[-1]) == [0, 0]


def _rank_main(rank: int, tmp: str) -> None:
    """One of the 4 gloo ranks: three sharded train steps of each smoke
    SSM config, the last two with the collector off and then one
    collection that keeps what it finds; writes, a config each, the
    tensors among it after each of the two steps."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import configs
    from repro_torch.models import get_model, make_train_step
    from repro_torch.optimizer import adamw_init
    from repro_torch.parallel.sharding import place, use_sharding

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), WORLD), rank=rank, world_size=WORLD)
    found = {}
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        for arch in ("mamba2-780m", "hymba-1.5b"):
            cfg = configs.get_smoke_config(arch)
            model = get_model(cfg)
            toks = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (4, 33)))
            with use_sharding(mesh):
                params = model.place(model.init(
                    torch.Generator().manual_seed(0)))
                batch = {k: place(v, ("batch", "seq")) for k, v in (
                    ("tokens", toks[:, :-1]), ("targets", toks[:, 1:]))}
                step = make_train_step(model)
                params, opt, _ = step(params, adamw_init(params), batch)
                found[arch] = []
                for _ in range(2):
                    gc.collect()
                    gc.disable()
                    params, opt, _ = step(params, opt, batch)
                    gc.set_debug(gc.DEBUG_SAVEALL)
                    gc.collect()
                    gc.set_debug(0)
                    found[arch].append(sum(isinstance(o, torch.Tensor)
                                           for o in gc.garbage))
                    gc.garbage.clear()
                    gc.enable()
    finally:
        dist.destroy_process_group()
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(found))


def test_sharded_ssm_train_steps_leave_no_tensor_in_a_cycle(tmp_path):
    """On the 2x2 mesh, every rank: no sharded train step of mamba2 or
    hymba leaves a tensor that only a cycle keeps."""
    import torch.multiprocessing as mp

    procs = mp.start_processes(_rank_main, args=(str(tmp_path),),
                               nprocs=WORLD, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not procs.join(timeout=5):
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise TimeoutError(f"the {WORLD} ranks ran past "
                               f"{RANKS_TIMEOUT_S} s")
    for r in range(WORLD):
        found = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert found == {"mamba2-780m": [0, 0], "hymba-1.5b": [0, 0]}, r
