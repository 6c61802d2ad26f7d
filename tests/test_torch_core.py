"""The port's copy of the framework-neutral core, and the port's isolation
from JAX and from the ``repro`` package."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

CORE_FILES = (
    "__init__.py", "admission.py", "chaos.py", "dag.py", "dag_gen.py",
    "identity.py", "locality.py", "places.py", "policies.py",
    "preemption.py", "ptt.py", "runtime.py", "scheduler.py",
    "serve_orchestrator.py", "shard.py", "simulator.py", "workload.py",
)
RUNTIME_FT_FILES = ("__init__.py", "elastic.py", "straggler.py")


@pytest.mark.parametrize("name", CORE_FILES)
def test_core_copy_is_byte_identical(name):
    assert (PORT / "core" / name).read_bytes() == \
        (SRC / "repro" / "core" / name).read_bytes()


def test_core_copy_holds_only_the_neutral_modules():
    assert sorted(p.name for p in (PORT / "core").glob("*.py")) == \
        sorted(CORE_FILES)


@pytest.mark.parametrize("name", RUNTIME_FT_FILES)
def test_runtime_ft_copy_is_byte_identical(name):
    assert (PORT / "runtime_ft" / name).read_bytes() == \
        (SRC / "repro" / "runtime_ft" / name).read_bytes()


def test_runtime_ft_copy_holds_only_these_modules():
    assert sorted(p.name for p in (PORT / "runtime_ft").glob("*.py")) == \
        sorted(RUNTIME_FT_FILES)


@pytest.mark.parametrize("sim_kwargs", [{}, {"n_shards": 1}],
                         ids=["unsharded", "n_shards=1"])
def test_pinned_signatures_reproduce_through_the_copy(sim_kwargs):
    from repro_torch.core import identity
    assert identity.check_pins(**sim_kwargs) == []


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import json, sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.mixed_mode\n"
        "import repro_torch.launch.zoo, repro_torch.launch.serve\n"
        "import repro_torch.launch.train, repro_torch.train_orchestrator\n"
        "import repro_torch.data, repro_torch.optimizer\n"
        "import repro_torch.checkpointing, repro_torch.configs.minicpm_2b\n"
        "import repro_torch.models.mamba2, repro_torch.models.hybrid\n"
        "import repro_torch.runtime_ft, repro_torch.parallel\n"
        "import repro_torch.parallel.collectives, repro_torch.launch.mesh\n"
        "import repro_torch.configs, repro_torch.data.pipeline\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.multi_tenant\n"
        "import repro_torch.examples.mixed_mode_dag\n"
        "import repro_torch.examples.serve_lm\n"
        "import repro_torch.examples.train_lm\n"
        "import repro_torch.launch.dryrun\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
        "print(json.dumps(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
