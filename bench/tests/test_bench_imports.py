"""A run loads no module of JAX or of the JAX package (top-level names
compared whole: ``repro_torch`` is the port), and the references load
nothing of the program."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from bench.harness import main as M

RUN_BOTH = """
import json, sys, runpy
sys.argv = ["bench/run.py", "--workload", "dag-d8.06", "--seed", "1",
            "--seconds", "1"]
from bench.tests import tiny
from bench.harness import main as M
tiny.run("dag-d8.06", seconds=0.3, trace=True)
runpy.run_path("bench/run.py", run_name="not_main")
import bench.tools
print(json.dumps(M.forbidden_modules()))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCES = """
import json, sys
import bench.reference.dag_ops
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _run(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(M.ROOT / "src"), str(M.ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=M.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines()[-2:]]


def test_a_run_loads_no_jax():
    forbidden, tops = _run(RUN_BOTH)
    assert forbidden == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)
    assert "repro_torch" in tops     # the port itself did load


def test_the_references_load_nothing_of_the_program():
    (tops,) = _run(REFERENCES)[-1:]
    assert not {"repro_torch", "repro", "jax", "jaxlib"} & set(tops)


def test_forbidden_names_are_whole():
    sys.modules.setdefault("repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in M.forbidden_modules()
