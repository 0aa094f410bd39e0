"""Importing and dry-running the harness loads neither JAX nor the JAX
package: top-level module names compared whole (the port's name begins
with the JAX package's)."""

import subprocess
import sys

from portbench import spec

SCRIPT = r"""
import sys, json, tempfile, pathlib
from portbench import check, run
from portbench.tests import tiny
check.SAMPLE_SPAN, check.SAMPLE_FRAMES = 3, 1
root = tiny.make_tree(pathlib.Path(tempfile.mkdtemp()))
run.run(["--workload", "tiny_euroc_stereo.map", "--seed", "7",
         "--seconds", "1", "--trace", "1"], device="cpu", root=root,
        log=lambda m: None)
print(json.dumps(run.forbidden_modules()))
"""


def test_dry_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "vieo_slam_tpu_torch_x", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "vieo_slam_tpu.sim", sys)
    assert set(run.forbidden_modules()) == before | {"vieo_slam_tpu"}
