"""The benchmark's data: BENCHMARK.json, its configurations and traffic mixes.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by name:
`BENCHMARK.json`'s `configs[].file`, `portbench/traffic/<traffic>.json` and
`portbench/layer_metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


class SpecError(RuntimeError):
    """BENCHMARK.json or a file it names is missing or malformed."""


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise SpecError(f"{path}: {e}") from None


def benchmark(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload `name` with its configuration, traffic mix and metrics:
    {"workload", "config", "traffic", "end_to_end", "per_layer"}."""
    bench = benchmark(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json (have "
                        f"{[w['name'] for w in bench['workloads']]})")
    conf = next((c for c in bench["configs"] if c["name"] == work["config"]),
                None)
    if conf is None:
        raise SpecError(f"workload {name!r} names no configuration of "
                        f"BENCHMARK.json ({work['config']!r})")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": work,
        "config": _read_json(root / conf["file"]),
        "traffic": _read_json(root / "portbench" / "traffic"
                              / f"{work['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(metric: str):
    """The module that reads per-layer metric `metric`
    (portbench/layer_metrics/<metric>.py, dots as underscores)."""
    mod = metric.replace(".", "_").replace("-", "_")
    if not (PKG / "layer_metrics" / f"{mod}.py").is_file():
        raise SpecError(f"no reader portbench/layer_metrics/{mod}.py for "
                        f"per-layer metric {metric!r}")
    return importlib.import_module(f"portbench.layer_metrics.{mod}")
