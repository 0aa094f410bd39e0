"""The harness on the card at the tiny size: a traced run gives the result
line with the device's numbers and the profiler's breakdown."""

import json

import pytest

from portbench import check, run, spec
from portbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    monkeypatch.setattr(check, "SAMPLE_SPAN", 3)
    monkeypatch.setattr(check, "SAMPLE_FRAMES", 1)
    return tiny.make_tree(tmp_path)


@pytest.mark.cuda
def test_traced_run_on_the_card(card, tree):
    res = run.run(["--workload", "tiny_euroc_stereo.map", "--seed",
                   "6442450941", "--seconds", "5", "--trace", "1"],
                  root=tree, log=lambda m: None)
    json.dumps(res)
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert 0 < len(res["breakdown"]["device_ops"]) <= 10
    names = {m["name"] for m in spec.cell("tiny_euroc_stereo.map",
                                          tree)["per_layer"]}
    assert {"device_idle_share", "device_ops_per_frame",
            "kernels_roofline"} <= set(res["metrics"]) <= names
    assert 0 < res["metrics"]["kernels_roofline"]["value"] <= 100
