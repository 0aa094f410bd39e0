"""The harness on the CPU: its data files, its readers found by name, the
result line of a dry run, and its refusal to measure without a card."""

import json
import re

import pytest
import torch

from portbench import check, run, spec
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    monkeypatch.setattr(check, "SAMPLE_SPAN", 3)
    monkeypatch.setattr(check, "SAMPLE_FRAMES", 2)
    return tiny.make_tree(tmp_path)


def test_benchmark_json_names_its_files():
    bench = spec.benchmark()
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c["config"]["name"] == w["config"]
        assert NAME.match(w["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in bench["end_to_end"]} == {"frames_per_s",
                                                        "setup_s"}


def test_every_per_layer_metric_has_its_reader():
    for m in spec.benchmark()["per_layer"]:
        r = spec.reader(m["name"])
        assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        assert callable(r.read)
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")


def test_refuses_without_a_card(no_card, capsys):
    rc = run.main(["--workload", "euroc_stereo.map", "--seed", "2147483659",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "no CUDA device" in err


def test_refuses_an_unknown_workload(capsys):
    rc = run.main(["--workload", "nope.map", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_result_line(tree, trace):
    res = run.run(["--workload", "tiny_euroc_stereo.map", "--seed",
                   "4294967311", "--seconds", "3", "--trace", str(trace)],
                  device="cpu", root=tree, log=lambda m: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[:5] == keys and list(res)[-1] == "checks"
    assert set(res) - set(keys) <= {"breakdown", "checks"}
    assert res["attempted"] > 0
    json.dumps(res)
    if trace:
        names = {m["name"] for m in spec.cell(
            "tiny_euroc_stereo.map", tree)["per_layer"]}
        assert set(res["metrics"]) <= names
        assert "track_ms" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(res["checks"]) <= {"frame_kp_mismatch", "pose_gap"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
