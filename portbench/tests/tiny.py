"""A tree of small cells for the CPU tests: BENCHMARK.json, configurations
and traffic mixes of the real ones at 480x360 (the rig's 0.2 m baseline of
the rows, which keeps the small images tracked), 500 features on 4 levels,
a shorter sequence at the cells' own speed."""

import json
from pathlib import Path

from portbench import spec

SIZE = dict(width=480, height=360, fx=278.0, fy=278.0, cx=240.0, cy=180.0,
            bf=55.6)


def make_tree(root: Path) -> Path:
    bench = spec.benchmark()
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir(parents=True)
    configs, workloads = [], []
    for conf in bench["configs"]:
        c = json.loads((spec.ROOT / conf["file"]).read_text())
        c["camera"].update(SIZE)
        c["orb"].update(n_features=500, n_levels=4)
        name = "tiny_" + conf["name"]
        path = f"portbench/configs/{name}.json"
        (root / path).write_text(json.dumps(c))
        configs.append(dict(conf, name=name, file=path))
    for w in bench["workloads"]:
        t = json.loads((spec.PKG / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t.pop("sample_span", None)     # the tests set the span
        # Fewer frames over a shorter arc: the cell's own speed on the circle.
        vio = t["warmup"].get("until") == "fused"
        frames = 200 if vio else 120
        t.update(laps=t["laps"] * frames / t["frames"], frames=frames,
                 profile_frames=2)
        if not vio:
            t["warmup"] = {"frames": 8}
        (root / "portbench" / "traffic" / f"tiny_{w['traffic']}.json") \
            .write_text(json.dumps(t))
        workloads.append(dict(w, name="tiny_" + w["name"],
                              config="tiny_" + w["config"],
                              traffic="tiny_" + w["traffic"]))
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_" + n for n in m["workloads"]]
    bench.update(configs=configs, workloads=workloads)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
