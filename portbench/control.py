"""The control of `correct`: runs of a cell with the program under TF32
that also judge the references in TF32 in its place (portbench/check.py).

    python3 -m portbench.control --workload NAME --seeds A,B,C --seconds S

One process runs the cell once for each seed (a window at the cell's own
load that passes the traffic's `sample_span`, where the samples are drawn)
and prints, for each, the TF32 program's readings and the TF32
references', each beside its limit, and the TF32 program's trajectory
against the true poses, as one JSON line.  The benchmark's own runs do not run
it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    for seed in args.seeds.split(","):
        try:
            res = run.run(["--workload", args.workload, "--seed", seed,
                           "--seconds", str(args.seconds)], control="tf32")
        except run.RunError as e:
            print(f"portbench.control: seed {seed}: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"seed": int(seed), "correct": res["correct"],
                          "program": res["checks"],
                          "control": res["control"],
                          "trajectory": res["trajectory"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
