"""Readings of a cell's compared numbers over many seeds, in one process.

    python3 rtbench/sweep.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--control]

For setting a cell's limits (rtbench/cells/<cell>.json): each seed is a whole
run of the cell (set-up, a short window, the check), and one JSON line per
seed gives its checks and end-to-end metrics. With `--control` the reference
computed in TF32 stands in the program's place in the check, which has to
come out as not correct. A benchmark run is `rtbench/run.py`, one process
per run.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rtbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None, help="plant one of rtbench/faults.py's faults")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("rtbench: the sweep needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.run_cell(args.workload, seed, args.seconds, False, control=args.control,
                         fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": {k: c["value"] for k, c in r["checks"].items()},
                          "metrics": {k: m["value"] for k, m in r["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
