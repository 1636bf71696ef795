"""The readings a compared number's limit is set from, at a cell's own size.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 [--as control]

Runs the cell once per seed in one process (the program's build and the
card's set-up are paid once), each with a short window at the cell's own
load, and prints each run's compared numbers (for a metric op also the
median of the reference's values over the sampled frames).  ``--as control``
puts the plain reference in the configuration's lower precision in the
program's place (``faults.control``), ``--as unchanged|half|altered`` a
planted fault.  The benchmark's own runs never do this.  Needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--as", dest="stand_in", default=None,
                    help="control, unchanged, half or altered in the program's place")
    a = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 2
    wrap = faults.WRAPS[a.stand_in] if a.stand_in else None
    for seed in (int(s) for s in a.seeds.split(",")):
        r = harness.run_cell(ROOT, a.workload, seed, a.seconds, False, time.perf_counter(),
                             wrap=wrap)
        line = {"workload": a.workload, "as": a.stand_in or "program", "seed": seed,
                "correct": r["correct"], "attempted": r["attempted"],
                "checks": {k: v["value"] for k, v in r["checks"].items()}}
        if "sampled_value_median" in r:
            line["sampled_value_median"] = r["sampled_value_median"]
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
