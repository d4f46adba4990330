"""Readings that a cell's limits are set from (portbench/README.md).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--control 1,2,3]
        [--seconds 3] [--out chiprun_out/calibrate.jsonl]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the comparison of the window's sample with the
reference (the program's readings, whose largest over a dozen seeds is a
limit's lower reading); for each ``--control`` seed besides, the
reference computed in TF32 judged in the program's place on the same sample
(the control's readings, whose smallest is the upper one). One JSON line a
seed, on standard output and appended to ``--out``. The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for a cell's limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import run as R

    bench = R.read_json(ROOT / "BENCHMARK.json")
    _, config, traffic, _ = R.cell_files(bench, args.workload)
    driver = R.load_module(R.HERE / "drivers" / f"{traffic['driver']}.py")
    controls = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = driver.Run(config, traffic, seed, args.device, False, ROOT)
        run.setup()
        setup = time.perf_counter() - t
        run.measure(args.seconds)
        run.release()
        t = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "setup_s": setup,
                "rate": run.completed / run.window_s, "failed": run.failed,
                "program": run.check(), "check_s": time.perf_counter() - t}
        if seed in controls:
            line["control"] = run.check(tf32=True)
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
