"""The benchmark of the port (``giga_tpu_torch``): one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The cell
is an entry of BENCHMARK.json's ``workloads``; its configuration, traffic,
limits and metrics are files under portbench/ found by name
(portbench/README.md). A run sets up and warms the cell's program, measures
for ``--seconds``, frees the program, checks a sample of what the window
produced against the plain reference, and prints one JSON line last on
standard output: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1`` (a torch.profiler trace of a stretch
of the window besides).

Exit codes: 0 a result printed; 2 bad arguments or files; 3 no card, or
fewer than the cell asks for; 4 the process holds JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "giga_tpu")


def load_module(path: Path):
    """A module from one of the benchmark's files, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location("portbench_" + path.stem.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str):
    """(cell entry, configuration, traffic, workload file) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[name]
    return (cell, read_json(HERE / "configs" / f"{cell['config']}.json"),
            read_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            read_json(HERE / "workloads" / f"{name}.json"))


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metric entries a cell reports: end-to-end without the trace,
    per-layer with it; an entry with ``workloads`` only in those cells."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def execute(cell: dict, config: dict, traffic: dict, workload: dict, metrics: list,
            seed: int, seconds: float, trace: bool, device, t_start: float = T_START) -> dict:
    """One run of a cell on ``device``; returns the result line's object.
    Raises RuntimeError when the process holds JAX or the JAX package once
    the window has closed."""
    import torch

    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    run = driver.Run(config, traffic, seed, device, trace, ROOT)
    run.setup()
    run.setup_s = time.perf_counter() - t_start
    run.measure(seconds)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {found} after the window")
    run.release()
    numbers = run.check()
    limits = workload["limits"]
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = (run.failed == 0 and numbers["compared"] > 0
               and all(v["value"] <= v["limit"] for v in compared.values()))
    values = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": values,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    stretch = getattr(run, "stretch", None)
    if trace and stretch is not None and stretch.t1 is not None:
        result["device"].update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        result["breakdown"] = {"device_ops": stretch.device_ops(),
                               "idle_gaps": stretch.idle_gaps()}
    result["phases"] = run.phases
    result["sample"] = {"compared": numbers["compared"],
                        **{k: v for k, v in numbers.items() if k not in limits
                           and k != "compared"}}
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = read_json(ROOT / "BENCHMARK.json")
        cell, config, traffic, workload = cell_files(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    t = time.perf_counter()
    import torch

    imported = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result = execute(cell, config, traffic, workload,
                         cell_metrics(bench, args.workload, bool(args.trace)),
                         args.seed, args.seconds, bool(args.trace), "cuda")
    except RuntimeError as e:
        if forbidden_modules():
            print(f"portbench: {e}", file=sys.stderr)
            return 4
        raise
    print(f"portbench: {args.workload} seed {args.seed}, {power_limit()}; set-up: torch import "
          f"{imported:.3f} s, " + ", ".join(f"{k} {v:.3f} s" for k, v in result.pop("phases")),
          file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"portbench: {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    sys.exit(main())
