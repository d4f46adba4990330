"""A cell at a size a CPU test run can hold: the cell's own files and
lattices, with fewer robots and scenes, smaller batches and, for meshes, a
coarser generation lattice."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as harness  # noqa: E402

BENCH = harness.read_json(ROOT / "BENCHMARK.json")
PLAN, RECON, FLEET = "giga.plan_b64", "giga_geo.recon_b8", "giga.fleet_b64"
# the PlannerService fleet, kept for a later cell (PERF.md, Open questions)
FLEET_CELL = {"name": FLEET, "config": "giga", "traffic": "fleet_b64", "chips": 1}


def small_cell(name: str):
    """(cell, config, traffic, workload) of a cell, cut for the CPU."""
    bench = BENCH if name != FLEET else dict(BENCH, workloads=[FLEET_CELL])
    cell, config, traffic, workload = harness.cell_files(bench, name)
    if traffic["driver"] == "fleet":
        traffic.update(robots=4, pool=4, batch_size=2, warmup_requests=4, sample=3)
    elif traffic["driver"] == "plan":
        traffic.update(pool=4, batch_size=2, warmup_batches=1, sample=3)
    else:
        traffic.update(pool=4, batch_size=2, warmup_batches=1, sample=2)
        config["generator"].update(resolution0=8, upsampling_steps=1)
    return cell, config, traffic, workload


def run_small(name: str, seed: int = 2 ** 31 + 7, seconds: float = 4.0, trace: bool = False):
    """One run of the cut cell on the CPU, through the harness."""
    cell, config, traffic, workload = small_cell(name)
    metrics = harness.cell_metrics(BENCH, name, trace) if name != FLEET else []
    return harness.execute(cell, config, traffic, workload, metrics, seed, seconds, trace, "cpu")
