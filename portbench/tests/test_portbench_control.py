"""The lower-precision control on the card: the reference computed with
TF32 on, judged in the program's place on a short window's sample at the
cell's own size, fails one of the cell's numbers, while the program's own
sample passes them all. Needs the card; skips without one."""

import pytest
import torch

from portbench.tests.small import BENCH, ROOT, harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_tf32_control_fails_and_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _, config, traffic, workload = harness.cell_files(BENCH, name)
    driver = harness.load_module(harness.HERE / "drivers" / f"{traffic['driver']}.py")
    limits = workload["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        run = driver.Run(config, traffic, seed, "cuda", False, ROOT)
        run.setup()
        run.measure(2.0)
        run.release()
        program, control = run.check(), run.check(tf32=True)
        assert program["compared"] > 0 and run.failed == 0
        assert all(program[k] <= v for k, v in limits.items()), program
        assert any(control[k] > v for k, v in limits.items()), control
