"""The control on the card: the reference put in the program's place in
the nearest precision below the configuration's (TF32 convolutions and
matmuls for IEEE float32) fails each cell's comparison, at the cell's own
size, on three seeds; and so does each planted fault of
``port_bench.calibrate``. Needs the card (the ``cuda`` marker)."""
import pytest

from port_bench import calibrate
from port_bench.harness import check
from port_bench.harness.spec import Bench

SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flagship-train", "scpairs_reg-train"])
def test_training_control_fails(card, workload):
    bench = Bench()
    limits = bench.limits(workload)
    for seed in SEEDS:
        row = calibrate.train_readings(bench, workload, seed)
        assert check.judge(row["program"], limits)[0], row
        assert not check.judge(row["control"], limits)[0], row
        assert not check.judge(row["half_batch"], limits)[0], row


@pytest.mark.cuda
def test_serving_control_fails(card, workload="flagship-serve_peak"):
    bench = Bench()
    limits = bench.limits(workload)
    for row in calibrate.serve_readings(bench, workload, SEEDS, 1.0):
        assert check.judge(row["program"], limits)[0], row
        assert not check.judge(row["control"], limits)[0], row
        assert not check.judge(row["altered"], limits)[0], row
