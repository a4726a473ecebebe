"""The harness finds every cell, configuration, traffic mix, limit and
metric by name, and a cell added as files and entries alone runs."""
import json
import os

import pytest

from port_bench.harness import serve, train
from port_bench.harness.spec import ROOT, Bench

RUNNERS = {"train": train, "serve": serve}


def test_every_named_file_loads():
    bench = Bench()
    spec = bench.spec
    assert spec["command"][:3] == ["python3", "-m", "port_bench.run"]
    for cell in spec["workloads"]:
        config = bench.config(cell["config"])
        traffic = bench.traffic(cell["traffic"])
        assert traffic["kind"] in RUNNERS
        assert bench.limits(cell["name"])
        bench.reference(config["reference"])
        e2e = bench.metrics(cell["name"], False)
        layers = bench.metrics(cell["name"], True)
        assert any(m["name"] == "setup_s" for m in e2e)
        assert len(e2e) >= 2 and layers
        for m in e2e + layers:
            assert callable(bench.reader(m["name"]).read)
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


@pytest.mark.parametrize("workload", ["flagship-train", "scpairs_reg-train",
                                      "flagship-serve_peak"])
def test_cell_runs_on_the_cpu(tiny_root, workload, float64):
    bench = Bench(tiny_root)
    cell = bench.cell(workload)
    runner = RUNNERS[bench.traffic(cell["traffic"])["kind"]]
    fields, ctx, numbers = runner.run(bench, cell, 2 ** 31 + 17, 0.2,
                                      False, device="cpu", workers=1)
    assert fields["attempted"] > 0
    from port_bench.harness import check
    correct, checks = check.judge(numbers, bench.limits(workload))
    assert correct, checks
    for m in bench.metrics(workload, False):
        assert bench.reader(m["name"]).read(ctx) > 0


def test_a_cell_added_as_files_runs(tiny_root, float64):
    """A new configuration, traffic mix, limits and metric, each a file,
    and their entries in BENCHMARK.json: the harness runs the new cell
    and reports the new metric, with no code changed."""
    d = os.path.join(tiny_root, "port_bench")
    with open(os.path.join(d, "configs", "flagship.json")) as f:
        cfg = json.load(f)
    cfg["model"]["rep_copies"] = 3
    with open(os.path.join(d, "configs", "wide.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(d, "traffic", "train.json")) as f:
        traffic = json.load(f)
    traffic["images_per_step"] = 4
    with open(os.path.join(d, "traffic", "small_train.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(d, "limits", "wide-small.json"), "w") as f:
        json.dump({"loss1_gap": 1e-8, "loss2_gap": 1e-8, "loss3_gap": 1e-8,
                   "grad_gap": 1e-6, "change_gap": 1e-6}, f)
    with open(os.path.join(d, "metrics", "steps_per_s.wide.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.steps / ctx.window_s\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "wide", "source": "test",
                            "file": "port_bench/configs/wide.json",
                            "reduced": ["rep_copies"], "why": "test"})
    spec["workloads"].append({"name": "wide-small", "config": "wide",
                              "traffic": "small_train", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "steps_per_s.wide", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves":
                              "train_images_per_s",
                              "workloads": ["wide-small"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    bench = Bench(tiny_root)
    cell = bench.cell("wide-small")
    fields, ctx, numbers = train.run(bench, cell, 5, 0.2, False,
                                     device="cpu", workers=1)
    from port_bench.harness import check
    assert check.judge(numbers, bench.limits("wide-small"))[0]
    names = [m["name"] for m in bench.metrics("wide-small", True)]
    # the per-layer metrics that list their cells report in those alone
    assert names == ["steps_per_s.wide"]
    assert bench.reader("steps_per_s.wide").read(ctx) > 0
    assert ctx.images == ctx.steps * 4
