"""The benchmark as data: ``BENCHMARK.json`` at the root of a checkout, and
the files it names under the benchmark's directory, found by name:

- ``configs``' ``file`` (one JSON object a configuration);
- ``<dir>/traffic/<traffic>.json``, a traffic mix's parameters, read by
  the runner that its ``kind`` names (``harness/train.py``,
  ``harness/serve.py``);
- ``<dir>/limits/<workload>.json``, the limits of a cell's comparison;
- ``<dir>/metrics/<metric>.py``, the reader of one metric (a function
  ``read(ctx)`` returning a number, or None when the run has nothing for
  it to read);
- ``<dir>/reference/<reference>.py``, the plain reference a configuration
  names.

A cell, a configuration, a traffic mix or a metric is added by adding
files and entries; nothing here changes.
"""
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = root
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, self.spec["paths"][0])
        self._readers = {}

    def _named(self, key, name):
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r}; there are "
                       f"{[e['name'] for e in self.spec[key]]}")

    def cell(self, workload):
        return self._named("workloads", workload)

    def config(self, name):
        entry = self._named("configs", name)
        return dict(_load_json(os.path.join(self.root, entry["file"])),
                    name=name)

    def traffic(self, name):
        return dict(_load_json(os.path.join(self.dir, "traffic",
                                            name + ".json")), name=name)

    def limits(self, workload):
        return _load_json(os.path.join(self.dir, "limits",
                                       workload + ".json"))

    def reference(self, name):
        return _load_module(os.path.join(self.dir, "reference", name + ".py"),
                            f"_bench_reference_{name}")

    def reader(self, metric):
        if metric not in self._readers:
            self._readers[metric] = _load_module(
                os.path.join(self.dir, "metrics", metric + ".py"),
                "_bench_metric_" + metric.replace(".", "_").replace("-", "_"))
        return self._readers[metric]

    def metrics(self, workload, trace):
        """The metric entries a run of ``workload`` reports: its end-to-end
        metrics (``trace`` false) or its per-layer ones. An entry with
        ``workloads`` is reported in those cells; an end-to-end one without
        it in every cell, a per-layer one without it in every cell that
        reports the end-to-end metric it ``moves``."""
        def has(entry):
            return "workloads" not in entry or workload in entry["workloads"]

        e2e = [m for m in self.spec["end_to_end"] if has(m)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
