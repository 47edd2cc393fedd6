"""A cell, a configuration, a traffic mix and a metric are added as files
and ``BENCHMARK.json`` entries, with no edit to code."""

import json
import os

import conftest
from benchlib.discover import Cell


def test_throwaway_files_are_found_by_name(bench_copy):
    conftest.write_tiny(bench_copy, {"start": 0.0})
    with open(os.path.join(bench_copy, "metrics", "throwaway.tiny.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0 if ctx.get('units') else None\n")
    root = os.path.dirname(bench_copy)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["per_layer"].append({"name": "throwaway.tiny", "unit": "s", "better": "lower",
                              "source": "program_span", "layer": "rollout",
                              "moves": "grpo_samples_per_s", "workloads": ["tiny.grpo"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell = Cell("tiny.grpo", bench_dir=bench_copy)
    assert cell.config["num_layers"] == 1 and cell.traffic["resolution"] == 64
    assert cell.kind.__name__ == "bench_kind_grpo" and hasattr(cell.kind, "Run")
    assert {m["name"] for m in cell.end_to_end} == {"grpo_samples_per_s", "setup_s"}
    names = [m["name"] for m in cell.per_layer]
    assert "throwaway.tiny" in names and "rollout_s.train" in names
    assert not any(n.endswith(".video") for n in names)
    assert cell.reader("throwaway.tiny")({"units": [1]}) == 42.0
    assert cell.reader("throwaway.tiny")({"units": []}) is None


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    cells = [w["name"] for w in json.load(open(os.path.join(conftest.ROOT, "BENCHMARK.json")))[
        "workloads"]]
    for name in cells:
        cell = Cell(name)
        assert cell.per_layer and any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.cell["metric"]["name"] in {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
