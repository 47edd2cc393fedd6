"""``BENCHMARK.json`` against the limits its format sets, so that a file
that would be refused before any run fails here first."""

import json
import os
import re
import statistics

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(s["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                              for p in s["paths"])
    assert len(s["command"]) <= 32 and all(line(w) for w in s["command"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_configs_and_cells():
    s = spec()
    used = {w["config"] for w in s["workloads"]}
    files = set()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["why"]) and line(c["source"])
        assert c["file"].startswith(s["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:  # depth cuts, each with its published value beside it
            assert NAME.match(k) and k in cfg and k in cfg["published"]
            assert not re.search(r"(_dim|_rank|size|width|ratio|heads)", k)
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and line(w["why"])
        assert w["chips"] in (1, 4) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "cells", w["name"] + ".json"))
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(1, len(s["workloads"]) // 4)


def test_metrics():
    s = spec()
    cells = {w["name"] for w in s["workloads"]}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") or "_roofline." in m["name"]
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:  # setup_s, one more end-to-end metric and a per-layer one each
        mine = [m for m in s["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w in m["workloads"] for m in s["per_layer"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = spec()
    assert (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_limits_are_set():
    for w in spec()["workloads"]:
        with open(os.path.join(BENCH, "cells", w["name"] + ".json")) as f:
            limits = json.load(f)["limits"]
        assert limits and all(isinstance(v, float) and v >= 0 for v in limits.values())
        assert statistics.fmean(limits.values()) < 1.0
