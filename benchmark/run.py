"""The benchmark of the PyTorch port (``mixgrpo_tpu_torch``) on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It finds the cell by name (``BENCHMARK.json``
and the files under ``benchmark/``, see ``benchmark/README.md``), makes
every input from ``--seed``, sets the program up (weights, warm-up: the
cell's first unit of work, which the correctness check follows), then runs
whole units for ``--seconds`` and reports the cell's end-to-end metrics.
With ``--trace 1`` one more unit after the window runs under
``torch.profiler`` and the line reports the per-layer metrics instead.
Once the window has closed and the program's state is freed, the plain
references under ``benchmark/reference/`` check what the program produced.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the last lines of standard error repeat the checks.  Without enough CUDA
cards, or with JAX or the JAX package loaded, it exits non-zero and prints
no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from benchlib.discover import Cell  # noqa: E402
from benchlib.isolation import forbidden_modules  # noqa: E402
from benchlib.peaks import peaks_for  # noqa: E402
from benchlib.window import end_to_end_value, run_window  # noqa: E402

# the program's kernel cache, at a fixed path inside the checkout (its CUDA
# libraries build into mixgrpo_tpu_torch/csrc/build/ of the checkout itself)
CACHES = {"TRITON_CACHE_DIR": "triton"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def traced_unit(run, tmpdir):
    """One more unit under ``torch.profiler``: its trace summary (the trace
    file is deleted once read) and the attention kernels' launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchlib.trace import summarize
    from mixgrpo_tpu_torch.ops import flash_attention as FA

    FA.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run.run_unit()
        torch.cuda.synchronize()
    launches = {k: f.launches for k, f in FA.KERNEL_WRAPPERS.items()}
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        return summarize(path), launches
    finally:
        os.unlink(path)


def measure(cell, seed: int, seconds: float, trace: bool, device, faults=()):
    """Set up, run the window (and with ``trace`` one traced unit), free the
    program's state and check its outputs; returns the result line.
    ``faults`` are the kind's planted faults, for the fault tests."""
    import torch

    on_card = device.type == "cuda"
    kind_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    run = cell.kind.Run(cell, seed, device, faults)
    run.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0
    units, elapsed = run_window(run.run_unit, seconds)
    metric = cell.cell["metric"]
    value = end_to_end_value(metric["form"], units, elapsed)
    summary = launches = None
    if trace:
        with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
            summary, launches = traced_unit(run, tmp)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    info = {"card": card_line() if on_card else "cpu", "setup_s": setup_s, "window_s": elapsed,
            "unit_s": [u["seconds"] for u in units], "memory_peak_bytes": peak,
            "launches_traced_unit": launches}
    print(json.dumps({"info": info}), flush=True)
    ctx = {"units": units, "elapsed": elapsed, "trace": summary, "launches": launches,
           "attention_calls": run.attention_calls(), "unit_flops": run.model_flops(),
           "peaks": peaks_for(kind_name) if on_card else None, "chips": cell.chips}
    run.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = run.check()
    print(json.dumps({"info": {"check_s": time.perf_counter() - t_check}}), flush=True)
    limits = cell.cell["limits"]
    failed = sum(u["failed"] for u in units)
    correct = failed == 0 and all(k in limits and v <= limits[k] for k, v in numbers.items())
    if trace:
        values = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        got = {"setup_s": setup_s, metric["name"]: value}
        values = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
                  for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind_name, "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": sum(u["work"] for u in units), "failed": failed,
              "metrics": values, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    import torch

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"refusing to report: loaded {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
