"""Which collectives two ranks sharing one CUDA card can run, per backend.

``python -m mixgrpo_tpu_torch.parallel.probe`` starts two ranks on
``cuda:0`` for each backend (``nccl``, then ``gloo``), runs each collective
of ``parallel/collectives.py`` on CUDA tensors, and prints one JSON object:
per backend and operation, ``"ok"`` (the result was checked) or the error's
first line.  It only reports: ``collectives.py`` keys its transport on the
backend through a fixed table (``GLOO_CUDA_DIRECT``), never on a trial run.
A rank that does not finish within ``--timeout`` seconds is killed and
reported as ``"timeout"``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys

OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "all_to_all_single",
       "batch_isend_irecv", "barrier")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, backend: str) -> dict:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {}
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
    except Exception as e:  # a probe reports what the backend refused
        return {"init": f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"}
    out["init"] = "ok"
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.equal(y.cpu(), torch.arange(4.) * world + 10 * sum(range(world)))

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return torch.equal(y.cpu(), torch.arange(4.))

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ys, x)
        return all(torch.equal(y.cpu(), torch.arange(4.) + 10 * r) for r, y in enumerate(ys))

    def reduce_scatter():
        y = torch.empty(4 // world, device=dev)
        dist.reduce_scatter(y, list(x.chunk(world)))
        want = (torch.arange(4.) * world + 10 * sum(range(world))).chunk(world)[rank]
        return torch.equal(y.cpu(), want)

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        want = torch.cat([(torch.arange(4.) + 10 * r).chunk(world)[rank] for r in range(world)])
        return torch.equal(y.cpu(), want)

    def batch_isend_irecv():
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return torch.equal(y.cpu(), torch.arange(4.) + 10 * ((rank - 1) % world))

    def barrier():
        dist.barrier()
        return True

    for name in OPS:
        try:
            ok = locals()[name]()
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "wrong result"
        except Exception as e:  # a probe reports what the backend refused
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    dist.destroy_process_group()
    return out


def probe(backend: str, timeout: float, world: int = 2) -> dict:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "mixgrpo_tpu_torch.parallel.probe",
                               "--worker", str(r), str(world), str(port), backend],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            return {"rank_results": "timeout"}
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        results.append(json.loads(lines[-1]) if lines else {"exit": p.returncode,
                                                            "stderr": err[-600:]})
    return {"rank_results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", nargs=4, default=None, metavar=("RANK", "WORLD", "PORT",
                                                                  "BACKEND"))
    ap.add_argument("--timeout", type=float, default=150.0)
    args = ap.parse_args(argv)
    if args.worker:
        r, w, port, backend = args.worker
        print(json.dumps(_worker(int(r), int(w), int(port), backend)), flush=True)
        return 0
    print(json.dumps({b: probe(b, args.timeout) for b in ("nccl", "gloo")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
