"""Batched FLUX inference server.

Port of mixgrpo_tpu/serve.py:

- ``RequestBatcher``: a queue + one device-worker thread that groups incoming
  requests into micro-batches of the configured batch size (padding the
  tail by repeating the last row), with the optional LATENCY TIER
  (``generate_fn_single``): a request that arrives alone runs at batch 1
  instead of paying padded rows.
- ``ContinuousEngine`` + ``ContinuousBatcher``: continuous batching.  A
  resident slot batch advances up to ``max_steps_per_call`` ODE steps per
  device call, each row at its own step of the sigma table, so a request
  joins at the next chunk boundary instead of waiting out a whole batch; a
  mixed pipeline runs two slot pools (tuned, then base) and moves a row
  between them at ``mix_sampling_steps``.  Same client API, with the
  latency tier (``single_fn``) behind a 0.25 s co-arrival grace.
- ``InferenceServer``: stdlib ThreadingHTTPServer.  ``POST /generate`` with
  ``{"prompt": str, "seed": int?}`` returns the PNG (or base64 JSON with
  ``"format": "json"``); ``GET /healthz``; ``GET /stats``.
- ``make_generate_fn``: the standard generate function over a
  ``DualFluxPipeline`` and an ``encode_fn(prompts) -> (txt, pooled)``.
- ``build_server``/``main``: the CLI over a FLUX directory in the HF layout
  (weights on ``--device``: bf16 on a card, f32 on the CPU; prompts through
  ``preprocess.build_prompt_encoder_from_dir``; ``--quant int8`` quantises
  the block matmuls, ``--continuous`` serves through ``ContinuousBatcher``);
  ``build_server`` returns the unstarted ``InferenceServer`` so callers can
  drive it.

The HTTP threads only enqueue, so the device sees one worker's calls in
order.  A request's initial noise is drawn from
``torch.Generator(device).manual_seed(seed)`` by either batcher, so a
(prompt, seed) gives the same image through both.

Run: ``python -m mixgrpo_tpu_torch.serve --model_path FLUX.1-dev``.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mixgrpo_tpu_torch.sampler import make_model_fn


@dataclass
class _Request:
    prompt: str
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    image: Optional[np.ndarray] = None
    error: Optional[str] = None
    ts: float = field(default_factory=time.time)  # enqueue time


def _submit(q: "queue.Queue[_Request]", prompt: str, seed: int, timeout: float) -> np.ndarray:
    """Enqueue one request for a batcher's worker and wait for its image."""
    req = _Request(prompt=prompt, seed=seed)
    q.put(req)
    if not req.done.wait(timeout):
        raise TimeoutError("generation timed out")
    if req.error is not None:
        raise RuntimeError(req.error)
    return req.image


class RequestBatcher:
    """Groups requests into fixed-size micro-batches for one device worker.

    ``generate_fn(prompts, seeds) -> images01 (B, H, W, 3)`` is called with
    exactly ``batch_size`` rows (tail requests are padded by repeating the
    last row; padded outputs are dropped).  ``max_wait_ms`` bounds the
    latency a lone request pays waiting for co-batching.
    """

    def __init__(
        self,
        generate_fn: Callable[[Sequence[str], Sequence[int]], np.ndarray],
        batch_size: int = 4,
        max_wait_ms: float = 50.0,
        generate_fn_single: Optional[
            Callable[[Sequence[str], Sequence[int]], np.ndarray]
        ] = None,
    ):
        """``generate_fn_single``, when given, is the LATENCY TIER: a request
        that arrives alone (queue empty after ``max_wait_ms``) runs through it
        at batch 1 instead of paying ``batch_size - 1`` padded rows; under
        load, co-batches still run at ``batch_size``."""
        self.generate_fn = generate_fn
        self.generate_fn_single = generate_fn_single
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1e3
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                      "errors": 0, "single_dispatches": 0}
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, prompt: str, seed: int, timeout: float = 600.0) -> np.ndarray:
        return _submit(self.queue, prompt, seed, timeout)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        # release any waiters still queued
        while True:
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                break
            req.error = "server shutting down"
            req.done.set()

    # -- worker ----------------------------------------------------------
    def _take_batch(self):
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._take_batch()
            if not batch:
                continue
            n = len(batch)
            use_single = n == 1 and self.generate_fn_single is not None
            pad = 0 if use_single else self.batch_size - n
            prompts = [r.prompt for r in batch] + [batch[-1].prompt] * pad
            seeds = [r.seed for r in batch] + [batch[-1].seed] * pad
            fn = self.generate_fn_single if use_single else self.generate_fn
            try:
                images = np.asarray(fn(prompts, seeds))
                for i, r in enumerate(batch):
                    r.image = images[i]
                if use_single:
                    self.stats["single_dispatches"] += 1
            except Exception as e:  # surface to all waiters, keep serving
                self.stats["errors"] += 1
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["padded_rows"] += pad
            for r in batch:
                r.done.set()


class ContinuousEngine:
    """Device side of continuous batching: one call advances every slot row
    by up to ``chunk`` ODE steps, where each row carries its own step offset
    into the pipeline's (T+1,) sigma table.  Rows with ``offset + i >=
    t_end`` pass through frozen: the forward still computes them (as JAX's
    fixed-shape program does) and ``torch.where`` keeps their latents.  The
    step is the flow-matching Euler step of the inference pipeline (eta =
    0): ``z' = z + (sigma_prev - sigma) * v`` in f32, the DiT fed each row's
    quantised timestep by ``make_model_fn``."""

    def __init__(self, pipeline):
        sampler = pipeline._seg1 or pipeline._seg2
        self._sampler = sampler
        self.T = pipeline.num_steps
        self.chunk = pipeline._chunk or pipeline.num_steps
        self.sigmas = torch.as_tensor(np.asarray(pipeline.sigmas, np.float32),
                                      device=pipeline.device)  # (T+1,)

    @torch.no_grad()
    def run(self, params, z, txt, pooled, offsets, t_end: int):
        s = self._sampler
        model_fn = make_model_fn(params, s.flux_cfg, txt, pooled, s.guidance_scale,
                                 s.rope_cos, s.rope_sin, dtype=s.dtype, attn_impl=s.attn_impl,
                                 virtual_depth=s.virtual_depth)
        off = torch.as_tensor(np.asarray(offsets, np.int64), device=z.device)
        z = z.float()
        for i in range(self.chunk):
            idx = (off + i).clamp(0, self.T - 1)
            sigma, sigma_prev = self.sigmas[idx], self.sigmas[idx + 1]  # (B,) per row
            pred = model_fn(z, sigma).float()
            live = (off + i) < t_end
            z = torch.where(live[:, None, None], z + (sigma_prev - sigma)[:, None, None] * pred, z)
        return z


@dataclass
class _Pool:
    """One resident slot batch bound to one weight set + step range."""

    params: object
    t_start: int
    t_end: int
    z: object = None  # (B, S, C) device latents, f32
    txt: object = None
    pooled: object = None
    offsets: np.ndarray = None  # (B,) host copy; a row is free iff its req is None
    reqs: list = None


class ContinuousBatcher:
    """Chunk-boundary admission serving (continuous batching).

    API-compatible with :class:`RequestBatcher` (``submit``/``stats``/
    ``close``).  Requests join the resident batch at the next chunk
    boundary.  A mixed pipeline (tuned segment [0, mix_k), base [mix_k, T))
    runs two slot pools, one per weight set; a row migrates to the next pool
    when it reaches its pool's ``t_end`` (rows freeze there, so the chunk
    need not divide the segments).  Each scheduling round every populated
    pool makes one engine call, so every row still costs T forward steps;
    only admission latency changes.  A single-model pipeline has one pool.
    Row moves are one indexed copy per array per admission or migration,
    not one per row.  Finished rows are decoded at batch 1 by the
    pipeline's decoder.
    """

    def __init__(self, pipeline, encode_fn, batch_size: int = 4,
                 single_fn=None, single_grace_s: float = 0.25):
        """``single_fn(prompts, seeds) -> images`` is the optional LATENCY
        TIER (``RequestBatcher``'s contract): when every slot is idle and
        exactly one request waits, it runs through the one-shot batch-1
        function instead of the full-B chunk engine.  ``single_grace_s`` is
        the co-arrival window a lone request waits first: the tier runs in
        the worker, so a burst's first arrival must not capture it."""
        self.engine = ContinuousEngine(pipeline)
        self.pipe = pipeline
        self.encode_fn = encode_fn
        self.batch_size = batch_size
        self.single_fn = single_fn
        self.single_grace_s = single_grace_s
        self._sampler = pipeline._seg1 or pipeline._seg2

        T, k = pipeline.num_steps, pipeline.mix_k
        segs = []
        if k > 0:
            segs.append((pipeline.tuned_params, 0, k))
        if T - k > 0:
            segs.append((pipeline.base_params, k, T))
        self.pools = [self._make_pool(p, a, b) for p, a, b in segs]

        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: list = []  # worker-local FIFO head
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "rounds": 0, "mid_flight_admissions": 0,
                      "migrations": 0, "single_dispatches": 0}
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _make_pool(self, params, t_start, t_end) -> _Pool:
        B, s, cfg, dev = self.batch_size, self._sampler, self.pipe.flux_cfg, self.pipe.device
        S = s.num_image_tokens
        L = s.rope_cos.shape[0] - S  # the pipeline's text length
        dt = self.pipe.dtype
        return _Pool(
            params=params, t_start=t_start, t_end=t_end,
            z=torch.zeros((B, S, cfg.in_channels), dtype=torch.float32, device=dev),
            txt=torch.zeros((B, L, cfg.context_dim), dtype=dt, device=dev),
            pooled=torch.zeros((B, cfg.pooled_dim), dtype=dt, device=dev),
            offsets=np.full(B, t_end, np.int64), reqs=[None] * B,
        )

    # -- client API -------------------------------------------------------
    def submit(self, prompt: str, seed: int, timeout: float = 600.0) -> np.ndarray:
        return _submit(self.queue, prompt, seed, timeout)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=10)
        waiting = list(self._pending) + [r for p in self.pools for r in p.reqs if r is not None]
        while True:
            try:
                waiting.append(self.queue.get_nowait())
            except queue.Empty:
                break
        for r in waiting:
            if not r.done.is_set():
                r.error = "server shutting down"
                r.done.set()

    # -- worker -----------------------------------------------------------
    def _admit(self):
        """Fill free entry-pool slots from the queue (chunk boundary)."""
        pool, dev = self.pools[0], self.pipe.device
        free = [i for i, r in enumerate(pool.reqs) if r is None]
        mid_flight = self._any_active()
        newly = []
        while free and self._pending:
            newly.append((free.pop(0), self._pending.pop(0)))
        if not newly:
            return
        try:
            txt, pooled = self.encode_fn([r.prompt for _, r in newly])
        except Exception as e:  # fail these requests, keep serving
            for _, r in newly:
                r.error = f"{type(e).__name__}: {e}"
                r.done.set()
            self.stats["errors"] += 1
            return
        slots = torch.as_tensor([s for s, _ in newly], device=dev)
        z0 = torch.cat([self._sampler.init_noise(torch.Generator(dev).manual_seed(int(r.seed)), 1)
                        for _, r in newly])
        pool.z[slots] = z0.float()
        pool.txt[slots] = torch.as_tensor(txt, device=dev).to(self.pipe.dtype)
        pool.pooled[slots] = torch.as_tensor(pooled, device=dev).to(self.pipe.dtype)
        for slot, req in newly:
            pool.offsets[slot] = pool.t_start
            pool.reqs[slot] = req
            if mid_flight:
                self.stats["mid_flight_admissions"] += 1

    def _harvest(self):
        """Move boundary rows to the next pool; deliver finished rows.  Pools
        are walked last to first, so a row can migrate into a slot freed by a
        delivery in the same pass."""
        dev = self.pipe.device
        for pi in reversed(range(len(self.pools))):
            pool = self.pools[pi]
            nxt = self.pools[pi + 1] if pi + 1 < len(self.pools) else None
            ready = [i for i, r in enumerate(pool.reqs)
                     if r is not None and pool.offsets[i] >= pool.t_end]
            if not ready:
                continue
            if nxt is not None:
                free = [j for j, r in enumerate(nxt.reqs) if r is None]
                moves = list(zip(ready, free))  # next pool full: the rest wait
                if not moves:
                    continue
                src = torch.as_tensor([i for i, _ in moves], device=dev)
                dst = torch.as_tensor([j for _, j in moves], device=dev)
                nxt.z[dst] = pool.z[src]
                nxt.txt[dst] = pool.txt[src]
                nxt.pooled[dst] = pool.pooled[src]
                for i, j in moves:
                    nxt.offsets[j] = nxt.t_start
                    nxt.reqs[j], pool.reqs[i] = pool.reqs[i], None
                    pool.offsets[i] = pool.t_end
                self.stats["migrations"] += len(moves)
            else:
                try:
                    images = self._finish_rows(pool.z[torch.as_tensor(ready, device=dev)])
                    for n, i in enumerate(ready):
                        pool.reqs[i].image = images[n]
                except Exception as e:  # fail these requests, keep serving
                    for i in ready:
                        pool.reqs[i].error = f"{type(e).__name__}: {e}"
                    self.stats["errors"] += 1
                for i in ready:
                    self.stats["requests"] += 1
                    pool.reqs[i].done.set()
                    pool.reqs[i] = None
                    pool.offsets[i] = pool.t_end

    @torch.no_grad()
    def _finish_rows(self, z_rows) -> np.ndarray:
        """(n, S, C) latent rows -> (n, ...) host images (or latents without
        a VAE), decoded one row at a time, fetched to the host once."""
        if self.pipe.vae_params is None:
            return z_rows.float().cpu().numpy()
        rows = [self.pipe._decode(z_rows[i : i + 1])[0] for i in range(z_rows.shape[0])]
        return torch.stack(rows).float().cpu().numpy()

    def _any_active(self) -> bool:
        return any(r is not None for p in self.pools for r in p.reqs)

    def _try_single(self) -> bool:
        """Latency tier: an idle system and exactly one waiting request runs
        it through ``single_fn``, after the request has waited out
        ``single_grace_s`` for company (blocking on the queue: the system is
        idle)."""
        if (self.single_fn is None or self._any_active()
                or len(self._pending) != 1 or not self.queue.empty()):
            return False
        remaining = self.single_grace_s - (time.time() - self._pending[0].ts)
        if remaining > 0:
            try:
                self._pending.append(self.queue.get(timeout=remaining))
                return False  # company arrived: co-batch through the pools
            except queue.Empty:
                pass
            if self._stop.is_set():
                return False
        req = self._pending.pop(0)
        try:
            req.image = np.asarray(self.single_fn([req.prompt], [req.seed]))[0]
            self.stats["single_dispatches"] += 1
        except Exception as e:  # fail this request, keep serving
            req.error = f"{type(e).__name__}: {e}"
            self.stats["errors"] += 1
        self.stats["requests"] += 1
        req.done.set()
        return True

    def _drain_queue(self):
        while True:
            try:
                self._pending.append(self.queue.get_nowait())
            except queue.Empty:
                return

    def _run(self):
        while not self._stop.is_set():
            self._drain_queue()
            if self._try_single():
                continue
            self._admit()
            progressed = False
            for pool in self.pools:
                active = [i for i, r in enumerate(pool.reqs)
                          if r is not None and pool.offsets[i] < pool.t_end]
                if not active:
                    continue
                try:
                    pool.z = self.engine.run(pool.params, pool.z, pool.txt, pool.pooled,
                                             pool.offsets, pool.t_end)
                    self.stats["batches"] += 1
                except Exception as e:  # fail this pool's riders, keep serving
                    self.stats["errors"] += 1
                    for i in active:
                        pool.reqs[i].error = f"{type(e).__name__}: {e}"
                        pool.reqs[i].done.set()
                        pool.reqs[i] = None
                    pool.offsets[:] = pool.t_end
                    continue
                pool.offsets[active] = np.minimum(pool.offsets[active] + self.engine.chunk,
                                                  pool.t_end)
                progressed = True
            if progressed:
                self.stats["rounds"] += 1
                self._harvest()
            else:
                try:  # idle: block until a request arrives, keep FIFO order
                    self._pending.append(self.queue.get(timeout=0.1))
                except queue.Empty:
                    pass


def _png_bytes(image01: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(
        (np.clip(image01, 0, 1) * 255).astype(np.uint8)
    ).save(buf, format="PNG")
    return buf.getvalue()


def make_handler(batcher: RequestBatcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(batcher.stats).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                prompt = payload["prompt"]
                if not isinstance(prompt, str):
                    raise TypeError("prompt must be a string")
                seed = int(payload.get("seed", 0))
            except Exception as e:
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            try:
                image = batcher.submit(prompt, seed)
            except Exception as e:
                self._send(500, str(e).encode(), "text/plain")
                return
            png = _png_bytes(image)
            if payload.get("format") == "json":
                body = json.dumps(
                    {"prompt": prompt, "seed": seed,
                     "png_base64": base64.b64encode(png).decode()}
                ).encode()
                self._send(200, body, "application/json")
            else:
                self._send(200, png, "image/png")

    return Handler


class InferenceServer:
    """HTTP wrapper around a RequestBatcher; ``with``-friendly."""

    def __init__(self, batcher: RequestBatcher, host: str = "0.0.0.0",
                 port: int = 8000):
        self.batcher = batcher
        self.httpd = ThreadingHTTPServer((host, port), make_handler(batcher))
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def make_generate_fn(pipeline, encode_fn):
    """Standard generate_fn for the batcher.

    ``pipeline``: DualFluxPipeline.  ``encode_fn(prompts) -> (txt, pooled)``,
    arrays or tensors (``preprocess.PromptEncoder``, or a stand-in).  Each
    request's seed drives its own initial-noise row through
    ``torch.Generator(device).manual_seed(seed)`` (stacked into the batch as
    ``z0``), so an identical (prompt, seed) reproduces whatever its
    neighbours in the batch are.
    """
    sampler = pipeline._seg1 or pipeline._seg2
    dev = pipeline.device

    def generate(prompts, seeds):
        txt, pooled = encode_fn(list(prompts))
        z0 = torch.cat([
            sampler.init_noise(torch.Generator(dev).manual_seed(int(s)), 1)
            for s in seeds
        ])
        images = pipeline(
            torch.as_tensor(txt, device=dev).to(pipeline.dtype),
            torch.as_tensor(pooled, device=dev).to(pipeline.dtype),
            z0=z0,
        )
        return images.float().cpu().numpy()

    return generate


def arg_parser():
    import argparse

    p = argparse.ArgumentParser(description="Batched FLUX inference server")
    p.add_argument("--model_path", required=True,
                   help="FLUX dir (transformer/ vae/ text encoders)")
    p.add_argument("--tuned_path", default=None,
                   help="fine-tuned transformer safetensors (optional)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_wait_ms", type=float, default=50.0)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--mix_sampling_steps", type=int, default=30)
    p.add_argument("--quant", default="none", choices=["none", "int8"])
    p.add_argument("--vae_tiling", default="auto", choices=["auto", "on", "off"],
                   help="tiled VAE decode (auto: on above 768px)")
    p.add_argument("--max_steps_per_call", type=int, default=None,
                   help="bound one device call to N sampling steps (chunked segments)")
    p.add_argument("--latency_tier", action=argparse.BooleanOptionalAction, default=True,
                   help="lone requests run at batch 1 instead of a padded batch")
    p.add_argument("--continuous", action=argparse.BooleanOptionalAction, default=False,
                   help="continuous batching: requests join the resident batch at "
                        "max_steps_per_call chunk boundaries (per-row step offsets) instead "
                        "of waiting out whole batches")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (bf16) or cpu (f32)")
    return p


def build_server(args, family=None) -> InferenceServer:
    """Everything ``main`` does before it serves: the weights, the prompt
    encoder, the pipeline and the batcher; returns the unstarted server.
    ``family`` defaults to ``presets.flux_family()``."""
    import os

    from mixgrpo_tpu_torch.models.flux.load import load_flux_params, load_vae_decoder_params
    from mixgrpo_tpu_torch.preprocess import build_prompt_encoder_from_dir, compute_dtype
    from mixgrpo_tpu_torch.presets import flux_family
    from mixgrpo_tpu_torch.sample import DualFluxPipeline

    fam = family or flux_family()
    kw = dict(dtype=compute_dtype(args.device), device=torch.device(args.device))
    flux_cfg, vae_cfg = fam["flux"], fam["vae"]
    vae = load_vae_decoder_params(os.path.join(args.model_path, "vae"), vae_cfg, **kw)
    # the trees go straight to the pipeline, so that under --quant int8 only
    # their quantised copies stay alive
    pipe = DualFluxPipeline(
        flux_cfg, load_flux_params(os.path.join(args.model_path, "transformer"), flux_cfg, **kw),
        load_flux_params(args.tuned_path, flux_cfg, **kw) if args.tuned_path else None,
        vae_cfg=vae_cfg, vae_params=vae, height=args.height, width=args.width,
        num_steps=args.num_steps, mix_sampling_steps=args.mix_sampling_steps,
        dtype=kw["dtype"], quant=args.quant, vae_tiling=args.vae_tiling,
        max_steps_per_call=args.max_steps_per_call, device=kw["device"])
    encoder = build_prompt_encoder_from_dir(args.model_path, family=fam, **kw)
    gen = make_generate_fn(pipe, encoder)
    if args.continuous:
        batcher = ContinuousBatcher(pipe, encoder, batch_size=args.batch_size,
                                    single_fn=gen if args.latency_tier else None)
    else:
        batcher = RequestBatcher(gen, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
                                 generate_fn_single=gen if args.latency_tier else None)
    return InferenceServer(batcher, host=args.host, port=args.port)


def main(argv=None, family=None):
    args = arg_parser().parse_args(argv)
    with build_server(args, family) as srv:
        print(f"serving on :{srv.port} (batch={args.batch_size})", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass


if __name__ == "__main__":
    main()
