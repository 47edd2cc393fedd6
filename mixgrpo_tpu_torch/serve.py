"""Batched FLUX inference server.

Port of the fixed-batch serving layer of mixgrpo_tpu/serve.py:

- ``RequestBatcher``: a queue + one device-worker thread that groups incoming
  requests into micro-batches of the configured batch size (padding the
  tail by repeating the last row), with the optional LATENCY TIER
  (``generate_fn_single``): a request that arrives alone runs at batch 1
  instead of paying padded rows.
- ``InferenceServer``: stdlib ThreadingHTTPServer.  ``POST /generate`` with
  ``{"prompt": str, "seed": int?}`` returns the PNG (or base64 JSON with
  ``"format": "json"``); ``GET /healthz``; ``GET /stats``.
- ``make_generate_fn``: the standard generate function over a
  ``DualFluxPipeline`` and an ``encode_fn(prompts) -> (txt, pooled)``.

The HTTP threads only enqueue, so the device sees one worker's calls in
order.  ``ContinuousEngine``/``ContinuousBatcher`` and ``main()`` (which needs
the checkpoint loaders and text encoders) wait for later slices.
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


@dataclass
class _Request:
    prompt: str
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    image: Optional[np.ndarray] = None
    error: Optional[str] = None
    ts: float = field(default_factory=time.time)  # enqueue time


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
        req = _Request(prompt=prompt, seed=seed)
        self.queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.image

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
    arrays or tensors; until the text encoders are ported it is the caller's
    stand-in.  Each request's seed drives its own initial-noise row through
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
