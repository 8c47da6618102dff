"""Threaded HTTP front-end over (ServingEngine + MicroBatcher).

Port of ``mmf_tpu/serving/server.py``. Endpoints:
  GET  /healthz     -> {"status": "ok"}
  GET  /v1/stats    -> batcher + engine statistics
  POST /v1/predict  -> run one request through the batched forward
(``/v1/profile`` answers 404 until the tracing port.)

Request JSON for /v1/predict:
  {"fields": {name: nested-list-or-scalar, ...},   # array inputs
   "text": "..."}                                  # optional; through the
                                                   # served checkpoint's
                                                   # text_processor
(An engine with no ``text_processor``, one built in memory, answers a
``text`` request 400.)

Response JSON: every output field as nested lists, plus "label" and
"confidence" (softmax over "scores") when the model emits scores.

Concurrency: the stdlib ThreadingHTTPServer gives one thread per
connection; every handler submits to the shared MicroBatcher, so
concurrent requests ride the same device batch, and the card's work is
single-file through the batcher's worker thread.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np

from mmf_tpu_torch.serving.batcher import MicroBatcher
from mmf_tpu_torch.serving.engine import ServingEngine

logger = logging.getLogger(__name__)


def _to_array(v):
    """JSON value -> numpy array (float64 -> float32, int64 -> int32);
    a JSON object becomes a nested sample dict (e.g. ``image_info_0``)."""
    if isinstance(v, dict):
        return {k: _to_array(x) for k, x in v.items()}
    arr = np.asarray(v)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    elif arr.dtype.kind not in "biuf":
        raise ValueError(f"field values must be numeric, got {arr.dtype}")
    return arr


_TEXT_PROCESSOR_LOCK = threading.Lock()


def _text_processor(engine: ServingEngine):
    """The engine's text processor, built once from the served
    checkpoint's ``processors`` config (the handler threads share it)."""
    processors = getattr(engine, "processors", None)
    if not processors or "text_processor" not in processors:
        raise ValueError(
            "request has 'text' but the engine exposes no text_processor; "
            "send pre-processed 'fields' instead"
        )
    with _TEXT_PROCESSOR_LOCK:
        if getattr(engine, "_text_processor", None) is None:
            from mmf_tpu_torch.datasets.processors.processors import Processor

            engine._text_processor = Processor(processors["text_processor"])
    return engine._text_processor


def default_prepare(engine: ServingEngine,
                    request: Dict[str, Any]) -> Dict[str, Any]:
    """Request JSON -> sample dict of arrays: ``fields`` pass through;
    ``text`` runs the engine's text processor, whose array outputs
    (``input_ids``, ``input_mask``, ...) join the sample."""
    if not isinstance(request, dict):
        raise ValueError("request body must be a JSON object")
    sample = {k: _to_array(v)
              for k, v in (request.get("fields") or {}).items()}
    text = request.get("text")
    if text is not None:
        out = _text_processor(engine)({"text": text})
        sample.update((k, v) for k, v in out.items()
                      if isinstance(v, np.ndarray))
    if not sample:
        raise ValueError("empty request: provide 'fields' and/or 'text'")
    return sample


def default_render(output: Any) -> Dict[str, Any]:
    """Per-sample model output -> JSON-serializable response."""
    if not isinstance(output, dict):
        output = {"output": output}
    resp: Dict[str, Any] = {}
    for k, v in output.items():
        if k == "losses":
            continue
        resp[k] = np.asarray(v).tolist()
    scores = output.get("scores")
    if scores is not None:
        s = np.asarray(scores, np.float32)
        if s.ndim == 1:
            e = np.exp(s - s.max())
            probs = e / e.sum()
            top = int(probs.argmax())
            resp["label"] = top
            resp["confidence"] = float(probs[top])
    return resp


class ServingServer:
    """Owns the HTTP server, the batcher and their lifecycle."""

    def __init__(
        self,
        engine: ServingEngine,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_wait_ms: float = 5.0,
        prepare: Optional[Callable] = None,
        render: Optional[Callable] = None,
    ):
        self.engine = engine
        self.prepare = prepare or default_prepare
        self.render = render or default_render
        self.batcher = MicroBatcher(
            engine.predict_many,
            max_batch_size=engine.max_batch_size,
            max_wait_ms=max_wait_ms,
            # pipelined: dispatch batch N+1 while batch N's results are
            # copied back
            predict_many_async=engine.predict_many_async,
        )
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                logger.debug("%s %s", self.address_string(), fmt % args)

            def _send(self, code: int, payload: Dict[str, Any]):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/v1/stats":
                    self._send(200, server.stats())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/v1/predict":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    request = json.loads(self.rfile.read(length) or b"{}")
                    sample = server.prepare(server.engine, request)
                    # schema check BEFORE enqueue: a malformed request
                    # 400s alone instead of failing its shared batch
                    server.engine.validate_sample(sample)
                    output = server.batcher.predict(sample, timeout=60)
                    self._send(200, server.render(output))
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — server boundary
                    logger.exception("predict failed")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def stats(self) -> Dict[str, Any]:
        return {
            "batcher": self.batcher.stats(),
            "engine": {
                "buckets": list(self.engine.buckets),
                "max_batch_size": self.engine.max_batch_size,
                "device": str(self.engine.device),
            },
        }

    def start(self):
        """Serve on a background thread (returns immediately)."""
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="mmf-serve-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
