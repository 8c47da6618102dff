"""mmf_serve on the port: batched-inference HTTP server over a checkpoint.

Port of ``mmf_tpu/cli/serve.py``: serves a checkpointed model behind
/v1/predict with dynamic micro-batching over bucket-padded batches.

  python -m mmf_tpu_torch.cli.serve checkpoint=save/ port=8080 \
      max_batch_size=32 max_wait_ms=5 quant=int8

Flags (key=value):
  checkpoint      (required) checkpoint folder (config.yaml + .ckpt/.pth)
  host            bind address          [127.0.0.1]
  port            TCP port              [8080]
  max_batch_size  largest device batch  [32]
  max_wait_ms     batching window       [5]
  quant           serving precision: none|int8 (sets MMF_TPU_QUANT)
  device          cuda|cpu              [cuda]; the counterpart of
                  JAX_PLATFORMS, and the only way to serve on the CPU
                  (without a card the default raises)
  compilation_cache_dir  accepted so that command lines carry over; it
                  has no effect here (there is no XLA cache)

Each bucket's first batch pays its kernels' builds; use
``ServingEngine.warmup(example)`` from the library API to run them
before the first request.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional

logger = logging.getLogger("mmf_tpu_torch")

_DEFAULTS = {
    "checkpoint": None,
    "host": "127.0.0.1",
    "port": "8080",
    "max_batch_size": "32",
    "max_wait_ms": "5",
    "quant": "none",
    "compilation_cache_dir": "",
    "device": "cuda",
}


def parse_opts(opts: List[str]) -> dict:
    cfg = dict(_DEFAULTS)
    for opt in opts:
        if "=" not in opt:
            raise SystemExit(f"mmf_serve: expected key=value, got {opt!r}")
        k, v = opt.split("=", 1)
        if k not in cfg:
            raise SystemExit(
                f"mmf_serve: unknown flag {k!r} "
                f"(known: {', '.join(sorted(cfg))})"
            )
        cfg[k] = v
    if not cfg["checkpoint"]:
        raise SystemExit("mmf_serve: checkpoint=<path> is required")
    return cfg


def build_server(cfg: dict):
    """Construct (but don't start) the ServingServer from parsed flags."""
    if cfg["quant"] and cfg["quant"] != "none":
        os.environ["MMF_TPU_QUANT"] = cfg["quant"]

    from mmf_tpu_torch.serving.engine import ServingEngine
    from mmf_tpu_torch.serving.server import ServingServer
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    if cfg.get("compilation_cache_dir"):
        logger.info("mmf_serve: compilation_cache_dir has no effect on the "
                    "port (no XLA cache); ignored")
    engine = ServingEngine.from_checkpoint(
        cfg["checkpoint"], device=cfg["device"],
        max_batch_size=int(cfg["max_batch_size"]),
    )
    return ServingServer(
        engine,
        host=cfg["host"],
        port=int(cfg["port"]),
        max_wait_ms=float(cfg["max_wait_ms"]),
    )


def serve(opts: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO)
    cfg = parse_opts(sys.argv[1:] if opts is None else opts)
    server = build_server(cfg)
    logger.info(
        "mmf_serve: listening on http://%s:%d (buckets %s)",
        cfg["host"], server.port, list(server.engine.buckets),
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("mmf_serve: shutting down")
        server.shutdown()


if __name__ == "__main__":
    serve()
