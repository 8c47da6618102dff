"""ServingEngine: bucket-padded batched inference over a torch model.

Port of ``mmf_tpu/serving/engine.py``. Every batch is padded to a small
ladder of bucket sizes (tiling the final sample, outputs trimmed back),
as in the JAX engine: the shapes the model sees stay few and fixed,
which keeps kernel shapes, allocator blocks and later CUDA graphs
reusable. There is no jit.

The model is an ``nn.Module`` mapping a (possibly nested) batch dict of
tensors with a shared leading batch dimension to a dict of outputs with
the same leading dimension. The engine serves on the card (``device``
defaults to ``"cuda"``; a machine without one raises) unless the caller
passes ``device="cpu"``. It moves the model to ``device`` once,
puts it in eval mode and, when the model has ``to_compute_dtype``, casts
its weights to the compute dtype once. Per batch: the stacked numpy
arrays go to the device in one host-to-device copy, the forward runs
under ``torch.inference_mode()`` on the calling thread's current stream,
and the outputs are copied back asynchronously; ``finalize()`` waits for
that copy before it hands back numpy arrays (bfloat16 outputs come back
as float32, since numpy has no bfloat16).

``from_checkpoint`` builds the engine from a checkpoint folder (the
model rebuilt from its config snapshot, the weights loaded); its batches
carry the checkpoint's dataset as ``dataset_name`` (and ``dataset_type``
``test``) unless the samples name one, so that a model with heads per
dataset (ViLT) answers. The JAX engine passes no such field, and a
request cannot carry a string, so there a served ViLT gives no scores.
Not ported yet: ``mesh=`` (multi-card serving) and ``from_export``
(``torch.export`` cannot trace the kernels' ctypes launches until they
are registered as ``torch.library`` custom ops with fake
implementations).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _default_buckets(max_batch: int):
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _is_array(v) -> bool:
    return isinstance(v, np.ndarray) or hasattr(v, "dtype")


def _sample_schema(sample: Dict[str, Any]) -> Dict[str, Any]:
    """Structural signature of one request sample: nested key set plus
    per-array shape/dtype. Used to reject malformed requests at submit
    time, before they can poison a shared micro-batch."""
    schema: Dict[str, Any] = {}
    for k, v in sample.items():
        if isinstance(v, dict):
            schema[k] = _sample_schema(v)
        elif _is_array(v):
            a = np.asarray(v)
            schema[k] = ("array", tuple(a.shape), str(a.dtype))
        else:
            schema[k] = ("static",)
    return schema


def _schema_diff(expected: Dict[str, Any], got: Dict[str, Any],
                 prefix: str = "") -> List[str]:
    problems = []
    for k in expected:
        path = f"{prefix}{k}"
        if k not in got:
            problems.append(f"missing field {path!r}")
        elif isinstance(expected[k], dict) != isinstance(got[k], dict):
            problems.append(f"field {path!r} has wrong structure")
        elif isinstance(expected[k], dict):
            problems.extend(_schema_diff(expected[k], got[k], path + "."))
        elif expected[k][0] == "array" and got[k][0] == "array" and \
                expected[k] != got[k]:
            problems.append(
                f"field {path!r} expects shape {expected[k][1]} dtype "
                f"{expected[k][2]}, got shape {got[k][1]} dtype {got[k][2]}"
            )
    for k in got:
        if k not in expected:
            problems.append(f"unexpected field {prefix}{k!r}")
    return problems


def _stack_samples(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of sample dicts into one batch dict. Array leaves
    stack along a new leading axis; non-array fields must agree across
    the batch and pass through as static metadata."""
    batch: Dict[str, Any] = {}
    first = samples[0]
    keys0 = set(first.keys())
    for i, s in enumerate(samples[1:], start=1):
        if set(s.keys()) != keys0:
            missing = sorted(keys0 - set(s.keys()))
            extra = sorted(set(s.keys()) - keys0)
            raise ValueError(
                f"sample {i} key set differs from sample 0: "
                f"missing={missing} extra={extra}"
            )
    for key, v0 in first.items():
        vals = [s[key] for s in samples]
        if isinstance(v0, dict):
            batch[key] = _stack_samples(vals)
        elif _is_array(v0):
            batch[key] = np.stack([np.asarray(v) for v in vals])
        else:
            if any(v != v0 for v in vals[1:]):
                raise ValueError(
                    f"non-array field {key!r} differs within a batch: "
                    f"{sorted(set(map(repr, vals)))}"
                )
            batch[key] = v0
    return batch


def _pad_batch(tree, n: int, target: int):
    """Tile each array leaf's final row so the leading dim reaches
    ``target``. Tiling a real sample (not zeros) keeps every padded lane
    numerically typical — no masking surprises, outputs are trimmed."""
    if isinstance(tree, dict):
        return {k: _pad_batch(v, n, target) for k, v in tree.items()}
    if _is_array(tree) and getattr(tree, "ndim", 0) >= 1:
        arr = np.asarray(tree)
        if arr.shape[0] == n and target > n:
            reps = np.repeat(arr[-1:], target - n, axis=0)
            return np.concatenate([arr, reps], axis=0)
        return arr
    return tree


def _split_static(batch):
    """Partition a batch dict into array leaves and static metadata (e.g.
    ``dataset_name`` strings)."""
    arrays, statics = {}, {}
    for k, v in batch.items():
        if isinstance(v, dict):
            sub_a, sub_s = _split_static(v)
            if sub_a:
                arrays[k] = sub_a
            if sub_s:
                statics[k] = sub_s
        elif _is_array(v):
            arrays[k] = v
        else:
            statics[k] = v
    return arrays, statics


def _merge(arrays, statics):
    out = dict(arrays)
    for k, v in statics.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _to_device(arrays: Dict[str, Any], device: torch.device):
    """Move every numpy leaf to ``device`` in ONE host-to-device copy:
    the leaves are packed into one byte buffer (16-byte aligned offsets)
    and viewed back as typed tensors on the device."""
    leaves = [(p, np.asarray(a)) for p, a in _leaves(arrays)]
    offsets, total = [], 0
    for _, a in leaves:
        offsets.append(total)
        total += (a.nbytes + 15) // 16 * 16
    buf = np.empty(max(total, 1), np.uint8)
    for (_, a), off in zip(leaves, offsets):
        buf[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    dev = torch.from_numpy(buf).to(device)
    out: Dict[str, Any] = {}
    for (path, a), off in zip(leaves, offsets):
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        t = dev[off:off + a.nbytes].view(dtype)
        _set_path(out, path, t.view(a.shape))
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_numpy(t):
    if not isinstance(t, torch.Tensor):
        return t
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _trim_split(tree, n: int, batch: int):
    """Trim output leaves with a ``batch`` leading dim to ``n`` rows and
    split per-sample; non-batched leaves replicate to every sample."""
    if isinstance(tree, dict):
        per_key = {k: _trim_split(v, n, batch) for k, v in tree.items()}
        return [
            {k: v[i] for k, v in per_key.items()} for i in range(n)
        ]
    arr = np.asarray(tree)
    if arr.ndim >= 1 and arr.shape[0] == batch:
        return [arr[i] for i in range(n)]
    return [arr] * n


def _serving_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ServingEngine serves on the card by default, and this "
            "machine has no CUDA device; pass device='cpu' to serve "
            "through the plain versions on the CPU"
        )
    return device


class ServingEngine:
    """Bucket-padded batched inference. Thread-compatible: forwards are
    serialized with an internal lock, so the engine can sit behind a
    MicroBatcher or be used directly."""

    def __init__(
        self,
        model: torch.nn.Module,
        device: Any = "cuda",
        max_batch_size: int = 32,
        buckets: Optional[Sequence[int]] = None,
        postprocess: Optional[Callable[[Dict[str, Any]], Any]] = None,
        output_fields: Optional[Sequence[str]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.device = _serving_device(device)
        # static fields every batch gets where its samples lack them
        # (``dataset_name`` picks a per-dataset model's heads)
        self.meta = dict(meta or {})
        # top-level output keys to return (None = all); unused fields
        # are never copied back to the host
        self.output_fields = (
            tuple(output_fields) if output_fields is not None else None
        )
        model = model.to(self.device).eval()
        if hasattr(model, "to_compute_dtype"):
            model.to_compute_dtype()
        self.model = model
        self.buckets = tuple(sorted(buckets or
                                    _default_buckets(max_batch_size)))
        self.max_batch_size = self.buckets[-1]
        self.postprocess = postprocess
        self._lock = threading.Lock()
        self._schema: Optional[Dict[str, Any]] = None

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, device: Any = "cuda",
                        **kwargs):
        """Build from an MMF checkpoint folder (the model rebuilt from
        the snapshot config, weights loaded; processors exposed on the
        engine). Serves on the card unless ``device="cpu"``."""
        from mmf_tpu_torch.utils.inference import Inference

        _serving_device(device)  # before the model is built
        pipeline = Inference(checkpoint_path=checkpoint_path)
        kwargs.setdefault("meta", {"dataset_name": pipeline.dataset_name,
                                   "dataset_type": "test"})
        engine = cls(pipeline.model, device=device, **kwargs)
        engine.processors = pipeline.processor
        return engine

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} exceeds max_batch_size={self.max_batch_size}"
        )

    def validate_sample(self, sample: Dict[str, Any]) -> None:
        """Raise ValueError if ``sample`` does not match the schema
        learned from the first served sample. Call at submit time (the
        server does, before MicroBatcher enqueue) so one malformed
        request gets its own 400 instead of failing the co-batched
        requests sharing its device batch."""
        if not isinstance(sample, dict):
            raise ValueError(
                f"sample must be a dict, got {type(sample).__name__}"
            )
        if self._schema is None:
            self._schema = _sample_schema(sample)
            return
        problems = _schema_diff(self._schema, _sample_schema(sample))
        if problems:
            raise ValueError(
                "request does not match the serving schema: "
                + "; ".join(problems)
            )

    def predict_many(self, samples: List[Dict[str, Any]]) -> List[Any]:
        """Run a list of request samples through one (or, above the max
        bucket, several) device batches; returns per-sample outputs."""
        out: List[Any] = []
        cap = self.max_batch_size
        for lo in range(0, len(samples), cap):
            out.extend(self.predict_many_async(samples[lo:lo + cap])())
        return out

    def predict(self, sample: Dict[str, Any]) -> Any:
        return self.predict_many([sample])[0]

    def predict_many_async(self, samples: List[Dict[str, Any]]):
        """Dispatch one bucket batch without waiting for the device;
        returns a ``finalize()`` that waits for the outputs' copy to the
        host and yields the per-sample outputs. Lets a MicroBatcher in
        pipelined mode stack and send batch N+1 while batch N computes.
        Only valid up to ``max_batch_size``."""
        n = len(samples)
        bucket = self._bucket(n)
        batch = _pad_batch(_stack_samples(samples), n, bucket)
        arrays, statics = _split_static(batch)
        statics = dict(self.meta, **statics)
        cuda = self.device.type == "cuda"
        with self._lock:
            tensors = _to_device(arrays, self.device)
            with torch.inference_mode():
                output = self.model(_merge(tensors, statics))
            if self.output_fields is not None and isinstance(output, dict):
                output = {k: v for k, v in output.items()
                          if k in self.output_fields}
            done = None
            if cuda:
                # D2H into pinned buffers, ordered after the forward on
                # this thread's stream; the event marks their completion
                output = _tree_map(
                    lambda t: torch.empty(
                        t.shape, dtype=t.dtype, pin_memory=True
                    ).copy_(t, non_blocking=True)
                    if isinstance(t, torch.Tensor) else t,
                    output,
                )
                done = torch.cuda.Event()
                done.record()

        def finalize():
            if done is not None:
                done.synchronize()
            host = _tree_map(_to_numpy, output)
            results = _trim_split(host, n, bucket)
            if self.postprocess is not None:
                return [self.postprocess(r) for r in results]
            return results

        return finalize

    def warmup(self, example: Dict[str, Any], buckets=None):
        """Run every bucket size once (kernel builds, allocator warm-up)
        so no live request pays for it. Returns the bucket sizes run."""
        done = []
        for b in buckets or self.buckets:
            self.predict_many([example] * b)
            done.append(b)
        return done
