"""Serving end to end on the CPU: the port's ServingEngine behind its
ServingServer (port 0) with a tiny VisualBERT holding JAX-initialised
weights. Concurrent /v1/predict requests must come back with the JAX
model's scores; bucket padding, trimming, /v1/stats and the 400/404
paths are checked too."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmf_tpu_torch.serving import ServingEngine
from mmf_tpu_torch.serving.engine import _to_device
from mmf_tpu_torch.serving.server import ServingServer
from mmf_tpu_torch.utils.flagship import split_samples
from tests.torch_port_utils import TINY, init_pair, jax_forward, tiny_batch

torch.set_num_threads(2)  # several test workers share the host

F32_ATOL = 2e-5  # the repo's own parity bar (README)


@pytest.fixture(scope="module")
def served():
    batch = tiny_batch(6, seed=4)
    jm, variables, tm = init_pair(dict(TINY), batch)
    want = jax_forward(jm, variables, batch)
    engine = ServingEngine(tm, device="cpu", max_batch_size=4)
    server = ServingServer(engine, port=0, max_wait_ms=20.0).start()
    try:
        yield engine, server, split_samples(batch), want
    finally:
        server.shutdown()


def _post(port, payload, path="/v1/predict"):
    body = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _fields(sample):
    def conv(v):
        return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) \
            else np.asarray(v).tolist()
    return {"fields": conv(sample)}


def test_concurrent_requests_match_jax(served):
    engine, server, samples, want = served
    assert engine.buckets == (1, 2, 4)
    results = [None] * len(samples)

    def send(i):
        results[i] = _post(server.port, _fields(samples[i]))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(samples))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, (code, body) in enumerate(results):
        assert code == 200, body
        np.testing.assert_allclose(np.asarray(body["scores"], np.float32),
                                   want["scores"][i], atol=F32_ATOL, rtol=0)
        assert body["label"] == int(np.argmax(want["scores"][i]))

    code, stats = _get(server.port, "/v1/stats")
    assert code == 200
    assert stats["batcher"]["requests"] >= len(samples)
    assert sum(stats["batcher"]["batch_size_hist"].values()) == \
        stats["batcher"]["batches"]
    assert stats["engine"]["buckets"] == [1, 2, 4]
    assert stats["engine"]["device"] == "cpu"


def test_bad_requests_get_400_and_unknown_routes_404(served):
    _, server, samples, _ = served
    assert _post(server.port, _fields(samples[0]))[0] == 200  # learn schema
    bad = _fields(samples[0])
    bad["fields"]["image_feature_0"] = bad["fields"]["image_feature_0"][:2]
    code, body = _post(server.port, bad)
    assert code == 400 and "image_feature_0" in body["error"]
    assert _post(server.port, b"{not json")[0] == 400
    assert _post(server.port, {"text": "is there a dog?"})[0] == 400
    assert _post(server.port, {})[0] == 400
    assert _post(server.port, {"seconds": 1}, "/v1/profile")[0] == 404
    assert _get(server.port, "/healthz") == (200, {"status": "ok"})
    assert _get(server.port, "/nope")[0] == 404


def test_bucket_padding_and_trimming(served):
    engine, _, samples, want = served
    out = engine.predict_many(samples[:3])  # padded to bucket 4
    assert len(out) == 3
    for i, o in enumerate(out):
        assert o["scores"].shape == (TINY["num_labels"],)
        np.testing.assert_allclose(o["scores"], want["scores"][i],
                                   atol=F32_ATOL, rtol=0)
    # above the largest bucket: split into bucket-sized chunks
    out = engine.predict_many(samples + samples[:1])
    assert len(out) == 7
    np.testing.assert_allclose(out[6]["scores"], want["scores"][0],
                               atol=F32_ATOL, rtol=0)


def test_batch_moves_in_one_buffer_and_keeps_dtypes():
    arrays = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
              "n": {"f": np.linspace(0, 1, 5, dtype=np.float32),
                    "b": np.array([True, False, True])},
              "s": np.float32(2.5)}
    out = _to_device(arrays, torch.device("cpu"))
    assert out["a"].dtype == torch.int32 and out["a"].shape == (2, 3)
    assert out["n"]["b"].dtype == torch.bool
    np.testing.assert_array_equal(out["a"].numpy(), arrays["a"])
    np.testing.assert_array_equal(out["n"]["f"].numpy(), arrays["n"]["f"])
    np.testing.assert_array_equal(out["n"]["b"].numpy(), arrays["n"]["b"])
    assert out["s"].shape == () and float(out["s"]) == 2.5
    # one storage behind every leaf
    ptrs = {t.untyped_storage().data_ptr()
            for t in (out["a"], out["n"]["f"], out["n"]["b"], out["s"])}
    assert len(ptrs) == 1


def test_engine_serves_on_the_card_by_default():
    """``ServingEngine(model)`` means the card: without one it raises
    instead of serving on the CPU; ``device="cpu"`` must be asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would work")
    from tests.torch_port_utils import port_visual_bert

    model = port_visual_bert(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    assert ServingEngine(model, device="cpu").device.type == "cpu"
