"""``python -m mmf_tpu_torch.cli.serve``: the flags and errors of the JAX
package's ``mmf_serve``, a port checkpoint served over HTTP on the CPU
(``device=cpu``) with the scores JAX's ``ServingEngine.from_checkpoint``
gives on the same file, the card as the default device (raises here), the
``quant`` flag, a plugin model named by the snapshot's ``env.user_dir``,
and ``Inference``'s parts that wait for later slices."""

import json
import os
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mmf_tpu_torch.cli import serve as tserve
from mmf_tpu_torch.utils.checkpoint import Checkpoint
from mmf_tpu_torch.utils.flagship import split_samples
from tests.torch_port_utils import TINY, init_pair, tiny_batch

torch.set_num_threads(2)  # several test workers share the host

MODEL = dict(TINY, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _save_checkpoint(folder, model, model_name="visual_bert",
                     model_config=None, extra_opts=()):
    """A checkpoint folder as training leaves it: config.yaml and the
    final ``.pth`` (the model's state_dict), written by the port's
    Checkpoint."""
    from mmf_tpu_torch.utils import flagship

    cfg = flagship.vqa2_config([f"env.save_dir={folder}",
                                f"model={model_name}", *extra_opts])
    cfg["model_config"][model_name] = dict(
        cfg["model_config"]["visual_bert"], **(model_config or MODEL))
    ckpt = Checkpoint(types.SimpleNamespace(config=cfg, model=model))
    ckpt.finalize()
    return str(folder)


def _post(port, sample):
    def conv(v):
        return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) \
            else np.asarray(v).tolist()

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps({"fields": conv(sample)}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_parse_opts_matches_mmf_serve():
    from mmf_tpu.cli import serve as jserve

    # JAX's flags and defaults, plus the port's device flag
    assert tserve._DEFAULTS == dict(jserve._DEFAULTS, device="cuda")
    for opts in (["port=1"], ["checkpoint"], ["checkpoint=x", "bogus=1"]):
        with pytest.raises(SystemExit) as want:
            jserve.parse_opts(opts)
        with pytest.raises(SystemExit) as got:
            tserve.parse_opts(opts)
        if "bogus=1" in opts:  # the known flags listed differ by device
            assert str(got.value).startswith(
                "mmf_serve: unknown flag 'bogus' (known: ")
            assert "device" in str(got.value)
        else:
            assert str(got.value) == str(want.value)
    cfg = tserve.parse_opts(["checkpoint=/x", "port=0", "device=cpu"])
    assert cfg["checkpoint"] == "/x" and cfg["port"] == "0"
    assert cfg["device"] == "cpu" and cfg["max_batch_size"] == "32"


def test_served_checkpoint_matches_jax_from_checkpoint(tmp_path, monkeypatch):
    from mmf_tpu.serving.engine import ServingEngine as JaxEngine
    from mmf_tpu.utils import checkpoint as jax_checkpoint
    from mmf_tpu.utils.checkpoint_updater import (
        MODEL_KEY_MAPS,
        convert_torch_state_dict,
    )
    from mmf_tpu.utils.env import setup_imports as jax_setup_imports

    batch = tiny_batch(3, seed=2)
    jm, variables, tm = init_pair(MODEL, batch)
    folder = _save_checkpoint(tmp_path, tm)
    assert sorted(os.listdir(folder)) == ["config.yaml", "models",
                                          "visual_bert_final.pth"]

    # JAX reads the same file: its torch checkpoint adapted onto the JAX
    # model's params as its Checkpoint._adapt_torch_ckpt does
    params = jax.device_get(variables["params"])
    load = jax_checkpoint.load_pretrained_model
    stats = {}

    def adapted(path, *args, **kwargs):
        items = load(path, *args, **kwargs)
        converted, stats["jax"] = convert_torch_state_dict(
            items["checkpoint"],
            jax.tree_util.tree_map(np.zeros_like, params),
            key_map=MODEL_KEY_MAPS["visual_bert"],
            format_state_key=type(jm).format_state_key)
        return dict(items, checkpoint={"variables": {"params": converted}})

    monkeypatch.setattr(jax_checkpoint, "load_pretrained_model", adapted)
    jax_setup_imports()
    jengine = JaxEngine.from_checkpoint(folder, max_batch_size=4)
    assert stats["jax"]["missed"] == 0 and stats["jax"]["shape_mismatch"] \
        == 0
    samples = split_samples(batch)
    want = jengine.predict_many(samples)

    server = tserve.build_server(tserve.parse_opts(
        [f"checkpoint={folder}", "port=0", "device=cpu",
         "max_batch_size=4", "max_wait_ms=1"])).start()
    try:
        assert server.engine.processors == dict(jengine.processors)
        for sample, w in zip(samples, want):
            status, payload = _post(server.port, sample)
            assert status == 200, payload
            scores = np.asarray(payload["scores"], np.float32)
            assert scores.shape == (TINY["num_labels"],)
            np.testing.assert_allclose(scores, np.asarray(w["scores"]),
                                       atol=2e-5, rtol=0)
    finally:
        server.shutdown()


def test_serve_defaults_to_the_card(tmp_path):
    """Without ``device=cpu`` the checkpoint is served on the card: where
    there is none, ``from_checkpoint`` and ``build_server`` raise (no CPU
    stand-in)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would work")
    from mmf_tpu_torch.serving import ServingEngine
    from tests.torch_port_utils import port_visual_bert

    folder = _save_checkpoint(tmp_path, port_visual_bert(MODEL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.from_checkpoint(folder)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.build_server(tserve.parse_opts([f"checkpoint={folder}",
                                               "port=0"]))
    engine = ServingEngine.from_checkpoint(folder, device="cpu")
    assert engine.device.type == "cpu"


def test_checkpoint_missing_an_entry_is_refused(tmp_path):
    """A checkpoint that leaves a model entry unfilled is not served with
    that entry at its init values: loading raises, as flax does on a
    missing leaf."""
    from mmf_tpu_torch.serving import ServingEngine
    from tests.torch_port_utils import port_visual_bert

    folder = _save_checkpoint(tmp_path, port_visual_bert(MODEL))
    path = os.path.join(folder, "visual_bert_final.pth")
    state = torch.load(path, weights_only=True)
    dropped = "classifier_logits.weight"
    assert dropped in state, sorted(state)
    del state[dropped]
    torch.save(state, path)
    with pytest.raises(KeyError, match=r"1 of model 'visual_bert''s"):
        ServingEngine.from_checkpoint(folder, device="cpu")


def test_quant_flag_sets_mmf_tpu_quant(tmp_path, monkeypatch):
    from mmf_tpu_torch.ops.quant import QuantDense
    from tests.torch_port_utils import port_visual_bert

    monkeypatch.setenv("MMF_TPU_QUANT", "")
    folder = _save_checkpoint(tmp_path, port_visual_bert(MODEL))
    server = tserve.build_server(tserve.parse_opts(
        [f"checkpoint={folder}", "port=0", "device=cpu", "quant=int8",
         "compilation_cache_dir=/nonexistent"])).start()
    try:
        assert os.environ["MMF_TPU_QUANT"] == "int8"
        # the visual projection, 2 x 6 trunk projections, the pooler and
        # the head transform
        assert sum(isinstance(m, QuantDense)
                   for m in server.engine.model.modules()) == 15
    finally:
        server.shutdown()


def test_checkpoint_with_a_user_dir_plugin(tmp_path):
    """A snapshot whose ``env.user_dir`` names a plugin folder: the
    plugin's model is registered before the model is built."""
    from mmf_tpu_torch.utils.inference import Inference
    from tests.torch_port_utils import port_visual_bert

    plugin = tmp_path / "mmf_port_test_plugin"
    plugin.mkdir()
    (plugin / "__init__.py").write_text(
        "from mmf_tpu_torch.common.registry import registry\n"
        "from mmf_tpu_torch.models.visual_bert import VisualBERT\n"
        "@registry.register_model('plugin_visual_bert')\n"
        "class PluginVisualBERT(VisualBERT):\n"
        "    pass\n")
    model = port_visual_bert(MODEL)
    model.init_weights(torch.Generator().manual_seed(1))
    folder = _save_checkpoint(tmp_path / "save", model,
                              model_name="plugin_visual_bert",
                              extra_opts=[f"env.user_dir={plugin}"])
    pipeline = Inference(folder)
    assert type(pipeline.model).__name__ == "PluginVisualBERT"
    for k, v in pipeline.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_inference_forward_waits_for_the_processors(tmp_path):
    from mmf_tpu_torch.utils.inference import Inference
    from tests.torch_port_utils import port_visual_bert

    pipeline = Inference(_save_checkpoint(tmp_path,
                                          port_visual_bert(MODEL)))
    assert "text_processor" in pipeline.processor
    with pytest.raises(NotImplementedError,
                       match="image decoder and the FRCNN"):
        pipeline.forward("image.jpg", {"text": "what is this?"})
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        pipeline._region_features("image.jpg")


def test_text_requests_go_through_the_served_text_processor(tmp_path):
    """A served checkpoint tokenizes a request's ``text`` with its
    ``text_processor``: the fields equal JAX's ``default_prepare`` on the
    same config, and the server answers it."""
    from mmf_tpu.serving.server import default_prepare as jax_prepare
    from mmf_tpu.utils.env import setup_imports as jax_setup_imports
    from mmf_tpu_torch.serving.server import default_prepare
    from tests.torch_port_utils import port_visual_bert

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "?", "is", "there",
         "a", "dog", "cat", "##s"]) + "\n")
    model = port_visual_bert(MODEL)
    model.init_weights(torch.Generator().manual_seed(1))
    prefix = "dataset_config.vqa2.processors.text_processor.params."
    folder = _save_checkpoint(tmp_path / "save", model, extra_opts=[
        prefix + f"tokenizer_config.params.vocab_file={vocab}",
        prefix + "max_seq_length=8"])
    server = tserve.build_server(tserve.parse_opts(
        [f"checkpoint={folder}", "port=0", "device=cpu",
         "max_batch_size=4", "max_wait_ms=1"])).start()
    try:
        jax_setup_imports()
        feats = tiny_batch(1)["image_feature_0"][0]
        request = {"text": "Is there a DOG, or cats?",
                   "fields": {"image_feature_0": feats.tolist()}}
        got = default_prepare(server.engine, request)
        want = jax_prepare(types.SimpleNamespace(
            processors=server.engine.processors), request)
        assert sorted(got) == sorted(want) == sorted(
            ["image_feature_0", "input_ids", "input_mask", "segment_ids",
             "lm_label_ids"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/predict",
            data=json.dumps(request).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert r.status == 200
        assert len(body["scores"]) == MODEL["num_labels"]
    finally:
        server.shutdown()
