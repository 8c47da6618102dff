"""``mmf_run`` of LoRRA (TextVQA, VQA2 and VizWiz), BAN (VQA2, TextVQA
and VizWiz) and CNN-LSTM (Hateful Memes) on the CPU, against JAX's
``mmf_run``; serving their checkpoints.

Each config of ``flagship.LORRA_BAN`` with its ``LORRA_BAN_OVERRIDES``
(in JAX too: ROADMAP C.4) runs at small widths (LoRRA with Pythia's
text LSTM 16, combine 20, classifier 24 / 12; BAN with a GRU of 12 and
2 glimpses, BCNet's dropout 0 in both packages; CNN-LSTM over 64 px
images) on the synthetic layouts (``tests/torch_vqa2_layout.py`` with
OCR tokens and the VizWiz copy, ``tests/torch_textvqa_layout.py``,
``tests/torch_hm_layout.py``), batch 8, 2 updates, from one set of
weights (the JAX model's shapes drawn from a numpy seed):

- the train losses at every update within 1e-6 relative (CNN-LSTM's
  within 1e-5: its BatchNorms in training carry the frameworks' f32
  convolution rounding to 1.8e-6 of the loss);
- the val losses within 1e-5 and the metrics equal, the prediction rows
  equal (OCR copies included);
- a run's folder of each model served by
  ``ServingEngine.from_checkpoint`` (``device=cpu``) at buckets 1, 2 and
  4 within 2e-5 of JAX's engine on the same file, through both engines'
  ``predict_many`` (LoRRA's samples without their string
  ``context_tokens``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.test_torch_ban import ban_no_dropout
from tests.test_torch_butd_run import jax_engine
from tests.test_torch_caption_run import _meters, _no_download, _rows
from tests.test_torch_hm_run import _csv_rows
from tests.test_torch_m4c_family_run import (
    _clear_processors,
    _restore_global_state,  # noqa: F401 (the module's autouse fixture)
)
from tests.torch_caption_models import init_shapes, randomize
from tests.torch_port_utils import registries_restored, tree_map

torch.set_num_threads(2)  # several test workers share the host

B, REGIONS, DIM, ANSWERS, UPDATES = 8, 10, 16, 6, 2
TEXTVQA_ANSWERS = 40
IMAGE = 64  # CNN-LSTM's images: six pools of 2 leave 1 x 1
LOSS_RTOL, VAL_RTOL = 1e-6, 1e-5
# CNN-LSTM's BatchNorms normalise each of its six convolutions' outputs
# by the batch's statistics in training, the last over 8 values a
# channel: the frameworks' f32 convolutions round differently, and the
# normalisation carries that to 1.8e-6 of the loss (ROADMAP C.5; the
# float64 trajectory in tests/test_torch_cnn_lstm.py holds the model)
CNN_LOSS_RTOL = 1e-5
_COMBINE = "{type: non_linear_element_multiply, params: {dropout: 0, " \
    "hidden_dim: 20}}"
LORRA_SMALL = {
    "image_feature_dim": DIM,
    "classifier.params.img_hidden_dim": 24,
    "classifier.params.text_hidden_dim": 12,
    "image_text_modal_combine.params.hidden_dim": 20,
    "image_feature_embeddings": (
        f"[{{modal_combine: {_COMBINE}, normalization: softmax, transform: "
        "{type: linear, params: {out_dim: 1}}}]"),
    "context_feature_embeddings": (
        f"[{{modal_combine: {_COMBINE}, normalization: sigmoid, transform: "
        "{type: linear, params: {out_dim: 1}}}]"),
    "text_embeddings": (
        "[{type: attention, params: {hidden_dim: 16, num_layers: 1, "
        "conv1_out: 8, conv2_out: 2, dropout: 0, embedding_dim: 300, "
        "kernel_size: 1, padding: 0}}]"),
}
BAN_SMALL = {
    "text_embedding.num_hidden": 12, "bilinear_attention.gamma": 2,
    "bilinear_attention.visual_feat_dim": DIM,
    "bilinear_attention.fc_net.dropout": 0, "classifier.dropout": 0,
}
# the memes' centres, uncut by a resize (PIL's and torch's resizes differ
# in the last bits, ROADMAP C.5)
HM_64PX = (
    "dataset_config.hateful_memes.processors.image_processor.params."
    f"transforms=[{{type: CenterCrop, params: {{size: [{IMAGE}, {IMAGE}]}}}}"
    ", ToTensor, GrayScaleTo3Channels, {type: Normalize, params: {mean: "
    "[0.5, 0.5, 0.5], std: [0.25, 0.25, 0.25]}}]")
KEYS = ("lorra_textvqa", "lorra_vqa2", "lorra_vizwiz", "ban_vqa2",
        "ban_textvqa", "ban_vizwiz", "cnn_lstm_hateful_memes")
SERVED = ("lorra_vqa2", "ban_vqa2", "cnn_lstm_hateful_memes")


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    from tests import torch_hm_layout, torch_textvqa_layout, torch_vqa2_layout

    roots = {k: str(tmp_path_factory.mktemp(f"{k}_layout"))
             for k in ("vqa2", "textvqa", "hateful_memes")}
    torch_vqa2_layout.write_layout(
        roots["vqa2"], n_train=16, n_val=8, n_test=8, n_images=30,
        regions=REGIONS, feature_dim=DIM, num_answers=ANSWERS,
        vocab_size=200, seed=3, glove=True, ocr=True, vizwiz=True)
    torch_textvqa_layout.write_layout(
        roots["textvqa"], n_train=16, n_val=8, n_test=8, n_images=12,
        max_obj=REGIONS, feature_dim=DIM, num_answers=TEXTVQA_ANSWERS,
        vocab_size=200,
        seed=4)
    torch_hm_layout.write_layout(roots["hateful_memes"], n_train=16,
                                 n_val=8, n_test=8, n_images=24,
                                 vocab_size=200, seed=5)
    return roots


def _opts(key, roots, save_dir, *extra):
    from mmf_tpu_torch.utils.flagship import LORRA_BAN, LORRA_BAN_OVERRIDES
    from tests import torch_hm_layout, torch_textvqa_layout

    path, dataset, model = LORRA_BAN[key]
    opts = [f"config={path}", f"model={model}", f"dataset={dataset}",
            "training.device=cpu", f"env.save_dir={save_dir}",
            f"training.batch_size={B}", f"training.max_updates={UPDATES}",
            f"training.evaluation_interval={UPDATES}",
            f"training.checkpoint_interval={UPDATES}",
            "training.log_interval=1", "training.num_workers=0",
            "training.seed=1", "run_type=train_val_inference",
            "evaluation.predict=true", "training.warmup_iterations=1",
            ] + LORRA_BAN_OVERRIDES[key]
    if dataset == "textvqa":
        opts += torch_textvqa_layout.layout_opts(roots["textvqa"])
    elif dataset == "hateful_memes":
        opts += torch_hm_layout.layout_opts(roots["hateful_memes"], False) + [
            HM_64PX, "scheduler.params.num_warmup_steps=1"]
        opts.append("model_config.cnn_lstm.text_vocab_size="
                    f"{_text_vocab(opts)}")
    else:
        two = model == "lorra" and dataset == "vqa2"  # the resnet152 set
        opts += [f"env.data_dir={roots['vqa2']}",
                 f"dataset_config.{dataset}.max_features={REGIONS}"] + [
            f"dataset_config.{dataset}.features.{split}=['"
            + ",".join([f"coco/defaults/features/{folder}"] * (1 + two))
            + "']" for split, folder in (("train", "trainval2014"),
                                         ("val", "trainval2014"),
                                         ("test", "test2015"))]
    small = {"lorra": LORRA_SMALL, "ban": BAN_SMALL}.get(model, {})
    if model != "cnn_lstm":
        # a served model holds no dataset in the registry: its words and
        # answers come from these keys (the soft copy's 50 OCR slots too)
        answers = TEXTVQA_ANSWERS if dataset == "textvqa" else ANSWERS
        copy = model == "lorra" or dataset == "textvqa"
        small = dict(small, text_vocab_size=_text_vocab(opts),
                     num_labels=answers + 50 * copy)
    return opts + [f"model_config.{model}.{k}={v}"
                   for k, v in small.items()] + list(extra)


_VOCAB = {}


def _text_vocab(opts):
    """The size of the text vocabulary the config's dataset reads (one
    reading a dataset and layout)."""
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.utils.flagship import text_vocab_size

    key = tuple(o for o in opts if not o.startswith("env.save_dir"))
    if key not in _VOCAB:
        _VOCAB[key] = text_vocab_size(Configuration(opts).get_config())
    return _VOCAB[key]


def _initial_variables(jm, batch):
    """The run's initial weights: the model's shapes drawn from a numpy
    seed (``torch_caption_models.randomize``: flax's initialisers, run
    eagerly, cost seconds a model), BatchNorm's statistics at flax's
    mean 0 and variance 1."""
    shapes = init_shapes(jm, jax.random.PRNGKey(3),
                         tree_map(jnp.asarray, batch), False)
    variables = randomize(shapes, seed=3)
    if "batch_stats" in shapes:
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, leaf: (np.zeros if str(path[-1].key) == "mean"
                                else np.ones)(leaf.shape, np.float32),
            shapes["batch_stats"])
    return variables


def _init_batch(key):
    """A batch of the config's fields for JAX's init (flax infers the
    widths from it)."""
    from mmf_tpu_torch.utils.flagship import LORRA_BAN

    _, dataset, model = LORRA_BAN[key]
    rng = np.random.RandomState(5)
    if model == "cnn_lstm":
        return {"text": rng.randint(1, 20, (2, 14)),
                "image": rng.randn(2, 3, IMAGE, IMAGE).astype(np.float32)}
    batch = {"text": rng.randint(1, 20, (2, 14)),
             "image_feature_0": rng.randn(2, REGIONS, DIM).astype(
                 np.float32)}
    if model == "lorra":
        if dataset == "vqa2":
            batch["image_feature_1"] = batch["image_feature_0"]
        batch.update({
            "context_feature_0": rng.randn(2, 50, 300).astype(np.float32),
            "context_info_0": {"max_features": np.array([3, 50])},
            "order_vectors": np.stack([np.eye(50, dtype=np.float32)] * 2)})
    return batch


@pytest.fixture(scope="module", params=KEYS)
def runs(request, layouts, tmp_path_factory):
    """key -> JAX's and the port's runs (trainer, folder) from one JAX
    init."""
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu.utils.env import setup_imports
    from mmf_tpu_torch.cli.run import run as port_run
    from mmf_tpu_torch.utils.flagship import LORRA_BAN

    key = request.param
    model = LORRA_BAN[key][2]
    out = str(tmp_path_factory.mktemp(f"{key}_init"))
    setup_imports()
    with pytest.MonkeyPatch.context() as mp:
        ban_no_dropout(mp)
        _no_download(mp)
        config = Configuration(_opts(key, layouts, out)).get_config()
        with registries_restored():
            # the model's words and answers are the config's (the
            # layout's, which the run's datasets register too)
            jreg.register("config", config)
            jm = jreg.get_model_class(model)(
                config=config["model_config"][model])
            variables = _initial_variables(jm, _init_batch(key))
        jax_file = os.path.join(out, "init_jax")
        _checkpointer().save(jax_file, {"variables": dict(variables)})
        port_file = os.path.join(out, "init_port.pth")
        torch.save(params_from_jax(variables["params"],
                                   variables.get("batch_stats")), port_file)
        dirs = {s: str(tmp_path_factory.mktemp(f"{key}_{s}"))
                for s in ("jax", "port")}
        _clear_processors()
        jt = jax_run(_opts(key, layouts, dirs["jax"],
                           f"checkpoint.resume_file={jax_file}"))
        _clear_processors()
        pt = port_run(_opts(key, layouts, dirs["port"],
                            f"checkpoint.resume_file={port_file}"))
        yield key, {"jax": (jt, dirs["jax"]), "port": (pt, dirs["port"])}
    _clear_processors()


def test_losses_match_jax(runs):
    key, sides = runs
    want, got = (_meters(sides[s][0], "") for s in ("jax", "port"))
    names = {k for k in want if "train" in k and "total" not in k}
    assert len(names) == 1 and set(got) == set(want)
    for name in names:
        assert len(got[name]) == UPDATES and np.isfinite(got[name]).all()
        rtol = CNN_LOSS_RTOL if key.startswith("cnn_lstm") else LOSS_RTOL
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   err_msg=name)
        assert len(set(np.round(got[name], 7))) > 1  # the weights moved


def test_val_predictions_and_serving_match_jax(runs, monkeypatch):
    """The val metrics, the prediction rows and, for one run of each
    model (``SERVED``: LoRRA's of two feature sets and the OCR context,
    BAN's, CNN-LSTM's; the other configs serve the same models on data of
    the same format), the served folder."""
    key, sides = runs
    if key in SERVED:
        _assert_served_matches_jax_engine(key, sides, monkeypatch)
    values = {}
    for side in ("jax", "port"):
        _, meter = sides[side][0].evaluation_loop("val")
        values[side] = {k: m.global_avg for k, m in meter.meters.items()}
    assert set(values["port"]) == set(values["jax"]) and values["port"]
    for name, value in values["jax"].items():
        np.testing.assert_allclose(values["port"][name], value,
                                   rtol=VAL_RTOL, atol=1e-7, err_msg=name)
    if key.startswith("cnn_lstm"):  # Hateful Memes writes csv rows
        want, got = (_csv_rows(sides[s][1]) for s in ("jax", "port"))
        assert set(got) == set(want) == {"val", "test"}
        for split in ("val", "test"):
            assert len(got[split]) == len(want[split]) == 8
            for g, w in zip(got[split], want[split]):
                assert (g["id"], g["label"]) == (w["id"], w["label"])
                assert abs(float(g["proba"]) - float(w["proba"])) <= 1e-5
        return
    want, got = (_rows(sides[s][1]) for s in ("jax", "port"))
    assert got == want and len(got["test"]) == 8
    if key in ("lorra_vqa2", "lorra_vizwiz"):
        # some answers are copies of OCR tokens, which the answer
        # vocabulary does not hold (TextVQA's layout's OCR words are
        # answers of its vocabulary too)
        from tests.torch_vqa2_layout import _answer_words

        vocab = set(_answer_words(ANSWERS))
        assert [r for rows in got.values() for r in rows
                if r["answer"] not in vocab], "no OCR token was copied"


def _samples(key):
    """Seven requests of the config's fields (LoRRA's without
    ``context_tokens``: a list of strings is a field neither engine
    stacks, and the model reads the vectors)."""
    from mmf_tpu_torch.utils.flagship import LORRA_BAN

    _, dataset, model = LORRA_BAN[key]
    rng = np.random.RandomState(8)
    seq = 20 if dataset == "textvqa" else 14
    out = []
    for _ in range(7):
        sample = {"text": rng.randint(1, 20, seq).astype(np.int64)}
        if model == "cnn_lstm":
            sample["image"] = rng.randn(3, IMAGE, IMAGE).astype(np.float32)
            out.append(sample)
            continue
        sample["image_feature_0"] = rng.randn(REGIONS, DIM).astype(
            np.float32)
        if model == "lorra":
            if dataset == "vqa2":
                sample["image_feature_1"] = rng.randn(REGIONS, DIM).astype(
                    np.float32)
            n = int(rng.randint(0, 51))
            context = rng.randn(50, 300).astype(np.float32)
            context[n:] = 0.0
            order = np.eye(50, dtype=np.float32)
            order[n:] = 0.0
            sample.update({"context_feature_0": context,
                           "context_info_0": {"max_features": np.int64(n)},
                           "order_vectors": order})
        out.append(sample)
    return out


def _assert_served_matches_jax_engine(key, sides, monkeypatch):
    """The run's folder through both engines' ``predict_many`` at
    buckets 1, 2 and 4 (JAX cannot take LoRRA's nested ``context_info_0``
    over HTTP, as M4C's: ROADMAP C.4)."""
    from mmf_tpu_torch.serving import ServingEngine
    from mmf_tpu_torch.utils.flagship import LORRA_BAN

    model = LORRA_BAN[key][2]
    _, folder = sides["port"]
    samples = _samples(key)
    jengine = jax_engine(folder, samples, model, monkeypatch)
    with registries_restored(empty=True):
        engine = ServingEngine.from_checkpoint(folder, device="cpu",
                                               max_batch_size=4)
        assert engine.buckets == (1, 2, 4)
        for chunk in (samples[:1], samples[1:3], samples[3:6]):
            want = jengine.predict_many(chunk)
            got = engine.predict_many(chunk)
            for g, w in zip(got, want):
                assert g["scores"].shape == w["scores"].shape
                np.testing.assert_allclose(g["scores"], w["scores"],
                                           atol=2e-5, rtol=0)
