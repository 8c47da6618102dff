"""``mmf_run`` of mmf_bert (VQA2 finetuning and masked-VQA2 pretraining),
Pythia's ``multihead`` on VQA2 and Pythia on Visual Genome, on the CPU,
against JAX's ``mmf_run``; serving their checkpoints.

Each config of ``flagship.PYTHIA2`` with its ``PYTHIA2_OVERRIDES`` (in
JAX too: ROADMAP C.4) runs at small widths (mmf_bert 32 wide with 4
heads, dropout 0; Pythia's text LSTM 16, combine 20, classifier 24 / 12,
multihead's 32-wide question over 2 heads) on the synthetic VQA2 layout
(``tests/torch_vqa2_layout.py``, full boxes, GloVe's files, the Visual
Genome copy), batch 8, 2 updates (the schedules' warmup cut to one
step), from one JAX init:

- the train losses at every update within 1e-6 relative (the masked
  LM's on the same seeded masks);
- the val losses within 1e-5 (the masked LM's on the same seeded masks)
  and ``vqa_accuracy`` equal, the prediction rows equal (the VQA
  configs);
- the run's folder of mmf_bert's VQA2, multihead's and Pythia's on
  Visual Genome served by ``ServingEngine.from_checkpoint``
  (``device=cpu``) at buckets 1, 2 and 4 within 2e-5 of JAX's engine on
  the same file; the pretraining run's final weights through both
  models on one masked batch.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.test_torch_butd_run import jax_engine
from tests.test_torch_caption_run import (
    PYTHIA_SMALL,
    _meters,
    _no_download,
    _rows,
    pythia_vocab,
)
from tests.test_torch_m4c_family_run import (
    _clear_processors,
    _restore_global_state,  # noqa: F401 (the module's autouse fixture)
)
from tests.torch_port_utils import jit_init, registries_restored, tree_map
from tests.torch_vqa2_layout import layout_opts, write_layout

torch.set_num_threads(2)  # several test workers share the host

B, REGIONS, DIM, ANSWERS, UPDATES, SEQ = 8, 10, 16, 6, 2, 14
LOSS_RTOL, VAL_RTOL = 1e-6, 1e-5
_ATT = "{embed_dim: 32, num_heads: 4, dropout: 0}"
BERT_SMALL = {
    "hidden_size": 32, "vocab_size": 200, "num_labels": ANSWERS,
    "image_feature_dim": DIM, "hidden_dropout_prob": 0,
    "text_embeddings": f"[{_ATT}]",
    "image_feature_embeddings": f"[{_ATT}]",
    "image_feature_attentions": f"[{_ATT}]",
    "image_feature_projection": "{module: linear, in_dim: 2048, out_dim: 32}",
    "image_text_modal_combine": ("{type: non_linear_element_multiply, "
                                 "params: {dropout: 0, hidden_dim: 32}}"),
}
# multihead: the 32-wide question attends over the regions in 2 heads
MULTIHEAD_SMALL = dict(PYTHIA_SMALL, image_feature_embeddings=(
    "[{num_heads: 2, modal_combine: {type: non_linear_element_multiply, "
    "params: {dropout: 0, hidden_dim: 20}}, normalization: softmax, "
    "transform: {type: linear, params: {out_dim: 1}}}]"))
KEYS = ("mmf_bert_vqa2", "mmf_bert_masked_vqa2", "multihead",
        "pythia_visual_genome")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pythia2_layout"))
    write_layout(root, n_train=16, n_val=8, n_test=8, n_images=30,
                 regions=REGIONS, feature_dim=DIM, num_answers=ANSWERS,
                 vocab_size=200, seed=3, full_boxes=True, glove=True,
                 visual_genome=True)
    return root


def _opts(key, root, save_dir, *extra):
    from mmf_tpu_torch.utils.flagship import PYTHIA2, PYTHIA2_OVERRIDES

    path, dataset, model = PYTHIA2[key]
    opts = [f"config={path}", f"model={model}", f"dataset={dataset}",
            "training.device=cpu", f"env.save_dir={save_dir}",
            f"training.batch_size={B}", f"training.max_updates={UPDATES}",
            f"training.evaluation_interval={UPDATES}",
            f"training.checkpoint_interval={UPDATES}",
            "training.log_interval=1", "training.num_workers=0",
            "training.seed=1", "run_type=train_val_inference",
            "evaluation.predict=true"] + PYTHIA2_OVERRIDES[key]
    if model == "mmf_bert":
        opts += ["scheduler.params.num_warmup_steps=1"] + [
            f"model_config.mmf_bert.{k}={v}" for k, v in BERT_SMALL.items()]
        if key == "mmf_bert_vqa2":
            opts += layout_opts(root)
        else:  # nothing to predict in pretraining
            opts = [o for o in opts if not o.startswith(
                ("run_type", "evaluation.predict"))] + [
                "run_type=train_val"] + layout_opts(
                    root, "masked_vqa2", "masked_token_processor")
    else:
        small = MULTIHEAD_SMALL if model == "multihead" else PYTHIA_SMALL
        opts += ["training.warmup_iterations=1",
                 f"dataset_config.{dataset}.max_features={REGIONS}",
                 f"env.data_dir={root}",
                 f"model_config.{model}.text_vocab_size={pythia_vocab(root)}"
                 ] + [f"dataset_config.{dataset}.features.{split}=[coco/"
                      f"defaults/features/{folder}]"
                      for split, folder in (("train", "trainval2014"),
                                            ("val", "trainval2014"),
                                            ("test", "test2015"))] + [
            f"model_config.{model}.{k}={v}" for k, v in small.items()]
    return opts + list(extra)


def _init_batch(model):
    rng = np.random.RandomState(5)
    feats = rng.randn(2, REGIONS, DIM).astype(np.float32)
    if model != "mmf_bert":
        return {"text": rng.randint(1, 20, (2, SEQ)),
                "image_feature_0": feats}
    ids = rng.randint(1, 200, (2, SEQ))
    return {"input_ids": ids, "input_mask": np.ones_like(ids),
            "segment_ids": np.zeros_like(ids), "image_feature_0": feats}


@pytest.fixture(scope="module", params=KEYS)
def runs(request, layout, tmp_path_factory):
    """key -> JAX's and the port's runs (trainer, folder) from one JAX
    init."""
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu.utils.env import setup_imports
    from mmf_tpu_torch.cli.run import run as port_run
    from mmf_tpu_torch.utils.flagship import PYTHIA2

    key = request.param
    model = PYTHIA2[key][2]
    out = str(tmp_path_factory.mktemp(f"{key}_init"))
    setup_imports()
    config = Configuration(_opts(key, layout, out)).get_config()
    with registries_restored():
        jreg.register("config", config)
        jm = jreg.get_model_class(model)(
            config=config["model_config"][model])
        variables = jax.device_get(jit_init(
            jm, jax.random.PRNGKey(3),
            tree_map(jnp.asarray, _init_batch(model)),
            False))
    jax_file = os.path.join(out, "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = os.path.join(out, "init_port.pth")
    torch.save(params_from_jax(variables["params"]), port_file)
    dirs = {s: str(tmp_path_factory.mktemp(f"{key}_{s}"))
            for s in ("jax", "port")}
    with pytest.MonkeyPatch.context() as mp:
        _no_download(mp)
        _clear_processors()
        jt = jax_run(_opts(key, layout, dirs["jax"],
                           f"checkpoint.resume_file={jax_file}"))
    _clear_processors()
    pt = port_run(_opts(key, layout, dirs["port"],
                        f"checkpoint.resume_file={port_file}"))
    yield key, {"jax": (jt, dirs["jax"]), "port": (pt, dirs["port"])}
    _clear_processors()


def test_losses_match_jax(runs):
    key, sides = runs
    want, got = (_meters(sides[s][0], "") for s in ("jax", "port"))
    names = {k for k in want if "train" in k and "total" not in k}
    expected = {
        "mmf_bert_vqa2": {"train/vqa2/logit_bce"},
        "mmf_bert_masked_vqa2": {"masked_vqa2/train/masked_lm_loss",
                                 "masked_vqa2/train/next_sentence_loss"},
        "multihead": {"train/vqa2/logit_bce"},
        "pythia_visual_genome": {"train/visual_genome/logit_bce"}}[key]
    assert names == expected and set(got) == set(want)
    for name in names:
        assert len(got[name]) == UPDATES and np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want[name], rtol=LOSS_RTOL,
                                   err_msg=name)
    assert len(set(np.round(got[sorted(names)[0]], 7))) > 1 or \
        key == "mmf_bert_masked_vqa2"  # the weights moved


def test_val_and_predictions_match_jax(runs):
    key, sides = runs
    values = {}
    for side in ("jax", "port"):
        # the masked LM draws its masks from Python's and numpy's
        # generators: the same state on both sides
        random.seed(0)
        np.random.seed(0)
        _, meter = sides[side][0].evaluation_loop("val")
        values[side] = {k: m.global_avg for k, m in meter.meters.items()}
    assert set(values["port"]) == set(values["jax"]) and values["port"]
    for name, value in values["jax"].items():
        if "accuracy" in name:
            assert values["port"][name] == value
        else:
            np.testing.assert_allclose(values["port"][name], value,
                                       rtol=VAL_RTOL, err_msg=name)
    if key != "mmf_bert_masked_vqa2":
        want, got = (_rows(sides[s][1]) for s in ("jax", "port"))
        assert got == want and len(got["test"]) == 8
        assert set(got["test"][0]) == {"question_id", "answer"}


def _samples(model):
    rng = np.random.RandomState(8)
    out = []
    for _ in range(7):
        feats = rng.randn(REGIONS, DIM).astype(np.float32)
        if model == "mmf_bert":
            n = int(rng.randint(4, SEQ + 1))
            ids = np.zeros(SEQ, np.int64)
            ids[:n] = rng.randint(1, 200, n)
            out.append({"input_ids": ids,
                        "input_mask": (ids > 0).astype(np.int64),
                        "segment_ids": np.zeros(SEQ, np.int64),
                        "image_feature_0": feats})
        else:
            out.append({"text": rng.randint(1, 20, SEQ).astype(np.int64),
                        "image_feature_0": feats})
    return out


def test_served_model_matches_jax_engine(runs, monkeypatch):
    """The finetuned folders (mmf_bert's VQA2 run, multihead's, Pythia's
    on Visual Genome) through both engines. The pretraining run's final
    weights, which no engine serves (its head scores the vocabulary),
    through JAX's model and the port's on one masked batch: the logits
    and the next-sentence scores within 2e-5."""
    from mmf_tpu_torch.serving import ServingEngine
    from mmf_tpu_torch.utils.flagship import PYTHIA2

    key, sides = runs
    model = PYTHIA2[key][2]
    _, folder = sides["port"]
    samples = _samples(model)
    if key == "mmf_bert_masked_vqa2":
        _assert_pretraining_forward_matches_jax(sides["port"][0], folder,
                                                samples)
        return
    jengine = jax_engine(folder, samples, model, monkeypatch)
    with registries_restored(empty=True):
        engine = ServingEngine.from_checkpoint(folder, device="cpu",
                                               max_batch_size=4)
        assert engine.buckets == (1, 2, 4)
        for chunk in (samples[:1], samples[1:3], samples[3:6]):
            want = jengine.predict_many(chunk)
            got = engine.predict_many(chunk)
            for g, w in zip(got, want):
                assert g["scores"].shape == (ANSWERS,)
                np.testing.assert_allclose(g["scores"], w["scores"],
                                           atol=2e-5, rtol=0)


def _assert_pretraining_forward_matches_jax(trainer, folder, samples):
    from mmf_tpu.common.registry import registry as jreg
    from tests.test_torch_butd_run import _jax_params

    state = torch.load(os.path.join(folder, "mmf_bert_final.pth"),
                       weights_only=True)
    batch = {k: np.stack([s[k] for s in samples[:4]]) for k in samples[0]}
    batch["lm_label_ids"] = np.where(batch["input_mask"] == 1,
                                     batch["input_ids"], -1)
    batch["is_correct"] = np.array([0, 1, 1, 0])
    jm = jreg.get_model_class("mmf_bert")(
        config=trainer.config["model_config"]["mmf_bert"])
    template = jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, False), tree_map(jnp.asarray, batch))
    params = _jax_params(jax.device_get(template)["params"], state)
    want = jm.apply({"params": params}, tree_map(jnp.asarray, batch), False)
    pm = trainer.model.cpu().eval()
    pm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = pm(tree_map(torch.from_numpy, batch))
    for name in ("logits", "seq_relationship_score"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=2e-5, rtol=0, err_msg=name)
    for name, value in want["losses"].items():
        np.testing.assert_allclose(float(got["losses"][name]), float(value),
                                   rtol=1e-6, err_msg=name)
