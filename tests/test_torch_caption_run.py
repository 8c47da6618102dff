"""``mmf_run`` of Pythia on VQA2 and of the M4C captioner trained jointly
on TextCaps and COCO, on the CPU, against JAX's ``mmf_run``; serving
Pythia; the COCO configs of the M4C captioner.

- Pythia (``projects/pythia/configs/vqa2/defaults.yaml``, text LSTM 16,
  combine 20, classifier 24 / 12, 10 regions x 16, f32) on the synthetic
  VQA2 layout (``tests/torch_vqa2_layout.py`` with GloVe's files for the
  ``vocab`` text processor), batch 8, 2 updates of the config's Adamax
  and warmup schedule, from one JAX init: the losses at every update
  within 1e-6 relative, the val loss within 1e-5 and ``vqa_accuracy``
  equal, the prediction rows equal. The run's folder served by
  ``ServingEngine.from_checkpoint`` (``device=cpu``) at buckets 1, 2
  and 4 within 2e-5 of JAX's engine on the same file (the run sets
  ``text_vocab_size`` and ``num_labels``, which a served model reads: no
  dataset registers them outside a run, in JAX too).
- ``joint_with_coco.yaml`` (``flagship.M4C_FAMILY["joint_coco"]``, with
  its overrides, in JAX too: ROADMAP C.4) on
  ``tests/torch_textvqa_layout.py::write_joint_coco_layout``, the small
  M4C of ``tests/test_torch_m4c_family_run.py``: the losses within 1e-6
  relative, the val metrics within 1e-6, the caption rows equal.
- ``m4c_captioner/coco/defaults.yaml`` and ``eval_on_textcaps.yaml``: the
  COCO dataset hands the collator each image's raw features info (its
  ``return_features_info: true``), whose boxes differ in number between
  images: the same ``AssertionError`` at the first batch in both
  packages (ROADMAP C.4).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.test_torch_butd_run import jax_engine
from tests.test_torch_m4c_family_run import (
    _clear_processors,
    _restore_global_state,  # noqa: F401 (the module's autouse fixture)
    small,
)
from tests.torch_port_utils import jit_init, registries_restored, tree_map
from tests.torch_textvqa_layout import layout_opts as m4c_layout_opts
from tests.torch_textvqa_layout import write_joint_coco_layout
from tests.torch_vqa2_layout import write_layout

torch.set_num_threads(2)  # several test workers share the host

B, REGIONS, DIM, ANSWERS, UPDATES = 8, 10, 16, 6, 2
M4C_ANSWERS = 60
LOSS_RTOL, VAL_RTOL = 1e-6, 1e-5
COMBINE = ("{type: non_linear_element_multiply, params: {dropout: 0, "
           "hidden_dim: 20}}")
PYTHIA_SMALL = {
    "image_feature_dim": DIM, "num_labels": ANSWERS,
    "classifier.params.img_hidden_dim": 24,
    "classifier.params.text_hidden_dim": 12,
    "image_text_modal_combine": COMBINE,
    "image_feature_embeddings": (
        f"[{{modal_combine: {COMBINE}, normalization: softmax, transform: "
        "{type: linear, params: {out_dim: 1}}}]"),
    "text_embeddings": (
        "[{type: attention, params: {hidden_dim: 16, num_layers: 1, "
        "conv1_out: 8, conv2_out: 2, dropout: 0, embedding_dim: 300, "
        "kernel_size: 1, padding: 0}}]"),
}


def _no_download(mp):
    import mmf_tpu.utils.download as jax_download

    def no_download(*args, **kwargs):
        raise AssertionError("the synthetic layout must count as built")

    mp.setattr(jax_download, "download", no_download)


def pythia_vocab(root):
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    config = Configuration(pythia_opts(root, "/nonexistent")).get_config()
    params = config["dataset_config"]["vqa2"]["processors"][
        "text_processor"]["params"]
    return registry.get_processor_class("vocab")(
        params, data_dir=os.path.join(root, "datasets")).get_vocab_size()


def pythia_opts(root, save_dir, *extra):
    from mmf_tpu_torch.utils.flagship import PYTHIA_VQA2_CONFIG

    return [f"config={PYTHIA_VQA2_CONFIG}", "model=pythia", "dataset=vqa2",
            "training.device=cpu", f"env.save_dir={save_dir}",
            f"env.data_dir={root}", f"training.batch_size={B}",
            f"training.max_updates={UPDATES}",
            f"training.evaluation_interval={UPDATES}",
            f"training.checkpoint_interval={UPDATES}",
            "training.log_interval=1", "training.num_workers=0",
            "training.seed=4", "training.warmup_iterations=1",
            "run_type=train_val_inference", "evaluation.predict=true",
            f"dataset_config.vqa2.max_features={REGIONS}"] + [
        f"dataset_config.vqa2.features.{split}=[coco/defaults/features/"
        f"{folder}]" for split, folder in (("train", "trainval2014"),
                                           ("val", "trainval2014"),
                                           ("test", "test2015"))] + [
        f"model_config.pythia.{k}={v}" for k, v in PYTHIA_SMALL.items()
    ] + list(extra)


@pytest.fixture(scope="module")
def pythia_runs(tmp_path_factory):
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu.utils.env import setup_imports
    from mmf_tpu_torch.cli.run import run as port_run

    root = str(tmp_path_factory.mktemp("pythia_layout"))
    write_layout(root, n_train=16, n_val=8, n_test=8, n_images=30,
                 regions=REGIONS, feature_dim=DIM, num_answers=ANSWERS,
                 vocab_size=200, seed=3, glove=True)
    sizes = (f"model_config.pythia.text_vocab_size={pythia_vocab(root)}",)
    out = str(tmp_path_factory.mktemp("pythia_init"))
    setup_imports()
    config = Configuration(pythia_opts(root, out, *sizes)).get_config()
    jm = jreg.get_model_class("pythia")(config=config["model_config"][
        "pythia"])
    rng = np.random.RandomState(5)
    variables = jax.device_get(jit_init(jm, jax.random.PRNGKey(3), {
        "text": jnp.asarray(rng.randint(1, 20, (2, 14))),
        "image_feature_0": jnp.asarray(rng.randn(2, REGIONS, DIM),
                                       jnp.float32)}, False))
    jax_file = os.path.join(out, "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = os.path.join(out, "init_port.pth")
    torch.save(params_from_jax(variables["params"]), port_file)
    dirs = {s: str(tmp_path_factory.mktemp(f"pythia_{s}"))
            for s in ("jax", "port")}
    with pytest.MonkeyPatch.context() as mp:
        _no_download(mp)
        _clear_processors()
        jt = jax_run(pythia_opts(root, dirs["jax"], *sizes,
                                 f"checkpoint.resume_file={jax_file}"))
    _clear_processors()
    pt = port_run(pythia_opts(root, dirs["port"], *sizes,
                              f"checkpoint.resume_file={port_file}"))
    yield {"jax": (jt, dirs["jax"]), "port": (pt, dirs["port"])}
    _clear_processors()


def _meters(trainer, prefix):
    return {k: list(m.averaged_value_deque)
            for k, m in trainer.meter.meters.items() if k.startswith(prefix)}


def _rows(save_dir):
    rows = {}
    for f in sorted(glob.glob(os.path.join(save_dir, "reports", "*.json"))):
        split = "test" if "_test_" in os.path.basename(f) else "val"
        with open(f) as fh:
            rows[split] = json.load(fh)
    return rows


def _assert_losses_match(jt, pt, names):
    want, got = _meters(jt, "train/"), _meters(pt, "train/")
    assert set(got) == set(want) == set(names) | {"train/total_loss"}
    for name, values in want.items():
        assert len(got[name]) == UPDATES and np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], values, rtol=LOSS_RTOL,
                                   err_msg=name)


def test_pythia_losses_match_jax(pythia_runs):
    _assert_losses_match(pythia_runs["jax"][0], pythia_runs["port"][0],
                         {"train/vqa2/logit_bce"})


def test_pythia_val_and_predictions_match_jax(pythia_runs):
    values = {}
    for side in ("jax", "port"):
        _, meter = pythia_runs[side][0].evaluation_loop("val")
        values[side] = {k: m.global_avg for k, m in meter.meters.items()}
    assert set(values["port"]) == set(values["jax"])
    for name, value in values["jax"].items():
        if "accuracy" in name:
            assert values["port"][name] == value
        else:
            np.testing.assert_allclose(values["port"][name], value,
                                       rtol=VAL_RTOL, err_msg=name)
    want, got = (_rows(pythia_runs[s][1]) for s in ("jax", "port"))
    assert got == want and len(got["test"]) == 8
    assert set(got["test"][0]) == {"question_id", "answer"}


def test_served_pythia_matches_jax_engine(pythia_runs, monkeypatch):
    from mmf_tpu_torch.serving import ServingEngine

    _, folder = pythia_runs["port"]
    rng = np.random.RandomState(8)
    samples = [{"text": rng.randint(1, 20, 14).astype(np.int64),
                "image_feature_0": rng.randn(REGIONS, DIM).astype(
                    np.float32)} for _ in range(7)]
    jengine = jax_engine(folder, samples, "pythia", monkeypatch)
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


def joint_opts(root, save_dir, *extra):
    from mmf_tpu_torch.utils.flagship import (
        M4C_FAMILY,
        M4C_FAMILY_OVERRIDES,
    )

    path, datasets, model = M4C_FAMILY["joint_coco"]
    return [
        f"config={path}", f"model={model}", f"datasets={datasets}",
        "training.device=cpu", f"env.save_dir={save_dir}",
        f"training.batch_size={B}", f"training.max_updates={UPDATES}",
        f"training.evaluation_interval={UPDATES}",
        f"training.checkpoint_interval={UPDATES}",
        "training.log_interval=1", "training.num_workers=0",
        "training.seed=1", "optimizer.params.lr=1e-3",
        "training.warmup_iterations=1", "training.lr_steps=[3]",
        "run_type=train_val_inference", "evaluation.predict=true",
    ] + small(model) + M4C_FAMILY_OVERRIDES["joint_coco"] + \
        m4c_layout_opts(root, datasets) + list(extra)


@pytest.fixture(scope="module")
def joint_runs(tmp_path_factory):
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu.utils.env import setup_imports
    from mmf_tpu_torch.cli.run import run as port_run
    from mmf_tpu_torch.utils.flagship import textvqa_m4c_batch

    root = str(tmp_path_factory.mktemp("joint_layout"))
    write_joint_coco_layout(root, n_train=16, n_val=8, n_test=8,
                            n_images=10, coco_images=10, max_obj=10,
                            max_ocr=8, num_answers=M4C_ANSWERS,
                            vocab_size=200, seed=2)
    out = str(tmp_path_factory.mktemp("joint_init"))
    setup_imports()
    config = Configuration(joint_opts("/nonexistent", out)).get_config()
    with registries_restored():
        jreg.register("config", config)
        jreg.register("textcaps_num_final_outputs", M4C_ANSWERS + 50)
        jm = jreg.get_model_class("m4c_captioner")(
            config=config["model_config"]["m4c_captioner"])
        batch = tree_map(jnp.asarray, textvqa_m4c_batch(
            2, text_bert_vocab=200))
        variables = jax.device_get(jax.jit(lambda b: jm.init(
            jax.random.PRNGKey(3), b, False))(batch))
    jax_file = os.path.join(out, "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = os.path.join(out, "init_port.pth")
    torch.save(params_from_jax(variables["params"]), port_file)
    dirs = {s: str(tmp_path_factory.mktemp(f"joint_{s}"))
            for s in ("jax", "port")}
    val = {}
    with pytest.MonkeyPatch.context() as mp:
        _no_download(mp)
        _clear_processors()
        jt = jax_run(joint_opts(root, dirs["jax"],
                                f"checkpoint.resume_file={jax_file}"))
        # the metric reads the answer processor the run registered
        val["jax"] = _val(jt)
    _clear_processors()
    pt = port_run(joint_opts(root, dirs["port"],
                             f"checkpoint.resume_file={port_file}"))
    val["port"] = _val(pt)
    yield {"jax": (jt, dirs["jax"]), "port": (pt, dirs["port"]),
           "root": root, "val": val}
    _clear_processors()


def test_joint_coco_losses_match_jax(joint_runs):
    _assert_losses_match(joint_runs["jax"][0], joint_runs["port"][0],
                         {"train/textcaps/m4c_decoding_bce_with_mask"})
    # the train split holds TextCaps' 32 tiles and COCO's captions
    pt = joint_runs["port"][0]
    train = pt.dataset_loader.datamodules["textcaps"].train_dataset
    assert len(train.datasets) == 33


def _val(trainer):
    _, meter = trainer.evaluation_loop("val")
    return {k: m.global_avg for k, m in meter.meters.items()}


def test_joint_coco_val_and_rows_match_jax(joint_runs):
    values = joint_runs["val"]
    assert set(values["port"]) == set(values["jax"]) and \
        "val/textcaps/textcaps_bleu4" in values["port"]
    for name, value in values["jax"].items():
        np.testing.assert_allclose(values["port"][name], value,
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=name)
    want, got = (_rows(joint_runs[s][1]) for s in ("jax", "port"))
    assert got == want and len(got["val"]) == 8
    assert set(got["val"][0]) == {"caption_id", "image_id", "caption",
                                  "pred_source"}


@pytest.mark.parametrize("config", ["defaults", "eval_on_textcaps"])
def test_coco_m4c_configs_raise_as_jax(joint_runs, config, tmp_path):
    """JAX's COCO dataset never calls VQA2's OCR branch and hands the
    collator each image's raw features info: boxes of different counts
    cannot stack. The port raises the same at the same place."""
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu_torch.cli.run import run as port_run

    root = joint_runs["root"]
    opts = [f"config=projects/m4c_captioner/configs/m4c_captioner/coco/"
            f"{config}.yaml", "model=m4c_captioner", "datasets=coco",
            "training.device=cpu", f"env.save_dir={tmp_path}",
            f"training.batch_size={B}", "training.max_updates=1",
            "training.num_workers=0", "run_type=train"] + \
        small("m4c_captioner") + m4c_layout_opts(root, "coco")
    errors = []
    with pytest.MonkeyPatch.context() as mp:
        _no_download(mp)
        for run in (jax_run, port_run):
            _clear_processors()
            with pytest.raises(AssertionError) as info:
                run(opts)
            errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("Fields for all samples must be equally "
                                "sized. bbox is of different sizes")
