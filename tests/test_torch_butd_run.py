"""``mmf_run`` of BUTD on COCO on the CPU, against JAX's ``mmf_run``, on
the synthetic VQA2 + COCO layout (``tests/torch_vqa2_layout.py``: COCO's
captioning imdb, its vocabulary and GloVe vectors), a small model
(LSTMs 16, attention 12, words 8, 12 decode steps, 10 regions x 16), f32,
dropout 0, batch 8 (JAX's CPU mesh has 8 devices), from one JAX init
carried across by ``params_from_jax``; both CLIs in the process.

- ``projects/butd/configs/coco/defaults.yaml`` raises in both packages
  without ``flagship.BUTD_OVERRIDES``: its ``weight_decay: 0`` reaches
  ``optax.adamax``, which takes none (``TypeError``; ROADMAP C.4).
- With the override, JAX trains on no loss: its COCO dataset sets no
  ``targets`` and its model adds none, so its ``Losses`` returns nothing
  and the weights stay where they were. The port does what the
  reference does (ROADMAP C.10): the teacher-forced forward adds
  ``targets = text[:, 1:]``. With JAX's dataset given the same targets
  (padded with a 0 at the last step, which the mask leaves out), the
  losses at every update, the val loss and BLEU-4 agree within 1e-6.
- Greedy evaluation gives no ``captions``: the prediction loop raises
  ``KeyError: 'captions'`` in both packages.
- ``beam_search.yaml``: no training loss in either package (training
  under a sampling type decodes greedily, without targets); the beam
  captions' val BLEU-4 and the prediction rows equal JAX's.
- ``nucleus_sampling.yaml``: the draws cannot match across frameworks;
  BLEU-4 in range and a prediction row a sample in both.
- The beam config's folder served by ``ServingEngine.from_checkpoint``
  (``device=cpu``) at buckets 1, 2 and 4: the captions equal JAX's
  engine's on the same file.
"""

import glob
import json
import logging
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import jit_init, registries_restored, tree_map
from tests.torch_vqa2_layout import write_layout

torch.set_num_threads(2)  # several test workers share the host

# LENGTH holds every caption (4-10 words): caption_len - 1 < LENGTH, as
# MMF's 52 holds COCO's
B, REGIONS, DIM, LENGTH, UPDATES = 8, 10, 16, 12, 2
LOSS_RTOL = 1e-6
SMALL = {"classifier.params.hidden_dim": 16, "classifier.params.dropout": 0,
         "embedding_dim": 8, "image_feature_dim": DIM,
         "image_feature_embeddings": (
             "[{modal_combine: {type: top_down_attention_lstm, params: "
             "{dropout: 0, hidden_dim: 16, attention_dim: 12}}, "
             "normalization: softmax, transform: {type: linear, params: "
             "{out_dim: 1}}}]")}


@pytest.fixture(scope="module", autouse=True)
def _restore_global_state():
    """Both CLIs install logging handlers and fill their registries: the
    runs start from empty registries and everything is put back."""
    loggers = [logging.getLogger(n) for n in ("mmf_tpu", "mmf_tpu_torch",
                                               "py.warnings")]
    saved = [(lg, list(lg.handlers), lg.level, lg.propagate)
             for lg in loggers]
    with registries_restored(empty=True), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    for lg, handlers, level, propagate in saved:
        for h in lg.handlers:
            if h not in handlers:
                h.close()
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate
    logging.captureWarnings(False)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("butd_layout"))
    # 30 images: 13 val images, 65 val captions (JAX's mesh pads a short
    # batch, which the reports trim)
    write_layout(root, n_train=16, n_val=8, n_test=8, n_images=30,
                 regions=REGIONS, feature_dim=DIM, num_answers=6,
                 vocab_size=200, seed=3, coco=True, glove=True)
    return root


def vocab_size(root):
    """The COCO text processor's vocabulary (what a run registers)."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    config = Configuration(run_opts("defaults", root, "/nonexistent")
                           ).get_config()
    params = config["dataset_config"]["coco"]["processors"][
        "text_processor"]["params"]
    return registry.get_processor_class("vocab")(
        params, data_dir=os.path.join(root, "datasets")).get_vocab_size()


def run_opts(key, root, save_dir, *extra, override=True):
    from mmf_tpu_torch.utils.flagship import BUTD, BUTD_OVERRIDES

    opts = [f"config={BUTD[key]}", "model=butd", "dataset=coco",
            "training.device=cpu", f"env.save_dir={save_dir}",
            f"env.data_dir={root}", f"training.batch_size={B}",
            f"training.max_updates={UPDATES}",
            f"training.evaluation_interval={UPDATES}",
            f"training.checkpoint_interval={UPDATES}",
            "training.log_interval=1", "training.num_workers=0",
            "training.seed=4", "scheduler.params.warmup_iterations=1",
            f"dataset_config.coco.max_features={REGIONS}",
            "dataset_config.coco.processors.text_processor.params."
            f"max_length={LENGTH}"] + [
        f"dataset_config.coco.features.{split}=[coco/defaults/features/"
        f"{folder}]" for split, folder in (("train", "trainval2014"),
                                           ("val", "trainval2014"),
                                           ("test", "test2015"))] + [
        f"model_config.butd.{k}={v}" for k, v in SMALL.items()]
    if key == "defaults":
        opts.append("run_type=train_val")
    else:
        opts += ["run_type=train_val_inference", "evaluation.predict=true"]
    return opts + (BUTD_OVERRIDES if override else []) + list(extra)


def initial_weights(root, out):
    """(JAX's native checkpoint, the port's torch file) of one JAX init
    of BUTD at the run's sizes."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration
    from mmf_tpu.utils.checkpoint import _checkpointer
    from mmf_tpu.utils.env import setup_imports

    setup_imports()
    v = vocab_size(root)
    config = Configuration(run_opts(
        "defaults", root, str(out), f"model_config.butd.text_vocab_size={v}",
        f"model_config.butd.max_length={LENGTH}")).get_config()
    jm = jreg.get_model_class("butd")(config=config["model_config"]["butd"])
    rng = np.random.RandomState(5)
    batch = {"image_feature_0": jnp.asarray(rng.randn(2, REGIONS, DIM),
                                            jnp.float32),
             "text": jnp.asarray(rng.randint(0, v, (2, LENGTH)))}
    variables = jax.device_get(jit_init(jm, jax.random.PRNGKey(3), batch,
                                        False))
    jax_file = os.path.join(str(out), "init_jax")
    _checkpointer().save(jax_file, {"variables": dict(variables)})
    port_file = os.path.join(str(out), "init_port.pth")
    torch.save(params_from_jax(variables["params"]), port_file)
    return jax_file, port_file


def _clear_processors():
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry as preg

    for reg in (jreg, preg):
        state = reg.mapping["state"]
        for name in [k for k in state if k.endswith("_processor")
                     or k.endswith("_num_final_outputs")
                     or k.endswith("_text_vocab_size")]:
            del state[name]


def _jax_targets(mp):
    """JAX's COCO samples given the reference's targets (``text[1:]``,
    padded with a 0 to the scores' length)."""
    from mmf_tpu.datasets.builders.coco.dataset import COCODataset

    load_item = COCODataset.load_item

    def with_targets(self, idx):
        sample = load_item(self, idx)
        if "text" in sample:
            sample.targets = np.pad(np.asarray(sample.text)[1:], (0, 1))
        return sample

    mp.setattr(COCODataset, "load_item", with_targets)


@pytest.fixture(scope="module")
def runs(layout, tmp_path_factory):
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu_torch.cli.run import run as port_run

    def no_download(*args, **kwargs):
        raise AssertionError("the synthetic layout must count as built")

    jax_file, port_file = initial_weights(
        layout, tmp_path_factory.mktemp("butd_init"))
    sizes = (f"model_config.butd.text_vocab_size={vocab_size(layout)}",
             f"model_config.butd.max_length={LENGTH}")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_download, "download", no_download)
        for key in ("defaults", "beam_search", "nucleus_sampling"):
            dirs = {s: str(tmp_path_factory.mktemp(f"butd_{key}_{s}"))
                    for s in ("jax", "port")}
            with pytest.MonkeyPatch.context() as shim:
                if key == "defaults":
                    _jax_targets(shim)
                _clear_processors()
                jt = jax_run(run_opts(key, layout, dirs["jax"], *sizes,
                                      f"checkpoint.resume_file={jax_file}"))
            _clear_processors()
            pt = port_run(run_opts(key, layout, dirs["port"], *sizes,
                                   f"checkpoint.resume_file={port_file}"))
            out[key] = {"jax": (jt, dirs["jax"]), "port": (pt, dirs["port"])}
    yield out
    _clear_processors()


def _meters(trainer, prefix):
    return {k: list(m.averaged_value_deque)
            for k, m in trainer.meter.meters.items() if k.startswith(prefix)}


def test_defaults_losses_match_jax_given_the_targets(runs):
    jt, pt = runs["defaults"]["jax"][0], runs["defaults"]["port"][0]
    want, got = _meters(jt, "train/"), _meters(pt, "train/")
    assert set(got) == set(want) == {"train/coco/caption_cross_entropy",
                                     "train/total_loss"}
    for name, values in want.items():
        assert len(got[name]) == UPDATES and np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], values, rtol=LOSS_RTOL,
                                   err_msg=name)
    assert got["train/total_loss"][1] != got["train/total_loss"][0]


@pytest.mark.parametrize("key", ["defaults", "beam_search"])
def test_val_metrics_match_jax(runs, key):
    values = {}
    for side in ("jax", "port"):
        with pytest.MonkeyPatch.context() as shim:
            if key == "defaults" and side == "jax":
                _jax_targets(shim)
            _, meter = runs[key][side][0].evaluation_loop("val")
        values[side] = {k: m.global_avg for k, m in meter.meters.items()}
    want, got = values["jax"], values["port"]
    assert set(got) == set(want) and "val/coco/caption_bleu4" in got
    for name, value in want.items():
        assert 0.0 <= got[name] if "bleu" in name else np.isfinite(got[name])
        np.testing.assert_allclose(got[name], value, rtol=LOSS_RTOL,
                                   atol=1e-9, err_msg=name)
    if key == "beam_search":
        assert want["val/coco/dummy_loss"] == 0.0


def _rows(save_dir):
    rows = {}
    for f in sorted(glob.glob(os.path.join(save_dir, "reports", "*.json"))):
        split = "test" if "_test_" in os.path.basename(f) else "val"
        with open(f) as fh:
            rows[split] = json.load(fh)
    return rows


def test_sampling_types_train_on_no_loss_in_both(runs):
    for key in ("beam_search", "nucleus_sampling"):
        for side in ("jax", "port"):
            assert _meters(runs[key][side][0], "train/") == {}, (key, side)


def test_beam_search_rows_match_jax(runs):
    want, got = (_rows(runs["beam_search"][s][1]) for s in ("jax", "port"))
    assert set(got) == {"val", "test"} and got == want
    assert all(set(r) == {"image_id", "caption"} for r in got["test"])


def test_nucleus_sampling_rows_and_bleu(runs):
    """The draws differ across frameworks (JAX's threefry, the port's
    generator): a row a sample in both, BLEU-4 in range."""
    want, got = (_rows(runs["nucleus_sampling"][s][1])
                 for s in ("jax", "port"))
    assert {k: len(v) for k, v in got.items()} == {
        k: len(v) for k, v in want.items()}
    assert [r["image_id"] for r in got["test"]] == [
        r["image_id"] for r in want["test"]]
    pt = runs["nucleus_sampling"]["port"][0]
    _, meter = pt.evaluation_loop("val")
    assert 0.0 <= meter.meters["val/coco/caption_bleu4"].global_avg <= 1.0


def test_jax_trains_on_no_loss_without_targets(layout, tmp_path):
    """C.10: JAX's own run (no shim) logs no training loss and leaves the
    weights where they started; the port's run of the same config trains
    (``test_defaults_losses_match_jax_given_the_targets``)."""
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.cli.run import run as jax_run

    jax_file, port_file = initial_weights(layout, tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_download, "download", lambda *a, **k: None)
        _clear_processors()
        jt = jax_run(run_opts(
            "defaults", layout, str(tmp_path / "save"),
            f"model_config.butd.text_vocab_size={vocab_size(layout)}",
            f"model_config.butd.max_length={LENGTH}",
            f"checkpoint.resume_file={jax_file}", "training.max_updates=1",
            "run_type=train"))
    assert _meters(jt, "train/") == {}
    after = params_from_jax(jax.device_get(
        jt.train_state.variables["params"]))
    before = torch.load(port_file, weights_only=True)
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], before[k]) for k in before)


def test_defaults_config_raises_as_jax(layout, tmp_path):
    """Without the override, both raise the same TypeError before the
    first update: optax.adamax takes no weight_decay."""
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.cli.run import run as jax_run
    from mmf_tpu_torch.cli.run import run as port_run

    errors = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_download, "download", lambda *a, **k: None)
        for run in (jax_run, port_run):
            _clear_processors()
            with pytest.raises(TypeError) as info:
                run(run_opts("defaults", layout, str(tmp_path),
                             override=False))
            errors.append(str(info.value))
    assert errors[0] == errors[1] == (
        "adamax() got an unexpected keyword argument 'weight_decay'")


def test_greedy_predictions_raise_as_jax(runs):
    """The defaults' greedy evaluation returns scores, no captions: the
    COCO dataset's prediction rows read ``captions``."""
    for side in ("jax", "port"):
        trainer = runs["defaults"][side][0]
        with pytest.raises(KeyError, match="captions"):
            trainer.prediction_loop("test")


def _jax_params(template, state, leaves=None):
    """The port's state_dict as a flax params tree shaped like
    ``template`` (the inverse of ``params_from_jax``); ``leaves`` maps
    the leaf names (a ``batch_stats`` tree's ``mean`` and ``var``)."""
    from mmf_tpu_torch.utils.checkpoint_updater import _LEAF, _VERBATIM

    leaves = leaves or _LEAF

    def walk(tree, path):
        out = {}
        for name, value in tree.items():
            here = path + (name,)
            if isinstance(value, dict):
                out[name] = walk(value, here)
                continue
            verbatim = name.endswith("/kernel/scale") or name in _VERBATIM
            key = ".".join(here if verbatim else here[:-1] + (leaves[name],))
            arr = state[key].numpy()
            if name == "kernel" and arr.ndim == 2:
                arr = arr.T
            elif name == "kernel" and arr.ndim == 4:  # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            assert arr.shape == value.shape, (key, arr.shape, value.shape)
            out[name] = arr
        return out

    return walk(template, ())


def jax_engine(folder, samples, model, monkeypatch, max_batch_size=4):
    """JAX's ``ServingEngine.from_checkpoint`` over the port's folder."""
    from mmf_tpu.models.base_model import build_model
    from mmf_tpu.serving.engine import ServingEngine as JaxEngine
    from mmf_tpu.serving.engine import _stack_samples
    from mmf_tpu.utils import checkpoint as jax_checkpoint
    from mmf_tpu.utils.env import setup_imports

    setup_imports()
    load = jax_checkpoint.load_pretrained_model

    def adapted(path, *args, **kwargs):
        items = load(path, *args, **kwargs)
        jm = build_model(dict(items["config"]))
        batch = tree_map(jnp.asarray, _stack_samples(samples[:1]))
        template = jax.eval_shape(
            lambda b: jm.init(jax.random.PRNGKey(0), b, False), batch)
        state = torch.load(os.path.join(folder, f"{model}_final.pth"),
                           weights_only=True)
        template = jax.device_get(template)
        variables = {"params": _jax_params(template["params"], state)}
        if "batch_stats" in template:
            from mmf_tpu_torch.utils.checkpoint_updater import _STATS

            variables["batch_stats"] = _jax_params(
                template["batch_stats"], state, _STATS)
        return dict(items, checkpoint={"variables": variables})

    monkeypatch.setattr(jax_checkpoint, "load_pretrained_model", adapted)
    with registries_restored(empty=True):
        return JaxEngine.from_checkpoint(folder,
                                         max_batch_size=max_batch_size)


def test_served_beam_search_matches_jax_engine(runs, layout, monkeypatch):
    """A served BUTD builds its vocabulary from the config's
    ``text_vocab_size`` and its length from ``max_length`` (no dataset
    registers a processor outside a run, in JAX too): the run set both
    to the layout's. Its requests are the regions alone."""
    from mmf_tpu_torch.serving import ServingEngine

    pt, folder = runs["beam_search"]["port"]
    rng = np.random.RandomState(7)
    samples = [{"image_feature_0": rng.randn(REGIONS, DIM).astype(
        np.float32)} for _ in range(7)]
    jengine = jax_engine(folder, samples, "butd", monkeypatch)
    with registries_restored(empty=True):
        engine = ServingEngine.from_checkpoint(folder, device="cpu",
                                               max_batch_size=4)
        assert engine.buckets == (1, 2, 4)
        for chunk in (samples[:1], samples[1:3], samples[3:6]):
            want = jengine.predict_many(chunk)
            got = engine.predict_many(chunk)
            for g, w in zip(got, want):
                assert set(g) == {"captions", "losses"}
                np.testing.assert_array_equal(g["captions"], w["captions"])
                assert g["captions"].shape == (LENGTH,)
