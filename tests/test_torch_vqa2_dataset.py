"""The synthetic VQA2 layout through JAX's and the port's builder,
dataset and loader: every field of every sample equal, each epoch's
batches equal and in the same order (the port's worker processes
included, and stopped by teardown), and the eval tail padded and
trimmed as JAX does it."""

import multiprocessing
import time

import numpy as np
import pytest
import torch

from tests.torch_port_utils import registries_restored
from tests.torch_vqa2_layout import layout_opts, write_layout

REGIONS, DIM, ANSWERS = 10, 16, 6
N_TRAIN, N_VAL, N_TEST, BATCH = 20, 12, 6, 8


@pytest.fixture(autouse=True)
def _restore_registries():
    """The datasets cache their processors in both registries (JAX's
    too): put both back, so that no later file's dataset reuses them."""
    with registries_restored():
        yield


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vqa2_layout"))
    write_layout(root, n_train=N_TRAIN, n_val=N_VAL, n_test=N_TEST,
                 n_images=10, regions=REGIONS, feature_dim=DIM,
                 num_answers=ANSWERS, vocab_size=64, seed=1)
    return root


def _opts(layout, num_workers=0, info=False):
    """The VQA2 config on the layout; ``info`` adds the features' side
    files to the samples (their boxes are ragged, so they do not batch:
    VQA2's config leaves them out)."""
    return [
        "config=projects/visual_bert/configs/vqa2/defaults.yaml",
        "model=visual_bert", "datasets=vqa2", "training.device=cpu",
        f"training.batch_size={BATCH}", f"training.num_workers={num_workers}",
        f"dataset_config.vqa2.max_features={REGIONS}",
        f"dataset_config.vqa2.return_features_info={str(info).lower()}",
        "dataset_config.vqa2.processors.text_processor.params."
        "max_seq_length=16",
    ] + layout_opts(layout)


def _datamodules(layout, num_workers=0, info=False):
    """JAX's and the port's MultiDataModule over the layout (JAX's
    download made to raise: the layout must count as built)."""
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.common.registry import registry as jax_registry
    from mmf_tpu.config.configuration import Configuration as JaxConfig
    from mmf_tpu.datasets.multi_datamodule import MultiDataModule as JaxDM
    from mmf_tpu.utils.env import setup_imports as jax_setup_imports
    from mmf_tpu_torch.common.registry import registry as port_registry
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.datasets.multi_datamodule import MultiDataModule
    from mmf_tpu_torch.utils.env import setup_imports

    def no_download(*args, **kwargs):
        raise AssertionError("the synthetic layout must count as built")

    jax_setup_imports()
    setup_imports()
    jax_config = JaxConfig(_opts(layout, 0, info)).get_config()
    jax_registry.register("config", jax_config)
    original = jax_download.download
    jax_download.download = no_download
    try:
        jax_dm = JaxDM(jax_config)
    finally:
        jax_download.download = original
    config = Configuration(_opts(layout, num_workers, info)).get_config()
    # the loaders read the batch size from the registered config
    port_registry.register("config", config)
    return jax_dm, MultiDataModule(config)


def _assert_equal(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _assert_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(
            want, "__array__"):
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = np.asarray(want)
        np.testing.assert_array_equal(g, w, err_msg=where)
        assert g.dtype == w.dtype, (where, g.dtype, w.dtype)
    else:
        assert got == want, where


def test_every_sample_equals_jax(layout):
    jax_dm, port_dm = _datamodules(layout, info=True)
    for split, n in (("train", N_TRAIN), ("val", N_VAL), ("test", N_TEST)):
        jax_ds = getattr(jax_dm.datamodules["vqa2"], f"{split}_dataset")
        port_ds = getattr(port_dm.datamodules["vqa2"], f"{split}_dataset")
        assert len(port_ds) == len(jax_ds) == n
        for i in range(n):
            got, want = port_ds[i], jax_ds[i]
            _assert_equal(got, want, f"{split}[{i}]")
        assert ("targets" in got) == (split != "test")
    assert got["image_feature_0"].shape == (REGIONS, DIM)
    assert set(got["image_info_0"]) >= {"bbox", "num_boxes", "max_features",
                                        "image_height", "image_width"}
    assert got["input_ids"].shape == (16,)


def _batches(loader, epoch=None):
    if epoch is not None:
        loader.seed_sampler(epoch)
    return list(loader)


def _assert_batches_equal(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches)
    for b, (got, want) in enumerate(zip(port_batches, jax_batches)):
        assert set(got.fields()) == set(want.fields())
        _assert_equal(got.pytree(), want.pytree(), f"batch {b}")
        _assert_equal(got.meta(), want.meta(), f"batch {b} meta")
        assert getattr(got, "_true_batch_size", None) == getattr(
            want, "_true_batch_size", None)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_batches_and_their_order_equal_jax(layout, num_workers):
    children = set(multiprocessing.active_children())
    jax_dm, port_dm = _datamodules(layout, num_workers)
    jax_train = jax_dm.train_dataloader()
    port_train = port_dm.train_dataloader()
    # 20 questions, batch 8: two full batches an epoch, the tail dropped
    assert len(port_train) == len(jax_train) == 2
    orders = []
    for epoch in (1, 2):
        port_batches = _batches(port_train, epoch)
        _assert_batches_equal(port_batches, _batches(jax_train, epoch))
        orders.append([int(q) for b in port_batches for q in b.question_id])
    assert orders[0] != orders[1]

    # eval: 12 questions = a full batch and one padded from 4 to 8
    port_val = _batches(port_dm.val_dataloader())
    _assert_batches_equal(port_val, _batches(jax_dm.val_dataloader()))
    assert [b.get_batch_size() for b in port_val] == [BATCH, BATCH]
    assert getattr(port_val[1], "_true_batch_size", None) == N_VAL - BATCH
    _assert_batches_equal(_batches(port_dm.test_dataloader()),
                          _batches(jax_dm.test_dataloader()))

    # teardown stops the persistent workers at once, a half-read epoch's
    # included
    port_train.seed_sampler(3)
    next(iter(port_train))
    started = time.perf_counter()
    port_dm.teardown()
    assert time.perf_counter() - started < 3.0
    assert set(multiprocessing.active_children()) <= children


def test_eval_tail_trims_as_jax(layout):
    from mmf_tpu.common.report import Report as JaxReport
    from mmf_tpu_torch.common.report import Report

    jax_dm, port_dm = _datamodules(layout)
    port_tail = _batches(port_dm.val_dataloader())[-1]
    jax_tail = _batches(jax_dm.val_dataloader())[-1]
    scores = np.random.RandomState(0).randn(BATCH, ANSWERS).astype(
        np.float32)
    got = Report(port_tail, {"scores": torch.from_numpy(scores)}).to_numpy()
    want = JaxReport(jax_tail, {"scores": scores}).to_numpy()
    got.trim_to_batch_size(port_tail._true_batch_size)
    want.trim_to_batch_size(jax_tail._true_batch_size)
    assert got.batch_size == want.batch_size == N_VAL - BATCH
    for key in ("scores", "targets", "question_id", "input_ids",
                "image_feature_0"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["text"] == want["text"]


def test_missing_data_names_the_file(layout, tmp_path):
    from mmf_tpu_torch.datasets.builders.vqa2.builder import VQA2Builder
    from mmf_tpu_torch.config.configuration import Configuration

    config = Configuration(
        _opts(layout) + [f"env.data_dir={tmp_path}"]).get_config()
    with pytest.raises(RuntimeError, match="imdb_train2014.npy"):
        VQA2Builder().build(config["dataset_config"]["vqa2"])
