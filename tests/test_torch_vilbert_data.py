"""The data ViLBERT's configs read, in the port against the JAX package on
the CPU: the ``masked_region`` (the same masks under the same
``random.seed``), ``transformer_bbox``, ``vocab`` and
``multi_hot_answer_from_vocab`` processors, and every field of the
``masked_vqa2`` and ``masked_q_vqa2`` datasets' items on the same
synthetic layout (``tests/torch_vqa2_layout.py``, with full boxes and
class probabilities) under the same seeds; the builders' registrations
and ``projects/vilbert/configs/vqa2/train_val.yaml`` read as it is."""

import os
import random

import numpy as np
import pytest

from tests.test_torch_vqa2_dataset import _assert_equal
from tests.torch_port_utils import registries_restored
from tests.torch_vqa2_layout import SPLITS, layout_opts, write_layout

REGIONS, DIM, ANSWERS, TARGETS = 10, 16, 6, 11
N_TRAIN, N_VAL, N_TEST = 12, 6, 4


@pytest.fixture(autouse=True)
def _restore_registries():
    """The datasets cache their processors in both registries (JAX's
    too): put both back, so that no later file's dataset reuses them."""
    with registries_restored():
        yield


def _registries():
    from mmf_tpu.common.registry import registry as jax_registry
    from mmf_tpu.utils.env import setup_imports as jax_setup_imports
    from mmf_tpu_torch.common.registry import registry as port_registry
    from mmf_tpu_torch.utils.env import setup_imports

    jax_setup_imports()
    setup_imports()
    return jax_registry, port_registry


def _processor(registry, name, config, **kwargs):
    return registry.get_processor_class(name)(config, **kwargs)


@pytest.mark.parametrize("mask_probability,region_probability,seed",
                         [(0.15, 0.9, 0), (0.5, 0.5, 1), (1.0, 0.0, 2)])
def test_masked_region_matches_jax_under_the_same_seed(
        mask_probability, region_probability, seed):
    jax_registry, port_registry = _registries()
    config = {"mask_probability": mask_probability,
              "mask_region_probability": region_probability}
    feats = np.random.RandomState(seed).randn(100, 8).astype(np.float32)
    random.seed(seed)
    got_feats, got_labels = _processor(port_registry, "masked_region",
                                       config)(feats)
    random.seed(seed)
    want_feats, want_labels = _processor(jax_registry, "masked_region",
                                         config)(feats)
    np.testing.assert_array_equal(got_feats, want_feats)
    np.testing.assert_array_equal(got_labels, want_labels)
    assert got_labels.dtype == want_labels.dtype
    # the input is left as it was; masked regions are labelled 1
    assert not np.shares_memory(got_feats, feats)
    zeroed = ~got_feats.any(1)
    assert np.all(got_labels[zeroed] == 1)
    assert set(np.unique(got_labels)) <= {-1, 1}


def test_transformer_bbox_matches_jax():
    jax_registry, port_registry = _registries()
    rng = np.random.RandomState(4)
    xy = rng.rand(7, 2) * 200
    info = {"bbox": np.concatenate([xy, xy + rng.rand(7, 2) * 100 + 1],
                                   1).astype(np.float32),
            "image_width": 400, "image_height": 300, "num_boxes": 7}
    config = {"bbox_key": "bbox", "image_width_key": "image_width",
              "image_height_key": "image_height"}
    got = _processor(port_registry, "transformer_bbox", config)(info)
    want = _processor(jax_registry, "transformer_bbox", config)(info)
    _assert_equal(got, want, "transformer_bbox")
    assert got["bbox"].shape == (7, 5) and info["bbox"].shape == (7, 4)
    area = ((info["bbox"][:, 2] - info["bbox"][:, 0])
            * (info["bbox"][:, 3] - info["bbox"][:, 1]) / (400 * 300))
    np.testing.assert_allclose(got["bbox"][:, 4], area, rtol=1e-6)


def test_vocab_and_multi_hot_processors_match_jax(tmp_path):
    jax_registry, port_registry = _registries()
    (tmp_path / "vocab.txt").write_text("what\ncolor\nis\nthe\ndog\n")
    (tmp_path / "answers.txt").write_text("<unk>\nyes\nno\nred\n")
    config = {"max_length": 6,
              "vocab": {"type": "random", "vocab_file": "vocab.txt"},
              "preprocessor": {"type": "simple_sentence", "params": {}}}
    got = _processor(port_registry, "vocab", config,
                     data_dir=str(tmp_path))
    want = _processor(jax_registry, "vocab", config, data_dir=str(tmp_path))
    for item in ({"text": "What color is the cat?"},
                 {"tokens": ["the", "dog", "is", "what", "color", "is",
                             "the", "dog"]}):
        _assert_equal(got(dict(item)), want(dict(item)), str(item))
    assert got.get_vocab_size() == want.get_vocab_size() == 9
    answer = {"vocab_file": "answers.txt",
              "preprocessor": {"type": "simple_word", "params": {}},
              "num_answers": 1}
    got = _processor(port_registry, "multi_hot_answer_from_vocab", answer,
                     data_dir=str(tmp_path))
    want = _processor(jax_registry, "multi_hot_answer_from_vocab", answer,
                      data_dir=str(tmp_path))
    for answers in (["red"], ["no", "maybe"]):
        _assert_equal(got({"answers": list(answers)}),
                      want({"answers": list(answers)}), str(answers))


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The layout with full boxes and class probabilities, plus what the
    masked_q config reads: a GloVe vocabulary and vectors, and the
    questions' tokens in the imdb rows."""
    from mmf_tpu.utils.text import tokenize

    root = str(tmp_path_factory.mktemp("vilbert_layout"))
    write_layout(root, n_train=N_TRAIN, n_val=N_VAL, n_test=N_TEST,
                 n_images=8, regions=REGIONS, feature_dim=DIM,
                 num_answers=ANSWERS, vocab_size=64, seed=2,
                 full_boxes=True, cls_prob_width=TARGETS)
    datasets = os.path.join(root, "datasets")
    annotations = os.path.join(datasets, "vqa2", "defaults", "annotations")
    words = set()
    for name in SPLITS.values():
        rows = np.load(os.path.join(annotations, name), allow_pickle=True)
        for row in rows[1:]:
            row["question_tokens"] = tokenize(row["question"])
            words.update(row["question_tokens"])
        np.save(os.path.join(annotations, name), rows)
    vocabs = os.path.join(datasets, "vqa2", "defaults", "extras", "vocabs")
    words = sorted(words) + ["<mask>"]
    with open(os.path.join(vocabs, "vocabulary_100k.txt"), "w") as f:
        f.write("\n".join(words[1:]) + "\n")  # one word left out: unknown
    os.makedirs(os.path.join(datasets, "vectors"))
    rng = np.random.RandomState(0)
    with open(os.path.join(datasets, "vectors", "glove.6B.300d.txt"),
              "w") as f:
        for w in words[::2]:
            f.write(w + " " + " ".join(f"{x:.4f}" for x in rng.randn(4))
                    + "\n")
    return root


def _datamodules(opts):
    """JAX's and the port's MultiDataModule for the same command line
    (JAX's download made to raise: the layout must count as built)."""
    import mmf_tpu.utils.download as jax_download
    from mmf_tpu.config.configuration import Configuration as JaxConfig
    from mmf_tpu.datasets.multi_datamodule import MultiDataModule as JaxDM
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.datasets.multi_datamodule import MultiDataModule

    jax_registry, port_registry = _registries()

    def no_download(*args, **kwargs):
        raise AssertionError("the synthetic layout must count as built")

    jax_config = JaxConfig(opts).get_config()
    jax_registry.register("config", jax_config)
    original = jax_download.download
    jax_download.download = no_download
    try:
        jax_dm = JaxDM(jax_config)
    finally:
        jax_download.download = original
    config = Configuration(opts).get_config()
    port_registry.register("config", config)
    return jax_dm, MultiDataModule(config)


def _masked_vqa2_opts(layout):
    from mmf_tpu_torch.utils.flagship import VILBERT_MASKED_VQA2_OVERRIDES

    return [
        "config=projects/vilbert/configs/masked_vqa2/pretrain.yaml",
        "model=vilbert", "datasets=masked_vqa2", "training.device=cpu",
        "training.batch_size=4", "training.num_workers=0",
        f"dataset_config.masked_vqa2.max_features={REGIONS}",
        "dataset_config.masked_vqa2.processors.masked_token_processor."
        "params.max_seq_length=16",
    ] + VILBERT_MASKED_VQA2_OVERRIDES + layout_opts(
        layout, "masked_vqa2", "masked_token_processor")


def _items_equal(jax_dm, port_dm, name, splits):
    for split, n in splits:
        jax_ds = getattr(jax_dm.datamodules[name], f"{split}_dataset")
        port_ds = getattr(port_dm.datamodules[name], f"{split}_dataset")
        assert len(port_ds) == len(jax_ds) == n
        for i in range(n):
            # Python's random draws the masks and the answer; numpy's
            # the masked LM's random tokens, in both packages
            random.seed(100 + i)
            np.random.seed(100 + i)
            got = port_ds[i]
            random.seed(100 + i)
            np.random.seed(100 + i)
            want = jax_ds[i]
            _assert_equal(got, want, f"{name} {split}[{i}]")
    return got


def test_masked_vqa2_items_match_jax(layout):
    jax_dm, port_dm = _datamodules(_masked_vqa2_opts(layout))
    got = _items_equal(jax_dm, port_dm, "masked_vqa2",
                       [("train", N_TRAIN), ("val", N_VAL)])
    info = got["image_info_0"]
    assert got["image_feature_0"].shape == (REGIONS, DIM)
    assert info["bbox"].shape == (REGIONS, 5)
    assert info["cls_prob"].shape == (REGIONS, TARGETS)
    assert got["image_labels"].shape == (REGIONS,)
    assert got["input_ids"].shape == got["lm_label_ids"].shape == (16,)
    # the masked features are zeroed where the processor masked them
    labels = got["image_labels"]
    assert np.all(labels[~got["image_feature_0"].any(1)] == 1)


def test_masked_q_vqa2_items_match_jax(layout):
    opts = [
        "config=projects/vilbert/configs/masked_vqa2/pretrain.yaml",
        "model=vilbert", "datasets=masked_q_vqa2", "training.device=cpu",
        "training.batch_size=4", "training.num_workers=0",
        f"dataset_config.masked_q_vqa2.max_features={REGIONS}",
        f"env.data_dir={layout}",
    ] + [f"dataset_config.masked_q_vqa2.features.{split}="
         f"[coco/defaults/features/{folder}]"
         for split, folder in (("train", "trainval2014"),
                               ("val", "trainval2014"),
                               ("test", "test2015"))]
    jax_dm, port_dm = _datamodules(opts)
    got = _items_equal(jax_dm, port_dm, "masked_q_vqa2",
                       [("train", N_TRAIN), ("val", N_VAL)])
    assert got["text"].shape == (14,)
    assert got["targets"].shape == (ANSWERS,)


def test_vilbert_builders_and_train_val_config():
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration

    _registries()
    for name, path in (("vqa2_train_val", "train_val.yaml"),
                       ("masked_vqa2", "masked.yaml"),
                       ("masked_q_vqa2", "masked_q.yaml")):
        builder = registry.get_builder_class(name)
        assert builder().dataset_name == name
        assert builder.config_path() == f"configs/datasets/vqa2/{path}"
    config = Configuration([
        "config=projects/vilbert/configs/vqa2/train_val.yaml",
        "model=vilbert", "datasets=vqa2"]).get_config()
    vqa2 = config["dataset_config"]["vqa2"]
    assert list(vqa2["annotations"]["train"]) == [
        "vqa2/defaults/annotations/imdb_train2014.npy",
        "vqa2/defaults/annotations/imdb_val2014.npy"]
    assert vqa2["return_features_info"] is True
    assert config["model_config"]["vilbert"]["num_labels"] == 3129
