"""The data UNITER, LXMERT and VinVL read, in the port against the JAX
package on the CPU: ``uniter_text_tokenizer`` and
``vinvl_text_tokenizer`` (masking and the contrastive corruption) under
the same seeds, the ``caption`` processor, and every field of the
``coco``, ``masked_coco`` (single sentences, sentence pairs, false
captions) and ``vinvl`` datasets' items on the same synthetic layout
(``tests/torch_vqa2_layout.py`` with COCO's imdb files, object labels
and VinVL's label map) under the same seeds; the builders'
registrations."""

import os
import random

import numpy as np
import pytest

from tests.test_torch_vilbert_data import _datamodules, _items_equal
from tests.test_torch_vqa2_dataset import _assert_equal
from tests.torch_port_utils import registries_restored
from tests.torch_vqa2_layout import layout_opts, write_layout

REGIONS, DIM, ANSWERS, CLS, V = 10, 16, 6, 11, 200
N_IMAGES = 30  # 24 train and val images, split 16 / 8; 6 test images


@pytest.fixture(autouse=True)
def _restore_registries():
    """The datasets cache their processors in both registries: put both
    back, so that no later file's dataset reuses them."""
    with registries_restored():
        yield


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vl3_data_layout"))
    write_layout(root, n_train=12, n_val=6, n_test=4, n_images=N_IMAGES,
                 regions=REGIONS, feature_dim=DIM, num_answers=ANSWERS,
                 vocab_size=V, seed=6, full_boxes=True, cls_prob_width=CLS,
                 glove=True, coco=True, object_labels=True)
    return root


def _processors(name, config):
    from mmf_tpu.common.registry import registry as jax_registry
    from mmf_tpu.utils.env import setup_imports as jax_setup_imports
    from mmf_tpu_torch.common.registry import registry as port_registry
    from mmf_tpu_torch.utils.env import setup_imports

    jax_setup_imports()
    setup_imports()
    return (port_registry.get_processor_class(name)(config),
            jax_registry.get_processor_class(name)(config))


def _tokenizer_config(layout, **params):
    return dict({"tokenizer_config": {
        "type": "bert-base-uncased",
        "params": {"do_lower_case": True,
                   "vocab_file": os.path.join(layout, "vocab.txt")}}},
        **params)


def _seeded(fn, item, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn(dict(item))


@pytest.mark.parametrize("mask_probability", [0.0, 0.3, 1.0])
def test_uniter_tokenizer_matches_jax(layout, mask_probability):
    got_p, want_p = _processors("uniter_text_tokenizer", _tokenizer_config(
        layout, max_seq_length=12, mask_probability=mask_probability))
    for seed, item in enumerate([
            {"text": "What color is the dog, the man's?"},
            {"tokens": ["how", "many", "people", "sit", "on", "the",
                        "table", "in", "this", "photo", "of", "a", "bus"]}]):
        got = _seeded(got_p, item, seed)
        want = _seeded(want_p, item, seed)
        _assert_equal(got, want, f"{item}")
        # the plain ids beside the masked ones
        assert got["input_ids"].shape == got["input_ids_masked"].shape == (
            12,)
        if mask_probability == 0.0:
            np.testing.assert_array_equal(got["input_ids"],
                                          got["input_ids_masked"])


@pytest.mark.parametrize("corrupt,caption_share", [(0.0, 0.0), (1.0, 0.0),
                                                   (1.0, 1.0), (0.5, 0.5)])
def test_vinvl_tokenizer_matches_jax(layout, corrupt, caption_share):
    got_p, want_p = _processors("vinvl_text_tokenizer", _tokenizer_config(
        layout, max_seq_length=20, mask_probability=0.2,
        corrupt_probability=corrupt,
        corrupt_caption_probability=caption_share))
    item = {"text": "what is the man holding?", "text_b": "man ball red",
            "random_captions": ["a dog on the street"],
            "random_labels": ["bus sign blue"]}
    labels = set()
    for seed in range(6):
        got = _seeded(got_p, item, seed)
        want = _seeded(want_p, item, seed)
        _assert_equal(got, want, f"seed {seed}")
        assert got["input_ids"].shape == (20,)
        if corrupt:
            labels.add(int(got["contrastive_labels"]))
            assert int(got["contrastive_label"]) == int(
                got["contrastive_labels"])
        else:
            assert "input_ids_corrupt" not in got
    if corrupt == 1.0:
        assert labels == ({1} if caption_share else {2})


def test_caption_processor_matches_jax(layout):
    config = {"vocab": {
        "type": "intersected", "embedding_name": "glove.6B.300d",
        "vocab_file": "coco/defaults/extras/vocabs/"
                      "vocabulary_captioning_thresh5.txt",
        "data_dir": os.path.join(layout, "datasets")}}
    got_p, want_p = _processors("caption", config)
    for ids in ([1, 5, 9, 7, 2, 4, 4], [1, 6, 0, 0], [8, 3, 10]):
        got, want = got_p(list(ids)), want_p(list(ids))
        assert got == want and got["caption"] == " ".join(got["tokens"])


def _opts(layout, config, model, dataset, *extra):
    return [f"config={config}", f"model={model}", f"datasets={dataset}",
            "training.device=cpu", "training.batch_size=4",
            "training.num_workers=0",
            f"dataset_config.{dataset}.max_features={REGIONS}"] + list(extra)


def _coco_opts(layout):
    return _opts(layout, "projects/lxmert/configs/coco/pretrain.yaml",
                 "lxmert", "coco", f"env.data_dir={layout}",
                 "dataset_config.coco.processors.text_processor.params."
                 "max_length=12") + [
        f"dataset_config.coco.features.{split}=[coco/defaults/features/"
        f"{folder}]" for split, folder in (("train", "trainval2014"),
                                           ("val", "trainval2014"),
                                           ("test", "test2015"))]


def test_coco_items_match_jax(layout):
    jax_dm, port_dm = _datamodules(_coco_opts(layout))
    got = _items_equal(jax_dm, port_dm, "coco",
                       [("train", 16 * 5), ("val", 8 * 5), ("test", 6 * 5)])
    assert got["image_feature_0"].shape == (REGIONS, DIM)
    assert "text" not in got  # the test split has no captions
    port_ds = port_dm.datamodules["coco"].train_dataset
    first = port_ds[0]
    assert first["text"].shape == (12,) and first["answers"].shape == (5, 12)
    # predictions decode the caption ids through the caption processor
    rows = port_ds.format_for_prediction({
        "captions": np.stack([first["text"], first["answers"][1]]),
        "image_id": [first["image_id"], first["image_id"]]})
    jax_ds = jax_dm.datamodules["coco"].train_dataset
    assert rows == jax_ds.format_for_prediction({
        "captions": np.stack([first["text"], first["answers"][1]]),
        "image_id": [first["image_id"], first["image_id"]]})
    assert rows[0]["image_id"] == 0 and rows[0]["caption"]


@pytest.mark.parametrize("pairing", ["single", "two_sentence",
                                     "false_caption"])
def test_masked_coco_items_match_jax(layout, pairing):
    from mmf_tpu_torch.utils.flagship import VL3_OVERRIDES

    extra = {"single": [],
             "two_sentence": ["dataset_config.masked_coco.two_sentence=true"],
             "false_caption": [
                 "dataset_config.masked_coco.false_caption=true"]}[pairing]
    opts = _opts(layout, "projects/uniter/configs/masked_coco/defaults.yaml",
                 "uniter", "masked_coco",
                 "dataset_config.masked_coco.processors."
                 "masked_token_processor.params.max_seq_length=24",
                 *VL3_OVERRIDES["uniter_masked_coco"], *extra,
                 *layout_opts(layout, "masked_coco",
                              "masked_token_processor"))
    jax_dm, port_dm = _datamodules(opts)
    got = _items_equal(jax_dm, port_dm, "masked_coco",
                       [("train", 16), ("val", 8)])
    assert got["image_labels"].shape == (REGIONS,)
    assert got["image_info_0"]["cls_prob"].shape == (REGIONS, CLS)
    assert got["input_ids"].shape == got["lm_label_ids"].shape == (24,)
    correct = int(got["is_correct"])
    assert correct == -1 if pairing == "single" else correct in (0, 1)
    if pairing == "two_sentence":
        assert got["segment_ids"].max() == 1


def _vinvl_opts(layout, *extra):
    from mmf_tpu_torch.utils.flagship import VL3_OVERRIDES

    return _opts(layout, "projects/vinvl/configs/vqa2/defaults.yaml",
                 "vinvl", "vinvl", *VL3_OVERRIDES["vinvl_vqa2"],
                 *layout_opts(layout, "vqa2"),
                 f"dataset_config.vqa2.max_features={REGIONS}",
                 "dataset_config.vinvl.processors.text_processor.params."
                 "tokenizer_config.params.vocab_file="
                 + os.path.join(layout, "vocab.txt"), *extra)


@pytest.mark.parametrize("corrupt", [0.0, 0.5])
def test_vinvl_items_match_jax(layout, corrupt):
    opts = _vinvl_opts(layout, "dataset_config.vinvl.processors."
                       f"text_processor.params.corrupt_probability={corrupt}",
                       "dataset_config.vinvl.processors.text_processor."
                       "params.corrupt_caption_probability=0.5")
    jax_dm, port_dm = _datamodules(opts)
    splits = [("train", 12), ("val", 6)]
    if corrupt:
        # the test split draws no tags and no random captions: the
        # corruption raises there, in JAX too
        for dm, error in ((jax_dm, AssertionError), (port_dm, KeyError)):
            with pytest.raises(error, match="random_captions"):
                dm.datamodules["vinvl"].test_dataset[0]
    else:
        splits.append(("test", 4))
    got = _items_equal(jax_dm, port_dm, "vinvl", splits)
    assert got["input_ids"].shape == (70,)
    train = port_dm.datamodules["vinvl"].train_dataset
    random.seed(0)
    np.random.seed(0)
    item = train[0]
    # the tags are the regions' object and attribute names, the pair's
    # second segment
    assert item["segment_ids"].max() == 1
    assert ("input_ids_corrupt" in item) == (corrupt > 0)
    assert "targets" in item


def test_vinvl_label_string_names_objects_then_attributes(layout):
    from mmf_tpu_torch.datasets.builders.vinvl.builder import VinVLDataset

    dataset = VinVLDataset.__new__(VinVLDataset)
    dataset.label_map = VinVLDataset.load_label_map(os.path.join(
        layout, "datasets", "vinvl", "defaults", "annotations",
        "VG-SGG-dicts-vgoi6-clipped.json"))
    sample = {"image_info_0": {"labels": np.array([1, 0, 2]),
                               "attr_labels": np.array([3])}}
    assert dataset.get_label_str(sample) == "man  dog small"
    assert dataset.get_label_str({}) == " "


def test_builders_are_registered():
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    for name, path in (("coco", "configs/datasets/coco/defaults.yaml"),
                       ("masked_coco", "configs/datasets/coco/masked.yaml"),
                       ("vinvl", "configs/datasets/vinvl/defaults.yaml")):
        builder = registry.get_builder_class(name)
        assert builder().dataset_name == name
        assert builder.config_path() == path
    for name in ("uniter_text_tokenizer", "vinvl_text_tokenizer", "caption"):
        assert registry.get_processor_class(name) is not None
