"""The Visual Genome builders in the port against the JAX package on the
CPU: every field of the ``visual_genome`` dataset's items (Pythia's
``projects/pythia/configs/visual_genome/defaults.yaml``: VQA2's imdb
format under Visual Genome's config tree, GloVe's ``vocab`` text
processor) on the synthetic layout (``tests/torch_vqa2_layout.py`` with
its Visual Genome copy), and of ``masked_visual_genome``'s (the masked
LM over the question, the region features, the answer's targets after
``vg_answer_preprocessor``) over a jsonl of the layout's questions, under
the same seeds; the builders' registrations."""

import json
import os

import numpy as np
import pytest

from tests.test_torch_vilbert_data import _datamodules, _items_equal
from tests.torch_port_utils import registries_restored
from tests.torch_vqa2_layout import write_layout

REGIONS, DIM, ANSWERS, V = 10, 16, 6, 200
FEATURES = (("train", "trainval2014"), ("val", "trainval2014"),
            ("test", "test2015"))


@pytest.fixture(autouse=True)
def _restore_registries():
    with registries_restored():
        yield


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vg_data_layout"))
    write_layout(root, n_train=12, n_val=6, n_test=4, n_images=20,
                 regions=REGIONS, feature_dim=DIM, num_answers=ANSWERS,
                 vocab_size=V, seed=8, full_boxes=True, glove=True,
                 visual_genome=True)
    # masked_visual_genome's annotations: a jsonl of the train questions
    rows = np.load(os.path.join(root, "datasets", "visual_genome",
                                "defaults", "annotations",
                                "imdb_train2014.npy"), allow_pickle=True)[1:]
    os.makedirs(os.path.join(root, "imdb", "visual_genome"))
    with open(os.path.join(root, "imdb", "visual_genome",
                           "vg_question_answers.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps({
                "id": int(row["question_id"]), "image_id": row["image_id"],
                "question": row["question"], "answers": row["answers"][:1],
                "feature_path": row["feature_path"]}) + "\n")
    return root


def test_visual_genome_items_match_jax(layout):
    from mmf_tpu_torch.utils.flagship import PYTHIA2

    path, dataset, model = PYTHIA2["pythia_visual_genome"]
    opts = [f"config={path}", f"model={model}", f"datasets={dataset}",
            "training.device=cpu", "training.batch_size=4",
            "training.num_workers=0", f"env.data_dir={layout}",
            f"dataset_config.visual_genome.max_features={REGIONS}"] + [
        f"dataset_config.visual_genome.features.{split}=[coco/defaults/"
        f"features/{folder}]" for split, folder in FEATURES]
    jax_dm, port_dm = _datamodules(opts)
    got = _items_equal(jax_dm, port_dm, "visual_genome",
                       [("train", 12), ("val", 6), ("test", 4)])
    assert got["image_feature_0"].shape == (REGIONS, DIM)
    assert got["text"].shape == (14,)  # the vocab processor's max_length
    train = port_dm.datamodules["visual_genome"].train_dataset[0]
    assert train["targets"].shape == (ANSWERS,) and train["targets"].max() > 0


def test_masked_visual_genome_items_match_jax(layout):
    vocab = os.path.join(layout, "vocab.txt")
    answers = os.path.join(layout, "datasets", "vqa2", "defaults", "extras",
                           "vocabs", "answers_vqa.txt")
    procs = "dataset_config.masked_visual_genome.processors"
    opts = ["config=configs/datasets/visual_genome/masked.yaml",
            "model=visual_bert", "datasets=masked_visual_genome",
            "training.device=cpu", "training.batch_size=4",
            "training.num_workers=0", f"env.data_dir={layout}",
            f"dataset_config.masked_visual_genome.max_features={REGIONS}",
            f"{procs}.masked_token_processor.params.max_seq_length=16",
            f"{procs}.masked_token_processor.params.tokenizer_config."
            f"params.vocab_file={vocab}",
            f"{procs}.answer_processor.params.vocab_file={answers}"] + [
        f"dataset_config.masked_visual_genome.annotations.{split}=[imdb/"
        "visual_genome/vg_question_answers.jsonl]"
        for split, _ in FEATURES] + [
        f"dataset_config.masked_visual_genome.features.{split}=[datasets/"
        "coco/defaults/features/trainval2014]" for split, _ in FEATURES]
    jax_dm, port_dm = _datamodules(opts)
    got = _items_equal(jax_dm, port_dm, "masked_visual_genome",
                       [("train", 12), ("val", 12)])
    assert got["image_feature_0"].shape == (REGIONS, DIM)
    assert got["input_ids"].shape == got["lm_label_ids"].shape == (16,)
    assert int(got["is_correct"]) == -1 and got["targets"].shape == (ANSWERS,)


def test_visual_genome_builders_are_registered():
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.datasets.builders.visual_genome import builder
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    assert registry.get_builder_class("visual_genome") is \
        builder.VisualGenomeBuilder
    assert registry.get_builder_class("masked_visual_genome") is \
        builder.MaskedVisualGenomeBuilder
    assert builder.VisualGenomeBuilder.config_path() == \
        "configs/datasets/visual_genome/defaults.yaml"
