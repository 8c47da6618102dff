"""The OCR side of the VQA2-format datasets in the port against the JAX
package on the CPU, on the synthetic VQA2 layout with OCR tokens and its
VizWiz copy (``tests/torch_vqa2_layout.py``), the OCR tokens' vectors
from ``FastTextStandIn`` in both packages:

- ``soft_copy_answer``: the answers' indices, the scores over the answer
  vocabulary and the OCR copy slots, and the vocabulary sizes;
- every item of LoRRA's VQA2 dataset (``use_ocr``: the context, its
  tokens, its length, the order vectors, the copy targets; two feature
  sets; ``use_ocr_info``'s boxes), of the ``vqa2_ocr`` builder's and of
  VizWiz's (LoRRA's and BAN's configs);
- the prediction rows of a collated batch, OCR copies and the pad token's
  "unanswerable" included.
"""

import numpy as np
import pytest

from tests.test_torch_vilbert_data import _datamodules, _items_equal
from tests.test_torch_vqa2_dataset import _assert_equal
from tests.torch_port_utils import registries_restored
from tests.torch_textvqa_layout import FastTextStandIn
from tests.torch_vqa2_layout import write_layout

REGIONS, DIM, ANSWERS, V = 10, 16, 6, 200
SPLITS = [("train", 12), ("val", 6), ("test", 4)]
FEATURES = (("train", "trainval2014"), ("val", "trainval2014"),
            ("test", "test2015"))


@pytest.fixture(scope="module", autouse=True)
def _stand_ins():
    """The fasttext stand-in in both packages; the registries as they
    were after the module."""
    import mmf_tpu.datasets.processors.processors as JP
    import mmf_tpu_torch.datasets.processors.processors as PP

    def stand_in(self, model_file):
        if getattr(self, "model", None) is None:  # JAX calls it each time
            self.model = FastTextStandIn()
        self._is_model_loaded = True

    with registries_restored(), pytest.MonkeyPatch.context() as mp:
        for module in (JP, PP):
            mp.setattr(module.FastTextProcessor, "_load_fasttext_model",
                       stand_in)
        yield


@pytest.fixture(autouse=True)
def _restore_registries():
    with registries_restored():
        yield


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ocr_vqa_layout"))
    write_layout(root, n_train=12, n_val=6, n_test=4, n_images=20,
                 regions=REGIONS, feature_dim=DIM, num_answers=ANSWERS,
                 vocab_size=V, seed=8, glove=True, ocr=True, vizwiz=True)
    return root


def _features(dataset, sets=1):
    return [f"dataset_config.{dataset}.features.{split}=['"
            + ",".join([f"coco/defaults/features/{folder}"] * sets) + "']"
            for split, folder in FEATURES]


def _opts(key, layout, *extra):
    from mmf_tpu_torch.utils.flagship import LORRA_BAN, LORRA_BAN_OVERRIDES

    path, dataset, model = LORRA_BAN[key]
    return [f"config={path}", f"model={model}", f"datasets={dataset}",
            "training.device=cpu", "training.batch_size=4",
            "training.num_workers=0", f"env.data_dir={layout}",
            f"dataset_config.{dataset}.max_features={REGIONS}"] + \
        LORRA_BAN_OVERRIDES[key] + _features(
            dataset, 2 if key == "lorra_vqa2" else 1) + list(extra)


@pytest.mark.parametrize("answers, tokens", [
    (["Stop", "stop", "stop", "exit", "coca cola", "no", "stop", "exit",
      "2", "no"], ["Stop,", "sign", "exit", "2", "coca", "cola"]),
    (["yes"] * 10, ["yes"] * 60),  # more tokens than the copy slots
    (["red", "blue", "red"], []),  # fewer than ten answers, no OCR
])
def test_soft_copy_answer_matches_jax(layout, answers, tokens):
    import os

    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry

    params = {"vocab_file": os.path.join(layout, "datasets", "vqa2",
                                         "defaults", "extras", "vocabs",
                                         "answers_vqa.txt"),
              "preprocessor": {"type": "simple_word", "params": {}},
              "context_preprocessor": {"type": "simple_word", "params": {}},
              "max_length": 50, "num_answers": 10}
    _datamodules(_opts("lorra_vqa2", layout))  # both registries set up
    want_p = jreg.get_processor_class("soft_copy_answer")(params)
    got_p = registry.get_processor_class("soft_copy_answer")(params)
    assert (got_p.get_vocab_size(), got_p.get_true_vocab_size()) == (
        want_p.get_vocab_size(), want_p.get_true_vocab_size()) == (
        ANSWERS + 50, ANSWERS)
    item = {"answers": list(answers), "tokens": list(tokens)}
    got, want = got_p(dict(item)), want_p(dict(item))
    _assert_equal(got, want, "soft_copy_answer")
    copies = got["answers_scores"][ANSWERS:]
    assert (copies > 0).any() == bool(tokens)


@pytest.mark.parametrize("key", ["lorra_vqa2", "lorra_vizwiz",
                                 "ban_vizwiz"])
def test_items_match_jax(layout, key):
    from mmf_tpu_torch.utils.flagship import LORRA_BAN

    dataset, model = LORRA_BAN[key][1:]
    extra = [f"dataset_config.{dataset}.use_ocr_info=true"] \
        if key == "lorra_vqa2" else []
    jax_dm, port_dm = _datamodules(_opts(key, layout, *extra))
    got = _items_equal(jax_dm, port_dm, dataset, SPLITS)
    assert got["image_feature_0"].shape == (REGIONS, DIM)
    assert ("image_feature_1" in got) == (key == "lorra_vqa2")
    train = port_dm.datamodules[dataset].train_dataset[0]
    if model == "lorra":
        assert train["targets"].shape == (ANSWERS + 50,)
        n = int(got["context_info_0"]["max_features"])
        assert got["context_feature_0"].shape == (50, 300)
        assert len(got["context_tokens"]) == 50
        assert got["context_tokens"][n:] == ["<pad>"] * (50 - n)
        np.testing.assert_array_equal(got["order_vectors"][:n],
                                      np.eye(50, dtype=np.float32)[:n])
        assert not got["order_vectors"][n:].any()
        # some question's answer is one of its OCR tokens: a copy target
        ds = port_dm.datamodules[dataset].train_dataset
        assert any(ds[i]["targets"][ANSWERS:].any() for i in range(12))
    else:
        assert train["targets"].shape == (ANSWERS,)
        assert "context_feature_0" not in train
    if extra:
        assert got["ocr_bbox"].shape == (50, 4)


def test_vqa2_ocr_builder_matches_jax(layout):
    """``configs/datasets/vqa2/ocr.yaml`` gives ``vqa2_ocr`` nothing but
    ``use_ocr``: no annotations, so both packages' builders load no
    dataset (ROADMAP C.4). Given VQA2's block with ``use_ocr`` and
    LoRRA's processors, its items are JAX's."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config import omega as jomega
    from mmf_tpu.config.configuration import Configuration as JaxConfig
    from mmf_tpu.datasets.multi_datamodule import MultiDataModule as JaxDM
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.datasets.builders.vqa2.builder import VQA2OCRBuilder
    from mmf_tpu_torch.datasets.multi_datamodule import MultiDataModule
    from tests.test_torch_caption_run import _no_download

    assert registry.get_builder_class("vqa2_ocr") is VQA2OCRBuilder
    assert VQA2OCRBuilder.config_path() == "configs/datasets/vqa2/ocr.yaml"
    base = ["config=configs/datasets/vqa2/ocr.yaml", "model=lorra",
            "datasets=vqa2_ocr", "training.device=cpu",
            "training.batch_size=4", "training.num_workers=0",
            f"env.data_dir={layout}"]
    lorra = _opts("lorra_vqa2", layout)
    sides = []
    with pytest.MonkeyPatch.context() as mp:
        _no_download(mp)
        for conf, om, dm, reg in ((JaxConfig, jomega, JaxDM, jreg),
                                  (Configuration, omega, MultiDataModule,
                                   registry)):
            config = conf(base).get_config()
            assert dict(config["dataset_config"]["vqa2_ocr"]) == {
                "use_ocr": True}
            reg.register("config", config)
            assert dm(config).datamodules["vqa2_ocr"].train_dataset is None
            full = conf(lorra).get_config()
            with om.open_dict(config):
                config["dataset_config"]["vqa2_ocr"] = om.merge(
                    full["dataset_config"]["vqa2"], {"use_ocr": True})
            reg.register("config", config)
            sides.append(dm(config))
    got = _items_equal(*sides, "vqa2_ocr", SPLITS)
    assert got["context_feature_0"].shape == (50, 300)
    assert sides[1].datamodules["vqa2_ocr"].train_dataset[0][
        "targets"].shape == (ANSWERS + 50,)


def test_predictions_copy_ocr_tokens_as_jax(layout):
    """A collated batch of LoRRA's val items (JAX's report holds the
    padded ``context_tokens`` as lists of strings) scored to hit an
    answer, an OCR token and a pad slot: the same rows, the copies and
    "unanswerable" among them."""
    from mmf_tpu.common.sample import SampleList as JSampleList
    from mmf_tpu_torch.common.sample import SampleList

    jax_dm, port_dm = _datamodules(_opts("lorra_vqa2", layout))
    jds = jax_dm.datamodules["vqa2"].val_dataset.datasets[0]
    pds = port_dm.datamodules["vqa2"].val_dataset.datasets[0]
    n = 6
    jreport = JSampleList([jds[i] for i in range(n)])
    preport = SampleList([pds[i] for i in range(n)])
    assert isinstance(jreport["context_tokens"], list)
    assert isinstance(jreport["context_tokens"][0], list)
    assert isinstance(jreport["context_tokens"][0][0], str)
    lengths = [int(x) for x in np.asarray(
        jreport["context_info_0"]["max_features"])]
    scores = np.zeros((n, ANSWERS + 50), np.float32)
    for i in range(n):
        # an answer, the first OCR token, or a pad slot past the tokens
        slot = [3, ANSWERS, ANSWERS + lengths[i]][i % 3]
        scores[i, min(slot, ANSWERS + 49)] = 1.0
    want = jds.format_for_prediction(dict(jreport, scores=scores))
    got = pds.format_for_prediction(dict(preport, scores=scores))
    assert got == want and len(got) == n
    answers = [r["answer"] for r in got]
    assert "unanswerable" in answers
    assert answers[1] == jreport["context_tokens"][1][0] != "<pad>" or \
        lengths[1] == 0
