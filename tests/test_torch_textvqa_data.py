"""TextVQA's data path in the port against the JAX package on the CPU:

- LMDB: an environment written by the port's native core reads back
  equal through JAX's ``LMDBFeatureReader``, and one written by JAX's
  core through the port's (the int-id lookup and the path lookup); the
  port's build raises, naming the compilers, where none works;
- PHOC: the C featurizer and its python twin equal JAX's, bit for bit;
- the ``object_to_byte_tensor`` codec equals JAX's;
- the ``m4c_answer``, ``copy``, ``fasttext`` (through the seeded
  stand-in, ``tests/torch_textvqa_layout.FastTextStandIn``) and
  ``phoc`` processors equal JAX's;
- the TextVQA dataset's samples on the synthetic layout equal JAX's,
  field by field (numpy's generator seeded alike in both: ``m4c_answer``
  draws its teacher-forced spelling from it);
- ``textvqa_accuracy`` equals JAX's on the same scores (JAX's given the
  unpacked OCR tokens and answers, which its metric expects; it indexes
  the packed bytes of a real batch, ROADMAP C.8), and
  ``format_for_prediction`` gives JAX's rows.
"""

import json
import os
import pickle

import numpy as np
import pytest

from tests.torch_port_utils import registries_restored
from tests.torch_textvqa_layout import (
    FastTextStandIn,
    layout_opts,
    write_layout,
)

WORDS = ["Hello", "the", "  St. Louis ", "a", "", "bottle123", "ßtrange",
         "Coca-Cola", "66", "theatre", "mississippi", "x" * 40, "I'm"]


def _entries(rng, n):
    out = {}
    for i in range(n):
        # a path key (TextVQA's) or an int id (COCO's)
        key = f"train/{i:08x}abc" if i % 2 else str(100 + i)
        boxes = int(rng.randint(0, 7))
        out[key] = {"image_id": key,
                    "features": rng.randn(boxes, 16).astype(np.float32),
                    "bbox": rng.rand(boxes, 4).astype(np.float32),
                    "num_boxes": boxes, "image_height": 480,
                    "image_width": 640}
    return out


def _write(lmdb, path, entries):
    env = lmdb.open(path, subdir=True, readonly=False, create=True)
    with env.begin(write=True) as txn:
        txn.put(b"keys", pickle.dumps([k.encode() for k in entries]))
        for key, value in entries.items():
            txn.put(key.encode(), pickle.dumps(value))
    env.close()


def _lookup_name(key):
    # an int id is looked up by the int after the name's last "_"
    return (f"COCO_val2014_{int(key):012d}.npy" if key.isdigit()
            else key + ".npy")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lmdb_written_by_one_package_reads_back_in_the_other(tmp_path,
                                                             writer):
    from mmf_tpu.datasets.databases.readers import feature_readers as jfr
    from mmf_tpu.utils.native import lmdb_shim as jax_lmdb
    from mmf_tpu_torch.datasets.databases.readers import (
        feature_readers as pfr,
    )
    from mmf_tpu_torch.utils.native import lmdb_shim as port_lmdb

    entries = _entries(np.random.RandomState(0), 9)
    path = str(tmp_path / "features.lmdb")
    _write(port_lmdb if writer == "port" else jax_lmdb, path, entries)
    port = pfr.FeatureReader(path, depth_first=False, max_features=5)
    jax_reader = jfr.FeatureReader(path, depth_first=False, max_features=5)
    for key, entry in entries.items():
        name = _lookup_name(key)
        got, got_info = port.read(name)
        want, want_info = jax_reader.read(name)
        np.testing.assert_array_equal(got, want)
        n = min(entry["num_boxes"], 5)
        np.testing.assert_array_equal(got[:n], entry["features"][:n])
        assert got.shape == (5, 16) and not got[n:].any()
        assert set(got_info) == set(want_info)
        assert int(got_info["max_features"]) == n
        np.testing.assert_array_equal(got_info["bbox"], want_info["bbox"])
    with port_lmdb.open(path) as env:
        assert env.stat()["entries"] == len(entries) + 1
        txn = env.begin()
        assert sorted(txn.cursor().iternext(values=False)) == sorted(
            [b"keys"] + [k.encode() for k in entries])


def test_lmdb_build_raises_naming_the_compilers(tmp_path, monkeypatch):
    from mmf_tpu_torch.utils.native import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "CXX_COMPILERS", ("no-such-c++",))
    src = os.path.join(os.path.dirname(build.__file__), "src",
                       "lmdb_core.cc")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler works.*"
                                           "no-such-c\\+\\+: not found"):
        build.compile_lib(src, "lmdbcore", lambda lib: None, cxx=True)


@pytest.mark.parametrize("word", WORDS)
def test_phoc_c_and_python_twin_match_jax(word):
    from mmf_tpu.utils.phoc import build_phoc as jax_phoc
    from mmf_tpu_torch.utils.phoc import build_phoc as port_phoc

    want = jax_phoc._build_phoc_python(port_phoc._normalize(word))
    np.testing.assert_array_equal(port_phoc.build_phoc(word), want)
    np.testing.assert_array_equal(
        port_phoc.build_phoc_python(port_phoc._normalize(word)), want)
    np.testing.assert_array_equal(jax_phoc.build_phoc(word), want)


def test_phoc_batch_matches_jax():
    from mmf_tpu.utils.phoc import build_phoc as jax_phoc
    from mmf_tpu_torch.utils.phoc import build_phoc as port_phoc

    got = port_phoc.build_phoc_batch(WORDS)
    assert got.shape == (len(WORDS), 604) and got.any()
    np.testing.assert_array_equal(got, jax_phoc.build_phoc_batch(WORDS))


@pytest.mark.parametrize("obj", [["stop", "sign"], "a1b2c3d4", 7,
                                 {"k": [1, 2]}])
def test_byte_tensor_codec_matches_jax(obj):
    from mmf_tpu.utils import distributed as jd
    from mmf_tpu_torch.utils import distributed as pd

    packed = pd.object_to_byte_tensor(obj)
    np.testing.assert_array_equal(packed, jd.object_to_byte_tensor(obj))
    assert packed.dtype == np.uint8 and packed.shape == (4096,)
    assert pd.byte_tensor_to_object(packed) == obj
    assert pd.byte_tensor_to_object(
        __import__("torch").from_numpy(packed)) == obj


# --- processors ----------------------------------------------------------
def _processors(layout_root, cfg):
    from mmf_tpu.datasets.processors.processors import Processor as JP
    from mmf_tpu.utils.env import setup_imports as jsetup
    from mmf_tpu_torch.datasets.processors.processors import Processor
    from mmf_tpu_torch.utils.env import setup_imports

    jsetup()
    setup_imports()
    data_dir = os.path.join(layout_root, "datasets")
    return (Processor(cfg, data_dir=data_dir), JP(cfg, data_dir=data_dir))


ANSWER_CFG = {"type": "m4c_answer", "params": {
    "vocab_file": "textvqa/defaults/extras/vocabs/"
                  "fixed_answer_vocab_textvqa_5k.txt",
    "preprocessor": {"type": "simple_word", "params": {}},
    "context_preprocessor": {"type": "simple_word", "params": {}},
    "max_length": 50, "max_copy_steps": 12, "num_answers": 10}}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("textvqa"))
    write_layout(root, n_train=10, n_val=6, n_test=4, n_images=6,
                 max_obj=8, max_ocr=7, feature_dim=32, num_answers=60,
                 vocab_size=200, seed=5)
    return root


ANSWER_CASES = {
    "vocab_and_copies": (["stop sign", "stop", "stop", "route 66", "stop",
                          "nike", "stop", "66", "stop sign", "stop"],
                         ["stop", "sign", "route", "66", "stop", "nike"]),
    "two_words_from_ocr": (["coca cola"] * 6 + ["cola"] * 4,
                           ["coca", "cola", "coca"]),
    "unspellable": (["nowhere to be found"] * 10, ["exit"]),
    "no_answers": ([], ["exit"]),
}


@pytest.mark.parametrize("case", sorted(ANSWER_CASES))
def test_m4c_answer_processor_matches_jax(layout, case):
    port, jax_p = _processors(layout, ANSWER_CFG)
    answers, tokens = ANSWER_CASES[case]
    assert port.get_vocab_size() == jax_p.get_vocab_size() == 60 + 50
    assert port.get_true_vocab_size() == 60
    assert (port.PAD_IDX, port.BOS_IDX, port.EOS_IDX, port.UNK_IDX) == (
        jax_p.PAD_IDX, jax_p.BOS_IDX, jax_p.EOS_IDX, jax_p.UNK_IDX)
    for seed in range(3):  # the teacher-forced spelling is drawn
        np.random.seed(seed)
        want = jax_p({"answers": list(answers), "tokens": list(tokens)})
        np.random.seed(seed)
        got = port({"answers": list(answers), "tokens": list(tokens)})
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value)
                assert got[key].dtype == value.dtype
            else:
                assert got[key] == value, key
    if case == "vocab_and_copies":
        assert got["train_loss_mask"].sum() >= 2
        assert got["answers_scores"][0].max() == 1.0


def test_copy_fasttext_and_phoc_processors_match_jax(layout, monkeypatch):
    import mmf_tpu.datasets.processors.processors as JP
    import mmf_tpu_torch.datasets.processors.processors as PP

    def stand_in(self, model_file):
        if getattr(self, "model", None) is None:  # JAX calls it each time
            self.model = FastTextStandIn(seed=3)
        self._is_model_loaded = True

    for module in (JP, PP):
        monkeypatch.setattr(module.FastTextProcessor,
                            "_load_fasttext_model", stand_in)
    tokens = ["Stop", "66", "coca", "", "route", "a&w", "e-mail", "x"]
    blob = np.random.RandomState(2).rand(5, 4).astype(np.float32)
    for cfg, item in (
        ({"type": "copy", "params": {"max_length": 7}}, {"blob": blob}),
        ({"type": "copy", "params": {"max_length": 3}}, {"blob": blob}),
        ({"type": "fasttext", "params": {"max_length": 6,
                                         "model_file": "wiki.en.bin"}},
         {"tokens": tokens}),
        ({"type": "phoc", "params": {"max_length": 10}}, {"tokens": tokens}),
        ({"type": "phoc", "params": {"max_length": 4}}, {"tokens": []}),
    ):
        port, jax_p = _processors(layout, cfg)
        got, want = port(dict(item)), jax_p(dict(item))
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value)
                assert got[key].dtype == value.dtype
            else:
                assert got[key] == value
    assert got["text"].shape == (4, 604)


def test_fasttext_without_its_model_file_raises(layout):
    port, _ = _processors(layout, {"type": "fasttext", "params": {
        "max_length": 4, "model_file": "/nonexistent/wiki.en.bin"}})
    with pytest.raises(RuntimeError, match="not present"):
        port({"tokens": ["a"]})


# --- the dataset -----------------------------------------------------------
def _datasets(root, split, monkeypatch):
    import mmf_tpu.datasets.processors.processors as JP
    import mmf_tpu_torch.datasets.processors.processors as PP
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration as JConfig
    from mmf_tpu.utils.env import setup_imports as jsetup
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.utils.env import setup_imports
    from mmf_tpu_torch.utils.flagship import TEXTVQA_M4C_OVERRIDES

    def stand_in(self, model_file):
        if getattr(self, "model", None) is None:  # JAX calls it each time
            self.model = FastTextStandIn()
        self._is_model_loaded = True

    for module in (JP, PP):
        monkeypatch.setattr(module.FastTextProcessor,
                            "_load_fasttext_model", stand_in)
    jsetup()
    setup_imports()
    args = ["config=projects/m4c/configs/textvqa/defaults.yaml",
            "model=m4c", "datasets=textvqa", "training.device=cpu"]
    out = []
    for reg, conf in ((jreg, JConfig), (registry, Configuration)):
        config = conf(args + TEXTVQA_M4C_OVERRIDES
                      + layout_opts(root)).get_config()
        reg.register("config", config)
        builder = reg.get_builder_class("textvqa")()
        out.append(builder.load_dataset(config["dataset_config"]["textvqa"],
                                        split))
        builder.update_registry_for_model(config)
    return out


def _assert_same_sample(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_same_sample(got[key], value)
        elif isinstance(value, (np.ndarray, np.generic)):
            np.testing.assert_array_equal(np.asarray(got[key]), value,
                                          err_msg=key)
            assert np.asarray(got[key]).dtype == value.dtype, key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_textvqa_dataset_matches_jax(layout, split, monkeypatch):
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils.distributed import byte_tensor_to_object

    with registries_restored(empty=True):
        jds, ds = _datasets(layout, split, monkeypatch)
        assert len(ds) == len(jds) == {"train": 10, "val": 6,
                                       "test": 4}[split]
        assert registry.get("textvqa_num_final_outputs") == jreg.get(
            "textvqa_num_final_outputs") == 110
        for i in range(len(ds)):
            np.random.seed(i)
            want = jds[i]
            np.random.seed(i)
            got = ds[i]
            _assert_same_sample(got, want)
        # the fields M4C reads, at the config's widths
        assert got["image_feature_0"].shape == (100, 32)
        assert got["image_feature_1"].shape == (100, 32)
        assert got["context_feature_0"].shape == (50, 300)
        assert got["context_feature_1"].shape == (50, 604)
        assert got["order_vectors"].shape == (50, 50)
        assert got["ocr_bbox_coordinates"].shape == (50, 4)
        assert got["text"].shape == (20,)
        assert isinstance(byte_tensor_to_object(got["context_tokens"]),
                          list)
        if split != "test":
            assert got["targets"].shape == (12, 110)
            assert len(byte_tensor_to_object(got["answers"])) == 10


def _report(ds, seed=0):
    """A combined report's fields for four samples of ``ds`` with decoded
    ids over answers, OCR copies and </s>."""
    from mmf_tpu_torch.common.sample import SampleList

    batch = SampleList([ds[i] for i in range(4)])
    rng = np.random.RandomState(seed)
    scores = rng.randn(4, 12, 110).astype(np.float32)
    eos = ds.datasets[0].answer_processor.EOS_IDX
    scores[0, 3, eos] = 50.0  # an answer that ends at step 3
    scores[1, :, 60:66] += 5.0  # copies
    scores[2, :, 4:8] += 5.0  # vocabulary words
    return {"scores": scores,
            "question_id": batch["question_id"].numpy(),
            "image_id": batch["image_id"].numpy(),
            "context_tokens": batch["context_tokens"].numpy(),
            "answers": batch["answers"].numpy()}


def test_textvqa_accuracy_and_predictions_match_jax(layout, monkeypatch):
    from mmf_tpu.modules.metrics import TextVQAAccuracy as JAccuracy
    from mmf_tpu_torch.modules.metrics import TextVQAAccuracy
    from mmf_tpu_torch.utils.distributed import byte_tensor_to_object

    with registries_restored(empty=True):
        jds, ds = _datasets(layout, "val", monkeypatch)
        report = _report(ds)
        unpacked = dict(report, dataset_name="textvqa",
                        context_tokens=[byte_tensor_to_object(t) for t in
                                        report["context_tokens"]],
                        answers=[byte_tensor_to_object(t) for t in
                                 report["answers"]])
        want = JAccuracy().calculate(unpacked, unpacked)
        got = TextVQAAccuracy().calculate(
            dict(report, dataset_name="textvqa"), report)
        assert got == want
        # an exact answer scores its soft accuracy
        perfect = dict(unpacked)
        ids = [ds.datasets[0].answer_processor.answer_vocab.word2idx(
            byte_tensor_to_object(a)[0]) for a in report["answers"]]
        scores = np.full((4, 12, 110), -1.0, np.float32)
        scores[np.arange(4), 0, ids] = 1.0
        scores[:, 1:, ds.datasets[0].answer_processor.EOS_IDX] = 1.0
        perfect["scores"] = scores
        assert TextVQAAccuracy().calculate(
            dict(report, dataset_name="textvqa"), {"scores": scores}) == \
            JAccuracy().calculate(perfect, perfect) > 0

        jds_test, ds_test = _datasets(layout, "test", monkeypatch)
        report = _report(ds_test, seed=1)
        got = ds_test.datasets[0].format_for_prediction(report)
        want = jds_test.datasets[0].format_for_prediction(report)
        assert got == want
        assert json.loads(json.dumps(got)) == got
        assert {"OCR", "VOCAB"} <= {s for row in got
                                    for s in row["pred_source"]}
