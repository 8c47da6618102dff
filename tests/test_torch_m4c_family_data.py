"""The rest of the M4C family's data path in the port against the JAX
package on the CPU:

- edit distance and ANLS (``utils/native/editdist``): equal to JAX's on
  ASCII strings (the C kernel), on strings beyond ASCII (the character
  DP), on empty strings and past the kernel's 511-byte clamp; the build
  raises, naming the compilers, where none works;
- corpus BLEU-4 (``m4c_evaluators.corpus_bleu``): within 1e-12 of
  nltk's ``corpus_bleu`` (bit-equal in practice) on seeded corpora and
  at the edges (an empty prediction, an empty reference, text beyond
  ASCII, no matching 4-gram, where both warn and give ~1e-77 times the
  rest, no matching unigram, a hypothesis longer than every reference);
- the ST-VQA accuracy, ANLS and TextCaps BLEU-4 evaluators equal JAX's;
- the ST-VQA, OCR-VQA and TextCaps datasets' samples equal JAX's, field
  by field, on the synthetic layouts (``tests/torch_textvqa_layout.py``;
  the configs with ``flagship.M4C_FAMILY_OVERRIDES``, in both packages);
- ``stvqa_anls``, ``stvqa_accuracy``, ``ocrvqa_accuracy`` and
  ``textcaps_bleu4`` equal JAX's on the same batch (JAX's given the
  unpacked OCR tokens and ground truths, ROADMAP C.8), and TextCaps'
  prediction rows equal JAX's;
- JAX-side facts the port copies (ROADMAP C.4): TextCaps' ``m4c_answer``
  asserts ten answers a sample; with one, a caption it cannot spell gets
  no loss and step 0 no target; ``without_ocr.yaml`` gives samples
  without the OCR fields, and M4C raises on them.
"""

import json
import random
import warnings

import numpy as np
import pytest

from tests.torch_port_utils import registries_restored
from tests.torch_textvqa_layout import (
    FastTextStandIn,
    layout_opts,
    write_layout,
)

ANSWERS = 60
SPLITS = {"train": 10, "val": 6, "test": 4}

STRINGS = ["", "a", "kitten", "sitting", "flaw", "lawn", "Hello World",
           "hello world", "  padded  ", "café", "cafe", "straße", "strasse",
           "niño", "日本語", "日本", "x" * 600, "x" * 599 + "y",
           "coca cola", "cola coca"]


@pytest.mark.parametrize("i", range(len(STRINGS)))
def test_edit_distance_matches_jax(i):
    from mmf_tpu.utils.native.editdist import edit_distance as jax_ed
    from mmf_tpu_torch.utils.m4c_evaluators import levenshtein
    from mmf_tpu_torch.utils.native.editdist import edit_distance

    for other in STRINGS:
        for a, b in ((STRINGS[i], other), (other, STRINGS[i])):
            want = jax_ed(a, b)
            assert edit_distance(a, b) == levenshtein(a, b) == want, (a, b)


ANLS_CASES = {
    "exact": ("stop", ["stop", "exit"]),
    "near": ("stpo", ["stop"]),
    "below_half": ("abcdef", ["uvwxyz", "abxxxx"]),
    "empty_prediction": ("", ["stop", ""]),
    "empty_ground_truth": ("stop", [""]),
    "both_empty": ("", [""]),
    "no_ground_truth": ("stop", []),
    "non_ascii": ("café", ["cafe", "café au lait"]),
    "non_ascii_ground_truth": ("strasse", ["straße"]),
    "long": ("x" * 600, ["x" * 599 + "y", "x" * 300]),
    "many": ("route 66", ["route 66 east", "66", "route", "root 66"]),
}


@pytest.mark.parametrize("case", sorted(ANLS_CASES))
def test_anls_best_matches_jax(case):
    from mmf_tpu.utils.native.editdist import anls_best as jax_anls
    from mmf_tpu_torch.utils.native.editdist import anls_best

    pred, gts = ANLS_CASES[case]
    want = jax_anls(pred, list(gts))
    assert anls_best(pred, list(gts)) == want
    if case in ("empty_ground_truth", "both_empty", "no_ground_truth",
                "below_half"):
        assert want == 0.0


def test_editdist_build_raises_naming_the_compilers(tmp_path, monkeypatch):
    from mmf_tpu_torch.utils.native import build, editdist

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "C_COMPILERS", ("no-such-cc",))
    monkeypatch.setattr(editdist, "_LIB", None)
    monkeypatch.setattr(editdist, "_SRC", str(tmp_path / "editdist.c"))
    (tmp_path / "editdist.c").write_text(open(
        editdist.__file__.replace("editdist.py", "src/editdist.c")).read()
        + "\n/* a source no earlier build compiled */\n")
    with pytest.raises(RuntimeError, match="no C compiler works.*"
                                           "no-such-cc: not found"):
        editdist.edit_distance("a", "b")


def _tok(s):
    from mmf_tpu_torch.utils.m4c_evaluators import TextCapsBleu4Evaluator

    return TextCapsBleu4Evaluator._tok(s)


def _random_corpus(seed):
    rng = random.Random(seed)
    words = "a sign says stop the red bus on main st café 66 .".split()
    n = rng.randint(1, 8)
    refs = [[[rng.choice(words) for _ in range(rng.randint(0, 14))]
             for _ in range(rng.randint(1, 5))] for _ in range(n)]
    hyps = [[rng.choice(words) for _ in range(rng.randint(0, 16))]
            for _ in range(n)]
    return refs, hyps


BLEU_CASES = {
    "empty_prediction": ([["a red bus on main st", "the bus"],
                          ["a sign that says stop"]],
                         ["", "a sign that says stop"]),
    "empty_reference": ([["", "a red bus on main st"], ["the stop sign"]],
                        ["a red bus on main st", "stop sign"]),
    "non_ascii": ([["a café sign on straße 66"], ["niño's café"]],
                  ["a café sign on straße", "niño's café"]),
    "no_4gram_match": ([["a red bus on main st"], ["the stop sign"]],
                       ["a red bus", "stop sign"]),
    "no_unigram_match": ([["a red bus"]], ["green"]),
    "longer_than_every_reference": (
        [["a red bus", "the bus"], ["stop"]],
        ["a red bus on main st near the stop sign", "stop sign at main st"]),
    "single_sentence": ([["the quick brown fox jumps over the lazy dog"]],
                        ["the quick brown fox jumps over the dog"]),
}


@pytest.mark.parametrize("case", sorted(BLEU_CASES) + [
    f"seed{i}" for i in range(12)])
def test_corpus_bleu_equals_nltk(case):
    from nltk.translate.bleu_score import corpus_bleu as nltk_bleu

    from mmf_tpu_torch.utils.m4c_evaluators import corpus_bleu

    if case.startswith("seed"):
        refs, hyps = _random_corpus(int(case[4:]))
    else:
        ref_strs, hyp_strs = BLEU_CASES[case]
        refs = [[_tok(r) for r in rs] for rs in ref_strs]
        hyps = [_tok(h) for h in hyp_strs]
    with warnings.catch_warnings(record=True) as nltk_warned:
        warnings.simplefilter("always")
        want = float(nltk_bleu(refs, hyps))
    with warnings.catch_warnings(record=True) as port_warned:
        warnings.simplefilter("always")
        got = corpus_bleu(refs, hyps)
    assert abs(got - want) <= 1e-12 and got == want, (got, want)
    assert [str(w.message) for w in port_warned] == [
        str(w.message) for w in nltk_warned]
    if case == "no_4gram_match":
        assert nltk_warned and 0 < want < 1e-60
    if case == "no_unigram_match":
        assert want == 0.0
    if case == "longer_than_every_reference":
        assert want > 0


def _pred_lists():
    lists = []
    for seed in range(4):
        rng = random.Random(seed)
        words = ["stop", "Stop!", "exit", "café", "cafe", "route 66",
                 "the bus", "", "two", "2", "a red bus", "straße"]
        lists.append([{"pred_answer": rng.choice(words),
                       "gt_answers": [rng.choice(words) for _ in
                                      range(rng.randint(1, 10))]}
                      for _ in range(rng.randint(1, 9))])
    return lists


@pytest.mark.parametrize("evaluator", ["STVQAAccuracyEvaluator",
                                       "STVQAANLSEvaluator",
                                       "TextCapsBleu4Evaluator"])
def test_evaluators_match_jax(evaluator):
    from mmf_tpu.utils import m4c_evaluators as J
    from mmf_tpu_torch.utils import m4c_evaluators as P

    got_any = False
    for pred_list in _pred_lists():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = getattr(J, evaluator)().eval_pred_list(pred_list)
            got = getattr(P, evaluator)().eval_pred_list(pred_list)
        assert got == want
        got_any |= got > 0
    assert got_any
    assert P.STVQAANLSEvaluator().get_anls(" Café ", "cafe") == \
        J.STVQAANLSEvaluator().get_anls(" Café ", "cafe") == 0.75


# --- the datasets ----------------------------------------------------------
@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    out = {}
    for i, dataset in enumerate(("stvqa", "ocrvqa", "textcaps")):
        root = str(tmp_path_factory.mktemp(dataset))
        write_layout(root, n_train=SPLITS["train"], n_val=SPLITS["val"],
                     n_test=SPLITS["test"], n_images=6, max_obj=8,
                     max_ocr=7, feature_dim=32, num_answers=ANSWERS,
                     vocab_size=200, seed=5 + i, dataset=dataset)
        out[dataset] = root
    return out


def _stand_in(monkeypatch):
    import mmf_tpu.datasets.processors.processors as JP
    import mmf_tpu_torch.datasets.processors.processors as PP

    def stand_in(self, model_file):
        if getattr(self, "model", None) is None:  # JAX calls it each time
            self.model = FastTextStandIn()
        self._is_model_loaded = True

    for module in (JP, PP):
        monkeypatch.setattr(module.FastTextProcessor,
                            "_load_fasttext_model", stand_in)


def _datasets(root, dataset, split, monkeypatch, config=None, opts=()):
    """(JAX's dataset, the port's) of ``dataset``'s project config (or
    ``config``) with its ``flagship`` overrides, on the layout."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration as JConfig
    from mmf_tpu.utils.env import setup_imports as jsetup
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.utils.env import setup_imports
    from mmf_tpu_torch.utils.flagship import (
        M4C_FAMILY,
        M4C_FAMILY_OVERRIDES,
    )

    _stand_in(monkeypatch)
    jsetup()
    setup_imports()
    path, datasets, model = M4C_FAMILY[dataset]
    args = [f"config={config or path}", f"model={model}",
            f"datasets={datasets}", "training.device=cpu"]
    out = []
    for reg, conf in ((jreg, JConfig), (registry, Configuration)):
        cfg = conf(args + M4C_FAMILY_OVERRIDES[dataset]
                   + layout_opts(root, dataset) + list(opts)).get_config()
        reg.register("config", cfg)
        builder = reg.get_builder_class(dataset)()
        out.append(builder.load_dataset(cfg["dataset_config"][dataset],
                                        split))
        builder.update_registry_for_model(cfg)
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
@pytest.mark.parametrize("dataset", ["stvqa", "ocrvqa", "textcaps"])
def test_dataset_matches_jax(layouts, dataset, split, monkeypatch):
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils.distributed import byte_tensor_to_object

    with registries_restored(empty=True):
        jds, ds = _datasets(layouts[dataset], dataset, split, monkeypatch)
        assert len(ds) == len(jds) == SPLITS[split]
        key = f"{dataset}_num_final_outputs"
        assert registry.get(key) == jreg.get(key) == ANSWERS + 50
        assert registry.get(f"{dataset}_answer_processor").UNK_IDX == 3
        for i in range(len(ds)):
            np.random.seed(i)
            want = jds[i]
            np.random.seed(i)
            got = ds[i]
            _assert_same_sample(got, want)
        assert got["image_feature_1"].shape == (100, 32)
        assert got["context_feature_0"].shape == (50, 300)
        if dataset == "textcaps":
            assert not got["text_len"] or got["text"][1] in (0, 102)
            if split == "test":
                assert "ref_strs" not in got and "answers" in got
            else:
                refs = byte_tensor_to_object(got["ref_strs"])
                assert len(refs) == 5 and "answers" not in got
                assert byte_tensor_to_object(got["caption_str"]) in refs
        elif split != "test":
            assert len(byte_tensor_to_object(got["answers"])) == 10


def test_textcaps_spells_only_captions_in_the_vocabulary(layouts,
                                                         monkeypatch):
    """With ``num_answers: 1`` (the YAML's ten raise: C.4) a caption is
    its one answer: it scores 0 at step 0 (the soft accuracy of one
    answer of one), and a caption with a word in neither the vocabulary
    nor the OCR tokens, or whose last word keeps its period, is not
    spelled and gets no loss, in both packages."""
    from mmf_tpu_torch.utils.distributed import byte_tensor_to_object

    with registries_restored(empty=True):
        jds, ds = _datasets(layouts["textcaps"], "textcaps", "train",
                            monkeypatch)
        spelled = masked = 0
        for i in range(len(ds)):
            np.random.seed(i)
            want = jds[i]
            np.random.seed(i)
            got = ds[i]
            np.testing.assert_array_equal(got["train_loss_mask"],
                                          want["train_loss_mask"])
            caption = byte_tensor_to_object(got["caption_str"])
            assert not got["targets"][0].any()
            if got["train_loss_mask"].any():
                spelled += 1
                assert got["targets"][1:].max() == 1.0
            else:
                masked += 1
                assert caption.endswith(".") or any(
                    w in caption for w in ("zebra", "lighthouse", "umbrella",
                                           "saxophone", "giraffe"))
        assert spelled and masked
    with registries_restored(empty=True):
        with pytest.raises(AssertionError):
            _datasets(layouts["textcaps"], "textcaps", "train", monkeypatch,
                      opts=["dataset_config.textcaps.processors."
                            "answer_processor.params.num_answers=10"])[0][0]
        with pytest.raises(AssertionError):
            _datasets(layouts["textcaps"], "textcaps", "train", monkeypatch,
                      opts=["dataset_config.textcaps.processors."
                            "answer_processor.params.num_answers=10"])[1][0]


def _report(ds, dataset, seed=0):
    """A combined report's fields for four samples of ``ds`` with decoded
    ids over answers, OCR copies and </s>."""
    from mmf_tpu_torch.common.sample import SampleList

    batch = SampleList([ds[i] for i in range(4)])
    rng = np.random.RandomState(seed)
    scores = rng.randn(4, 12, ANSWERS + 50).astype(np.float32)
    eos = ds.datasets[0].answer_processor.EOS_IDX
    scores[0, 3, eos] = 50.0  # an answer that ends at step 3
    scores[1, :, ANSWERS:ANSWERS + 6] += 5.0  # copies
    scores[2, :, 4:8] += 5.0  # vocabulary words
    report = {"scores": scores,
              "question_id": batch["question_id"].numpy(),
              "image_id": batch["image_id"].numpy(),
              "context_tokens": batch["context_tokens"].numpy()}
    for key in ("answers", "ref_strs"):
        if key in batch:
            report[key] = batch[key].numpy()
    return report


METRICS = {"stvqa_anls": "stvqa", "stvqa_accuracy": "stvqa",
           "ocrvqa_accuracy": "ocrvqa", "textcaps_bleu4": "textcaps"}


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metrics_match_jax(layouts, metric, monkeypatch):
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils.distributed import byte_tensor_to_object

    dataset = METRICS[metric]
    with registries_restored(empty=True):
        jds, ds = _datasets(layouts[dataset], dataset, "val", monkeypatch)
        report = _report(ds, dataset)
        gt_key = "ref_strs" if dataset == "textcaps" else "answers"
        unpacked = dict(report, dataset_name=dataset,
                        context_tokens=[byte_tensor_to_object(t) for t in
                                        report["context_tokens"]])
        unpacked[gt_key] = [byte_tensor_to_object(t)
                            for t in report[gt_key]]
        jmetric = jreg.get_metric_class(metric)()
        pmetric = registry.get_metric_class(metric)()
        assert pmetric.name == jmetric.name == metric
        assert pmetric.required_params == jmetric.required_params
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jmetric.calculate(unpacked, unpacked)
            got = pmetric.calculate(dict(report, dataset_name=dataset),
                                    report)
        assert got == want
        # the ground truths themselves, decoded as the decode would give
        # them, score higher
        processor = ds.datasets[0].answer_processor
        gts = [byte_tensor_to_object(t)[0] for t in report[gt_key]]
        scores = np.full((4, 12, ANSWERS + 50), -1.0, np.float32)
        for i, gt in enumerate(gts):
            words = gt.rstrip(".").split()[:11]
            for t, word in enumerate(words):
                scores[i, t, processor.answer_vocab.word2idx(word)] = 1.0
            scores[i, len(words):, processor.EOS_IDX] = 2.0
        perfect = dict(unpacked, scores=scores)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            best = pmetric.calculate(dict(report, dataset_name=dataset),
                                     {"scores": scores})
            assert best == jmetric.calculate(perfect, perfect)
        assert best > got


def test_textcaps_prediction_rows_match_jax(layouts, monkeypatch):
    with registries_restored(empty=True):
        jds, ds = _datasets(layouts["textcaps"], "textcaps", "test",
                            monkeypatch)
        report = _report(ds, "textcaps", seed=1)
        got = ds.datasets[0].format_for_prediction(report)
        want = jds.datasets[0].format_for_prediction(report)
        assert got == want
        assert json.loads(json.dumps(got)) == got
        assert all(set(row) == {"caption_id", "image_id", "caption",
                                "pred_source"} for row in got)


def test_without_ocr_raises_in_m4c_as_in_jax(layouts, monkeypatch):
    """``without_ocr.yaml`` (``use_ocr: false``): the dataset returns
    before it sets any OCR field (``context_feature_0``,
    ``context_info_0``, ``context_tokens``, ``order_vectors``,
    ``ocr_bbox_coordinates``), in both packages; M4C then raises
    ``KeyError: 'context_feature_0'`` in both (ROADMAP C.4)."""
    import jax
    import jax.numpy as jnp
    import torch

    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.common.sample import SampleList

    config = ("projects/m4c_captioner/configs/m4c_captioner/textcaps/"
              "without_ocr.yaml")
    with registries_restored(empty=True):
        jds, ds = _datasets(layouts["textcaps"], "textcaps", "val",
                            monkeypatch, config=config)
        np.random.seed(0)
        want = jds[0]
        np.random.seed(0)
        got = ds[0]
        _assert_same_sample(got, want)
        for key in ("context_feature_0", "context_info_0", "context_tokens",
                    "order_vectors", "ocr_bbox_coordinates"):
            assert key not in got
        assert not np.asarray(got["image_feature_1"]).any()
        small = {"text_bert": {"num_hidden_layers": 1, "hidden_size": 32,
                               "num_attention_heads": 2, "vocab_size": 200},
                 "mmt": {"num_hidden_layers": 1, "hidden_size": 32,
                         "num_attention_heads": 2},
                 "classifier": {"ocr_ptr_net": {"hidden_size": 32,
                                                "query_key_size": 32}},
                 "obj": {"mmt_in_dim": 32}}  # the layout's feature width
        mc = dict(registry.get("config")["model_config"]["m4c_captioner"])
        for key, value in small.items():
            mc[key] = dict(mc[key], **value)
        def arrays(tree):
            return {k: arrays(v) if isinstance(v, dict) else v
                    for k, v in tree.items()
                    if isinstance(v, (dict, torch.Tensor))}

        batch = arrays(SampleList([ds[0], ds[1]]))
        jbatch = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                        batch)
        jm = jreg.get_model_class("m4c_captioner")(config=mc)
        with pytest.raises(KeyError, match="context_feature_0"):
            jm.init(jax.random.PRNGKey(0), jbatch, False)
        model = registry.get_model_class("m4c_captioner")(mc)
        with pytest.raises(KeyError, match="context_feature_0"), \
                torch.no_grad():
            model.eval()(batch)
