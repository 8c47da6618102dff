"""The port's VQA2 processors against JAX's, field for field.

``bert_tokenizer``: the port's plain-Python WordPiece tokenizer against
JAX's processor, which wraps Hugging Face's ``BertTokenizerFast`` on the
same vocab file: on ``tests/data/vocab.txt`` and on a generated
vocabulary, over hypothesis-drawn text (upper case, accents,
punctuation, CJK, control and format characters, runs of whitespace,
special tokens, words over 100 characters) at ``max_seq_length`` 8 and
128. ``vqa_answer``, ``simple_word``, ``simple_sentence`` and ``bbox``
against JAX's. All fields must be equal.
"""

import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mmf_tpu.common.registry import registry as jax_registry
from mmf_tpu.utils.env import setup_imports as jax_setup_imports
from mmf_tpu_torch.common.registry import registry as port_registry
from mmf_tpu_torch.utils.env import setup_imports as port_setup_imports

jax_setup_imports()
port_setup_imports()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_VOCAB = os.path.join(REPO, "tests", "data", "vocab.txt")

_WORDS = ["hello", "world", "play", "the", "man", "café", "naïve", "über",
          "ΟΔΟΣ", "straße", "中", "文", "un", "##able", "##ing", "##s",
          "##ed", "a", "b"]
_CHARS = (
    "abcxyzABCXYZ0189"          # letters and digits
    "éÉöÖñÑåÅçÇüÜİıßÆøŁ"        # accents, dotted I, ligatures
    "ΣσςΑω"                     # Greek, final sigma
    "!?.,;:'\"()[]{}<>@#$%^&*-_=+/\\|`~"  # ASCII punctuation
    "¿¡—–“”«»…·§"               # Unicode punctuation and symbols
    "中文字日本語한국"             # CJK ideographs and Hangul
    "\x00\x01\x07\x1b\x7f\u200b\u00ad\ufffd\u2060"  # removed characters
    " \t\n\r\u00a0\u3000\u2028\u2029\x0b\x0c"  # whitespace
)
_SPECIAL = ["[MASK]", "[CLS]", "[SEP]", "[UNK]", "[PAD]", "[mask]"]


@pytest.fixture(scope="module")
def generated_vocab(tmp_path_factory):
    """A BERT-style vocabulary: the special tokens, words, ``##`` pieces,
    punctuation, single characters and CJK ideographs."""
    tokens = ["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += [w.lower() for w in _WORDS]
    tokens += ["cafe", "naive", "uber", "οδος", "strasse", "istanbul", "i"]
    tokens += [c for c in "!?.,;:'\"()[]{}<>@#$%^&*-_=+/\\|`~¿¡—–“”«»…·"]
    tokens += [c for c in "abcxyz0189"] + ["##" + c for c in "abcxyz0189"]
    tokens += ["中", "文", "字", "日", "本", "語", "ς", "σ", "ω", "α"]
    tokens = list(dict.fromkeys(tokens))
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(tokens) + "\n")
    return str(path)


def _bert_config(vocab_file, max_seq_length):
    return {
        "tokenizer_config": {"type": "bert-base-uncased",
                             "params": {"do_lower_case": True,
                                        "vocab_file": vocab_file}},
        "max_seq_length": max_seq_length,
    }


def _processor(registry, key, config, **kwargs):
    return registry.get_processor_class(key)(config, **kwargs)


def _assert_fields_equal(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                          err_msg=key)
            assert np.asarray(got[key]).dtype == want[key].dtype, key
        else:
            assert got[key] == want[key], key


_text = st.lists(
    st.one_of(
        st.sampled_from(_WORDS),
        st.sampled_from(_SPECIAL),
        st.text(alphabet=_CHARS, min_size=1, max_size=12),
        st.text(alphabet="abcéÖ中", min_size=95, max_size=110),
    ),
    max_size=12,
).flatmap(lambda parts: st.lists(
    st.sampled_from(["", " ", "  \t", "\n", "\u3000", "-", "\x00"]),
    min_size=len(parts), max_size=len(parts),
).map(lambda seps: "".join(p + s for p, s in zip(parts, seps))))


@pytest.mark.parametrize("max_seq_length", [8, 128])
@pytest.mark.parametrize("vocab", ["data", "generated"])
def test_bert_tokenizer_matches_jax(vocab, max_seq_length, generated_vocab):
    vocab_file = DATA_VOCAB if vocab == "data" else generated_vocab
    config = _bert_config(vocab_file, max_seq_length)
    jax_proc = _processor(jax_registry, "bert_tokenizer", config)
    port_proc = _processor(port_registry, "bert_tokenizer", config)
    assert port_proc.get_vocab_size() == jax_proc.get_vocab_size()

    @settings(max_examples=150, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(text=_text)
    def check(text):
        _assert_fields_equal(port_proc({"text": text}),
                             jax_proc({"text": text}))
        assert port_proc.tokenize(text) == jax_proc.tokenize(text)

    check()
    pair = {"text": "Hello WORLD, naïve café!", "text_b": "über straße"}
    _assert_fields_equal(port_proc(pair), jax_proc(pair))
    tokens = {"tokens": ["Hello", "world", "[MASK]"]}
    _assert_fields_equal(port_proc(tokens), jax_proc(tokens))


def test_tokenizer_name_alone_raises():
    config = {"tokenizer_config": {"type": "bert-base-uncased",
                                   "params": {"do_lower_case": True}}}
    with pytest.raises(ValueError, match="vocab_file"):
        _processor(port_registry, "bert_tokenizer", config)


@pytest.fixture(scope="module")
def answers_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("answers") / "answers.txt"
    path.write_text("<unk>\nyes\nno\nred\nblue\ntwo\nman's hat\n")
    return str(path)


@settings(max_examples=100, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(answers=st.lists(
    st.sampled_from(["yes", "no", "Red", "blue?", "two", "Man's hat",
                     "three", "yes,", "", "green"]),
    min_size=1, max_size=10))
def test_vqa_answer_matches_jax(answers, answers_file):
    config = {"vocab_file": answers_file, "num_answers": 10,
              "preprocessor": {"type": "simple_word", "params": {}}}
    jax_proc = _processor(jax_registry, "vqa_answer", config)
    port_proc = _processor(port_registry, "vqa_answer", config)
    got = port_proc({"answers": list(answers)})
    want = jax_proc({"answers": list(answers)})
    _assert_fields_equal(got, want)
    assert port_proc.get_vocab_size() == jax_proc.get_vocab_size()
    assert [port_proc.idx2word(i) for i in range(7)] == [
        jax_proc.idx2word(i) for i in range(7)]


@settings(max_examples=100, deadline=None, derandomize=True)
@given(text=st.text(alphabet=_CHARS + "sS", max_size=40))
def test_simple_word_and_sentence_match_jax(text):
    for key in ("simple_word", "simple_sentence"):
        got = _processor(port_registry, key, {})({"text": text})
        want = _processor(jax_registry, key, {})({"text": text})
        assert got == want, key


@pytest.mark.parametrize("n_boxes", [0, 3, 50, 60])
def test_bbox_matches_jax(n_boxes):
    info = {"bbox": np.random.RandomState(n_boxes).rand(n_boxes, 4)
            .astype(np.float32)}
    config = {"max_length": 50}
    got = _processor(port_registry, "bbox", config)({"info": dict(info)})
    want = _processor(jax_registry, "bbox", config)({"info": dict(info)})
    _assert_fields_equal(got, want)
