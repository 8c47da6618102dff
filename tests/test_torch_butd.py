"""BUTD against the JAX package on the CPU, from
``configs/models/butd/defaults.yaml`` at small widths (LSTMs 16,
attention 12, words 8, 40 words, 6 steps, 7 regions x 16), f32, dropout
0, on the same weights (a JAX init redrawn from a numpy seed, carried
across by ``params_from_jax``) and seeded numpy inputs:

- teacher-forced scores within atol 2e-5, with and without the regions'
  mask (``image_info_0``'s ``max_features``);
- the greedy decode and the fixed-beam search (k = 3) token for token;
- nucleus sampling: the kept set of each sample's first step equal to
  JAX's (``cum - p < threshold``) on the same probabilities, and, at a
  threshold below every top probability, the greedy decode in both
  packages (the draws cannot match across frameworks);
- ``caption_cross_entropy``'s step-0 gradients at cosine >= 0.99999 and
  a 4-step Adamax trajectory (warmup ``multi_step``, clipping at 0.25)
  within 1e-5 relative, in float64 on both sides (in f32 the
  recurrence's rounding, which Adamax's normalised step scales up where
  a gradient is small, moved the fc7 bias 1.3e-5 relative). The port
  adds ``targets = text[:, 1:]`` as the reference does (ROADMAP C.10);
  JAX's model adds none, so its loss is given the same targets here,
  padded with a 0 at the last step, which the mask past ``caption_len -
  1`` leaves out;
- the weights' round trip through JAX's ``convert_torch_state_dict``;
- the host decoders ``beam_search`` and ``nucleus_sampling``,
  ``caption_cross_entropy``, ``caption_bleu4`` (against JAX's nltk
  metric), ``m4c_caption``, ``language_decoder`` through
  ``ClassifierLayer``, ``VisDialDiscriminator``, and the evaluation step
  that skips the configured loss for a decode's dummy loss.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_caption_models import (
    TRAJ_RTOL,
    assert_grads_match,
    assert_params_match,
    assert_round_trip,
    build,
    grads,
    init_shapes,
    load,
    randomize,
    trajectory,
)
from tests.torch_port_utils import registries_restored, tree_map

torch.set_num_threads(2)  # several test workers share the host

ATOL = 2e-5
V, T, K, D, B = 40, 6, 7, 16, 4
SOS, EOS = 1, 2


def overrides(kind="greedy", **params):
    return {
        "text_vocab_size": V, "max_length": T, "image_feature_dim": D,
        "embedding_dim": 8,
        "classifier": {"type": "language_decoder", "params": {
            "dropout": 0, "hidden_dim": 16, "feature_dim": D,
            "fc_bias_init": 0.3}},
        "image_feature_embeddings": [{"modal_combine": {
            "type": "top_down_attention_lstm",
            "params": {"dropout": 0, "hidden_dim": 16, "attention_dim": 12}},
            "normalization": "softmax",
            "transform": {"type": "linear", "params": {"out_dim": 1}}}],
        "inference": {"type": kind, "params": params}}


def batch(seed=0, mask=True):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, T), np.int64)
    lengths = np.array([6, 4, 5, 3])
    for i, n in enumerate(lengths):
        text[i, 0], text[i, n - 1] = SOS, EOS
        text[i, 1:n - 1] = rng.randint(3, V, n - 2)
    out = {"text": text, "caption_len": lengths.astype(np.int32),
           "image_feature_0": rng.randn(B, K, D).astype(np.float32)}
    if mask:
        out["image_info_0"] = {"max_features": np.array([7, 4, 5, 6])}
    return out


def jax_targets(b):
    """The reference's targets, ``text[:, 1:]``, padded to the scores'
    length for JAX's loss."""
    return dict(b, targets=np.pad(b["text"][:, 1:], ((0, 0), (0, 1))))


@pytest.fixture(scope="module")
def weights():
    """The JAX model's redrawn variables (the same for every inference
    type)."""
    jm = build("jax", "butd", overrides())
    return randomize(init_shapes(jm, jax.random.PRNGKey(0), tree_map(
        jnp.asarray, batch()), False), seed=2)


def pair(weights, kind="greedy", **params):
    return (build("jax", "butd", overrides(kind, **params)), weights,
            load(build("port", "butd", overrides(kind, **params)), weights))


def run(jm, variables, tm, b):
    want = jm.apply(variables, tree_map(jnp.asarray, b), False)
    with torch.no_grad():
        got = tm(tree_map(torch.from_numpy, b))
    return want, got


@pytest.mark.parametrize("mask", [True, False])
def test_teacher_forced_scores_match_jax(weights, mask):
    jm, variables, tm = pair(weights)
    b = batch(3, mask)
    want, got = run(jm, variables, tm, b)
    assert tuple(got["scores"].shape) == (B, T, V)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               atol=ATOL, rtol=0)
    assert_round_trip(variables, tm)


def test_teacher_forcing_pads_to_max_length_and_adds_targets(weights):
    """A text shorter than ``max_length``: the steps past it score 1.0,
    as JAX pads; the batch gains the reference's targets."""
    jm, variables, tm = pair(weights)
    b = dict(batch(4), text=batch(4)["text"][:, :4])
    want, got = run(jm, variables, tm, b)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               atol=ATOL, rtol=0)
    assert bool((got["scores"][:, 4:] == 1.0).all())
    tb = tree_map(torch.from_numpy, b)
    with torch.no_grad():
        tm(tb)
    assert torch.equal(tb["targets"], tb["text"][:, 1:])


def greedy_tokens(jm, variables, tm, b):
    b = {k: v for k, v in b.items() if k != "text"}
    want, got = run(jm, variables, tm, b)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               atol=ATOL, rtol=0)
    return np.asarray(want["scores"]).argmax(-1), got["scores"].argmax(-1)


def test_greedy_decode_matches_jax(weights):
    want, got = greedy_tokens(*pair(weights), batch(5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len({tuple(row) for row in want.tolist()}) > 1  # not degenerate


@pytest.mark.parametrize("mask", [True, False])
def test_beam_search_matches_jax(weights, mask):
    jm, variables, tm = pair(weights, "beam_search", beam_length=3)
    b = batch(6, mask)
    want, got = run(jm, variables, tm, b)
    assert set(got) == {"captions", "losses"}
    np.testing.assert_array_equal(got["captions"].numpy(),
                                  np.asarray(want["captions"]))
    assert list(got["losses"]) == list(want["losses"])
    assert float(got["losses"]["test/unknown/dummy_loss"].abs().sum()) == 0


def test_nucleus_kept_set_matches_jax(weights):
    """JAX's expressions for the kept set (``mmf_tpu/models/butd.py``'s
    nucleus branch) and the port's ``nucleus`` on the same first-step
    probabilities, at several thresholds."""
    from mmf_tpu_torch.models.butd import nucleus

    jm, variables, tm = pair(weights)
    want, _ = run(jm, variables, tm, {k: v for k, v in batch(7).items()
                                      if k != "text"})
    probs = jax.nn.softmax(jnp.asarray(want["scores"][:, 0]), axis=-1)
    for p in (0.05, 0.3, 0.5, 0.9, 1.0):
        order = jnp.argsort(-probs, axis=-1)
        sorted_p = jnp.take_along_axis(probs, order, axis=-1)
        keep = (jnp.cumsum(sorted_p, axis=-1) - sorted_p) < p
        got_order, kept = nucleus(torch.from_numpy(np.asarray(probs)), p)
        for i in range(B):
            want_set = set(np.asarray(order[i])[np.asarray(keep[i])].tolist())
            got_set = set(got_order[i][kept[i] > 0].tolist())
            assert got_set == want_set, (p, i)


def test_nucleus_below_every_top_probability_is_greedy(weights):
    """At a threshold below every top probability only the top word is
    kept: the decode is the greedy one (EOS once finished) in both
    packages."""
    from mmf_tpu_torch.utils.text import sampling_generator

    jm, variables, tm = pair(weights, "nucleus_sampling",
                             sum_threshold=1e-6)
    b = {k: v for k, v in batch(8).items() if k != "text"}
    want, got_greedy = greedy_tokens(*pair(weights), b)
    finished = np.cumsum(want == EOS, axis=1) - (want == EOS) > 0
    expected = np.where(finished, EOS, want)
    jax_caps = np.asarray(jm.apply(variables, tree_map(jnp.asarray, b),
                                   False, rngs={"sampling":
                                                jax.random.PRNGKey(3)})[
        "captions"])
    with torch.no_grad(), sampling_generator(
            torch.Generator().manual_seed(3)):
        port_caps = tm(tree_map(torch.from_numpy, b))["captions"].numpy()
    np.testing.assert_array_equal(jax_caps, expected)
    np.testing.assert_array_equal(port_caps, expected)


def test_nucleus_sampling_draws_from_the_generator(weights):
    """The draws come from the installed generator: the same seed gives
    the same captions, and every word drawn lies in its step's kept set
    (the decode is fed back, so each step's set is the port's own)."""
    from mmf_tpu_torch.utils.text import sampling_generator

    _, _, tm = pair(weights, "nucleus_sampling", sum_threshold=0.9)
    b = tree_map(torch.from_numpy, {k: v for k, v in batch(9).items()
                                    if k != "text"})
    caps = []
    for seed in (4, 4, 5):
        with torch.no_grad(), sampling_generator(
                torch.Generator().manual_seed(seed)):
            caps.append(tm(dict(b))["captions"])
    assert torch.equal(caps[0], caps[1]) and caps[0].shape == (B, T)
    assert not torch.equal(caps[0], caps[2])


def _train_batch():
    b = batch(10)
    return b, jax_targets(b)


def test_gradients_match_jax(weights):
    jm, variables, _ = pair(weights)
    tm = load(build("port", "butd", overrides()), variables)
    b, jb = _train_batch()
    want, got = grads(jm, variables, tm, b, jb, ["caption_cross_entropy"])
    assert_grads_match(want, got)


def test_adamax_trajectory_matches_jax(weights):
    jm, variables, _ = pair(weights)
    tm = load(build("port", "butd", overrides()), variables)
    b, jb = _train_batch()
    j_losses, t_losses, want = trajectory(jm, variables, tm, b, jb,
                                          ["caption_cross_entropy"],
                                          f64=True)
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    assert len(set(np.round(t_losses, 6))) > 1
    assert_params_match(tm, want)


class _Vocab:
    SOS_INDEX, EOS_INDEX = 1, 2

    def get_size(self):
        return 6


def test_host_decoders_match_jax():
    """``beam_search`` and ``nucleus_sampling`` over the same logits
    (numpy state; the sampler's generator is numpy's, seeded 0, in both):
    the same beams, scores, finished sequences and draws."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.utils import text as jtext
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils import text as ptext

    assert registry.get_decoder_class("beam_search") is ptext.BeamSearch
    assert registry.get_decoder_class("nucleus_sampling") is \
        ptext.NucleusSampling
    assert jreg.get_decoder_class("beam_search") is jtext.BeamSearch
    rng = np.random.RandomState(11)
    config = {"inference": {"params": {"beam_length": 3,
                                       "sum_threshold": 0.6}}}
    got, want = ptext.BeamSearch(_Vocab(), config), jtext.BeamSearch(
        _Vocab(), config)
    got.init_batch(None), want.init_batch(None)
    for t in range(4):
        logits = rng.randn(len(want.seqs), 6).astype(np.float32) * 2
        fg, _, kg = got.decode(t, None, logits)
        fw, _, kw = want.decode(t, None, logits)
        assert fg == fw
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_array_equal(got.seqs, want.seqs)
        np.testing.assert_array_equal(got.top_k_scores, want.top_k_scores)
        if fw:
            break
    assert got.complete_seqs == want.complete_seqs
    np.testing.assert_array_equal(got.get_result(), want.get_result())
    got, want = (ptext.NucleusSampling(_Vocab(), config),
                 jtext.NucleusSampling(_Vocab(), config))
    for _ in range(6):
        logits = np.log(rng.dirichlet(np.ones(6), 1))
        assert got.decode(0, None, logits)[0] == want.decode(0, None,
                                                             logits)[0]
    assert got.seq == want.seq


def test_caption_cross_entropy_matches_jax():
    from mmf_tpu.modules.losses import CaptionCrossEntropyLoss as JLoss
    from mmf_tpu_torch.modules.losses import CaptionCrossEntropyLoss

    rng = np.random.RandomState(12)
    scores = rng.randn(3, 5, 7).astype(np.float32)
    targets = rng.randint(0, 7, (3, 5))
    for sample in ({"targets": targets},
                   {"targets": targets,
                    "caption_len": np.array([6, 3, 1], np.int32)}):
        want = float(JLoss()(tree_map(jnp.asarray, sample),
                             {"scores": jnp.asarray(scores)}))
        got = float(CaptionCrossEntropyLoss()(
            tree_map(torch.from_numpy, sample),
            {"scores": torch.from_numpy(scores)}))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # targets a step shorter than the scores (BUTD's): the scores are cut
    short = {"targets": targets[:, :4],
             "caption_len": np.array([5, 3, 1], np.int32)}
    want = float(JLoss()(tree_map(jnp.asarray, dict(short, targets=np.pad(
        short["targets"], ((0, 0), (0, 1))))), {"scores": jnp.asarray(
            scores)}))
    got = float(CaptionCrossEntropyLoss()(tree_map(torch.from_numpy, short),
                                          {"scores": torch.from_numpy(
                                              scores)}))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _caption_vocab(tmp_path):
    words = ["a", "man", "dog", "on", "the", "street", "red", "bus"]
    folder = tmp_path / "vocabs"
    folder.mkdir()
    (folder / "captions.txt").write_text("\n".join(words) + "\n")
    return {"vocab": {"type": "random", "vocab_file": "vocabs/captions.txt",
                      "data_dir": str(tmp_path)}}


def test_caption_bleu4_matches_jax(tmp_path):
    """Corpus BLEU-4 of decoded captions (and of the scores' argmax)
    against five references a sample, both decoded by the registry's
    ``coco_caption_processor``: the port's own corpus BLEU against JAX's
    nltk metric."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.modules.metrics import CaptionBleu4Metric as JMetric
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.modules.metrics import CaptionBleu4Metric

    config = _caption_vocab(tmp_path)
    rng = np.random.RandomState(13)

    def ids(n):
        out = np.zeros((n, 9), np.int64)
        for i in range(n):
            k = rng.randint(3, 8)
            out[i, 0], out[i, k + 1] = 1, 2
            out[i, 1:k + 1] = rng.randint(4, 12, k)
        return out

    answers = np.stack([ids(5) for _ in range(6)])
    captions = answers[:, 0].copy()
    captions[::2, 2] = 5
    scores = np.eye(12, dtype=np.float32)[answers[:, 1]]
    with registries_restored():
        for reg, cls in ((jreg, "mmf_tpu"), (registry, "mmf_tpu_torch")):
            proc = reg.get_processor_class("caption")(config)
            reg.register("coco_caption_processor", proc)
        for output in ({"captions": captions}, {"scores": scores}):
            want = JMetric().calculate({"answers": answers}, output)
            got = CaptionBleu4Metric().calculate({"answers": answers},
                                                 output)
            assert 0.0 < want <= 1.0
            assert got == pytest.approx(want, abs=1e-12)


def test_m4c_caption_processor_matches_jax(tmp_path):
    """``m4c_caption``: captions tokenised with its regex (``'s`` split
    off; ``,``, ``?`` and ``.`` dropped), unknown words spelled ``<unk>``
    rather than dropping the caption, every caption scoring 1.0."""
    import mmf_tpu.datasets.processors.processors as JP
    import mmf_tpu_torch.datasets.processors.processors as PP

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["<pad>", "<s>", "</s>", "<unk>", "a", "man",
                                "'s", "sign", "stop"]) + "\n")
    config = {"vocab_file": str(vocab), "preprocessor": {
        "type": "simple_word", "params": {}}, "max_length": 10,
        "max_copy_steps": 8, "num_answers": 1}
    got_p = PP.M4CCaptionProcessor(config)
    want_p = JP.M4CCaptionProcessor(config)
    items = [{"answers": ["a man's stop sign."], "tokens": ["stop", "exit"]},
             {"answers": ["A zebra, by the exit?"], "tokens": ["exit"]},
             {"answers": [], "tokens": []}]
    for item in items:
        assert got_p.tokenize(item["answers"][0] if item["answers"]
                              else "") == want_p.tokenize(
            item["answers"][0] if item["answers"] else "")
        np.random.seed(0)
        got = got_p(dict(item))
        np.random.seed(0)
        want = want_p(dict(item))
        assert set(got) == set(want)
        for key in want:
            if isinstance(want[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key], key)
            else:
                assert got[key] == want[key], key
    assert got_p.compute_answer_scores(["x", "y"]) == {"x": 1.0, "y": 1.0}
    # a caption with a word in neither the vocabulary nor the OCR tokens
    # is still spelled, through <unk>
    spelled = got_p(dict(items[1]))["sampled_idx_seq"]
    assert 3 in spelled


def test_language_decoder_and_visdial_match_jax():
    """``language_decoder`` through ``ClassifierLayer`` (one step of the
    LSTM on [attended, h1], dropout, the weight-normalised ``fc`` with a
    gain an output) and ``VisDialDiscriminator``."""
    from mmf_tpu.modules.decoders import VisDialDiscriminator as JVis
    from mmf_tpu.modules.layers import ClassifierLayer as JClassifier
    from mmf_tpu_torch.modules.decoders import VisDialDiscriminator
    from mmf_tpu_torch.modules.layers import ClassifierLayer
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    rng = np.random.RandomState(14)
    x = rng.randn(3, 10).astype(np.float32)
    h = [rng.randn(3, 6).astype(np.float32) for _ in range(4)]
    params = {"dropout": 0.0, "hidden_dim": 6, "fc_bias_init": 0.25}

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, x, h1, c1, h2, c2):
            state = {"td_hidden": (h1, c1), "lm_hidden": (h2, c2)}
            out, state = JClassifier("language_decoder", 10, 9, params,
                                     name="classifier")(x, state=state)
            return out, state["lm_hidden"]

    inputs = [jnp.asarray(v) for v in [x] + h]
    init = Flax().init(jax.random.PRNGKey(0), *inputs)
    variables = randomize(init, 3)
    port = ClassifierLayer("language_decoder", 0, 9, params, in_features=10)
    assert float(port.module.Dense_0.bias[0]) == 0.25  # fc_bias_init
    assert np.allclose(np.asarray(init["params"]["classifier"]["module"][
        "Dense_0"]["bias"]), 0.25)
    port.load_state_dict(params_from_jax(variables["params"]["classifier"]),
                         strict=True)
    want, (wh, wc) = Flax().apply(variables, *inputs)
    t = [torch.from_numpy(v) for v in h]
    with torch.no_grad():
        got, state = port.eval()(torch.from_numpy(x), {
            "td_hidden": (t[0], t[1]), "lm_hidden": (t[2], t[3])})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(state["lm_hidden"][0].numpy(), wh, atol=1e-6)
    np.testing.assert_allclose(state["lm_hidden"][1].numpy(), wc, atol=1e-6)

    options = rng.randn(3, 4, 5).astype(np.float32)
    enc = rng.randn(3, 7).astype(np.float32)
    jv = JVis(7)
    variables = randomize(init_shapes(jv, jax.random.PRNGKey(1),
                                      jnp.asarray(enc), jnp.asarray(options)),
                          4)
    pv = VisDialDiscriminator(5, 7)
    pv.load_state_dict(params_from_jax(variables["params"]), strict=True)
    with torch.no_grad():
        got = pv(torch.from_numpy(enc), torch.from_numpy(options))
    np.testing.assert_allclose(got.numpy(), jv.apply(
        variables, jnp.asarray(enc), jnp.asarray(options)), atol=1e-5)


def test_beam_eval_skips_the_configured_caption_loss(weights):
    """JAX's contract (``tests/models/test_model_zoo.py::
    test_butd_beam_eval_with_configured_caption_loss``) on both sides:
    the decode returns ``captions`` and a dummy loss, no ``scores``, and
    the evaluation step skips the configured ``caption_cross_entropy``
    instead of failing on the missing scores."""
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu.trainers.core.train_state import make_eval_step as j_eval
    from mmf_tpu_torch.modules.losses import Losses
    from mmf_tpu_torch.trainers.core.train_state import make_eval_step

    jm, variables, tm = pair(weights, "beam_search", beam_length=2)
    b = dict(batch(15), targets=batch(15)["text"])
    meta = {"dataset_name": "coco", "dataset_type": "val"}
    config = [{"type": "caption_cross_entropy"}]
    want = j_eval(lambda v, x, train, **kw: jm.apply(v, x, train, **kw),
                  JLosses(config), meta=meta)(variables, tree_map(
                      jnp.asarray, b))
    got = make_eval_step(Losses(config), meta=meta)(
        tm, tree_map(torch.from_numpy, b),
        torch.Generator().manual_seed(0))
    for out in (want, got):
        assert "captions" in out and "scores" not in out
        assert list(out["losses"]) == ["val/coco/dummy_loss"]
    np.testing.assert_array_equal(got["captions"].numpy(),
                                  np.asarray(want["captions"]))


def test_evaluation_draws_a_fresh_sampling_stream_a_batch():
    """The trainer gives each evaluation batch its own generator, from
    the run's seed and the count of batches evaluated: the same stream in
    two runs of one seed, another at every batch (JAX folds the count
    into its evaluation key)."""
    from mmf_tpu_torch.trainers.mmf_trainer import MMFTrainer

    class Run:
        seed, device = 7, torch.device("cpu")

    seeds = [[MMFTrainer._sampling_generator(run).initial_seed()
              for _ in range(3)] for run in (Run(), Run())]
    assert seeds[0] == seeds[1] and len(set(seeds[0])) == 3
    other = Run()
    other.seed = 8
    assert MMFTrainer._sampling_generator(other).initial_seed() != \
        seeds[0][0]
