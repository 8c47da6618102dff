"""The fusion baselines of Hateful Memes (``concat_bert``,
``late_fusion``, ``concat_bow``, each from its project config) in the
port against the JAX package on the CPU, at a small size
(``tests/torch_hm_models.py``): the f32 eval forward over raw images
(ResNet-152 at 32 px) and over direct features within the repo's 2e-5;
the step-0 gradients and a 4-step AdamW trajectory over direct features
(``identity`` encoder) in float64, where the classifier, the text
encoder, the optimizer groups and the schedule are what differs from
MMBT's path (``tests/test_torch_hm_mmbt.py`` trains the ResNet)."""

import numpy as np
import pytest
import torch

from tests import torch_hm_models as hm

torch.set_num_threads(2)  # several test workers share the host

KEYS = ["concat_bert", "late_fusion", "concat_bow"]
F32_ATOL = 2e-5  # the repo's own parity bar (README)
GRAD_REL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _jax_no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(*hm.jax_no_dropout())
        yield


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("key", KEYS)
def test_forward_matches_jax(key, direct):
    got, want = hm.Pair(key, direct=direct).forwards()
    assert got.shape == want.shape == (hm.B, 2)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.fixture(scope="module", params=KEYS)
def trained(request):
    with hm.x64():
        return hm.train_both(hm.Pair(request.param, f64=True, direct=True))


def test_step0_gradients_match_jax(trained):
    want, got = trained["grads"]
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        err = hm.rel_err(got[name], want[name], floor)
        assert err < GRAD_REL, f"gradient mismatch at {name}: rel {err:.2e}"


def test_trajectory_matches_jax(trained):
    hm.assert_trajectory(trained)


MLP = {"num_layers": 2, "hidden_dim": 12, "dropout": 0.0}
GELU_MLP = {"num_layers": 1, "batch_norm": False, "hidden_act": "gelu",
            "dropout": 0.0}
WEIGHT_NORM = {"hidden_dim": 12, "dropout": 0.0}
CLASSIFIERS = [
    ("mlp", MLP, False), ("mlp", MLP, True), ("mlp", GELU_MLP, False),
    ("linear", {}, False), ("bert", {"hidden_size": 16}, False),
    ("weight_norm", WEIGHT_NORM, False), ("weight_norm", WEIGHT_NORM, True),
]


@pytest.mark.parametrize("ctype,params,train", CLASSIFIERS)
def test_classifier_layer_matches_jax(ctype, params, train):
    """Each ported ``ClassifierLayer`` type from the same weights; in
    training mode (at dropout 0; BERT's head has its fixed rate of 0.1,
    so it is compared in eval mode only) the MLP's BatchNorm normalises
    by the batch and moves its statistics as flax's does."""
    import jax
    import jax.numpy as jnp

    from mmf_tpu.modules.layers import ClassifierLayer as JaxClassifier
    from mmf_tpu_torch.modules.layers import ClassifierLayer

    x = np.random.RandomState(3).randn(6, 10).astype(np.float32)
    jm = JaxClassifier(ctype, 0, 3, params=params)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    variables = hm._fill(shapes, 4)
    tm = ClassifierLayer(ctype, 0, 3, params=params, in_features=10)
    tm.load_state_dict(hm.Pair.state_dict(variables), strict=True)
    hm.port_no_dropout(tm).train(train)
    mutable = ["batch_stats"] if train and "batch_stats" in variables \
        else False
    out = jm.apply(variables, jnp.asarray(x), not train, mutable=mutable)
    want, new = out if mutable else (out, {})
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=F32_ATOL, rtol=0)
    for name, value in hm.Pair.state_dict(
            {"params": {}, **new}).items():
        if "running" in name:
            assert hm.rel_err(tm.state_dict()[name].numpy(),
                              value.numpy()) < 1e-6, name


@pytest.mark.parametrize("ctype", ["logit", "triple_linear",
                                   "language_decoder"])
def test_unported_classifiers_name_their_family(ctype):
    """``triple_linear`` raises, naming its family; ``logit`` (Pythia's)
    and ``language_decoder`` (BUTD's) are ported and build
    (``tests/test_torch_pythia.py``, ``tests/test_torch_butd.py`` hold
    them against JAX)."""
    from mmf_tpu_torch.modules.layers import ClassifierLayer

    if ctype in ("logit", "language_decoder"):
        layer = ClassifierLayer(ctype, 8, 3, in_features=8)
        assert type(layer.module).__name__ == {
            "logit": "LogitClassifier",
            "language_decoder": "LanguageDecoder"}[ctype]
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ClassifierLayer(ctype, 8, 3, in_features=8)


@pytest.mark.parametrize("etype,params", [
    ("vocab", {"embedding_dim": 6, "vocab_size": 20}),
    ("torch", {"embedding_dim": 6, "vocab_size": 20}),
    ("identity", {}),
])
def test_text_embedding_matches_jax(etype, params):
    import jax
    import jax.numpy as jnp

    from mmf_tpu.modules.embeddings import TextEmbedding as JaxEmbedding
    from mmf_tpu_torch.modules.embeddings import TextEmbedding

    x = np.random.RandomState(5).randint(0, 20, (3, 7)).astype(np.int32)
    jm = JaxEmbedding(etype, params)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = TextEmbedding(etype, params)
    tm.load_state_dict(hm.Pair.state_dict(variables), strict=True)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("etype", ["projection", "bilstm", "attention",
                                   "mcan", "preextracted"])
def test_unported_text_embeddings_name_their_module(etype):
    """The unported types raise, naming their module; ``attention``
    (Pythia's), ``projection`` (``ProjectionEmbedding``) and ``bilstm``
    (BAN's ``BiLSTMTextEmbedding``) are ported and build
    (``tests/test_torch_pythia.py``, ``tests/test_torch_mmf_bert.py``,
    ``tests/test_torch_ban.py``)."""
    from mmf_tpu_torch.modules.embeddings import TextEmbedding

    if etype == "bilstm":
        emb = TextEmbedding(etype, {"embedding_dim": 4, "hidden_dim": 6,
                                    "bidirectional": True})
        assert emb.out_dim == 6  # two directions of 3
        assert tuple(emb.module.rnn_0_bwd.ir.weight.shape) == (3, 4)
        return

    if etype == "attention":
        emb = TextEmbedding(etype, {"embedding_dim": 4, "hidden_dim": 4})
        assert emb.out_dim == 4 * 2  # two glimpses by default
        return
    if etype == "projection":
        emb = TextEmbedding(etype, {"in_dim": 4, "out_dim": 6})
        assert emb.out_dim == 6  # the linear form by default
        assert tuple(emb.module.layers.weight.shape) == (6, 4)
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TextEmbedding(etype, {"embedding_dim": 4, "hidden_dim": 4})
