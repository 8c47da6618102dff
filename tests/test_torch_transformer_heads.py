"""The transformer heads of the port against the JAX package's on the
CPU: every registered head built from the same config, its flax params
carried across by ``params_from_jax``, the same numpy sequence output
and labels through both; and ``build_heads_dict``'s list and
per-dataset forms inside a model scope, where flax names the heads.
Bars: f32 outputs atol 2e-5, losses rtol 1e-5 (atol 1e-6 near 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import tree_map

torch.set_num_threads(2)  # several test workers share the host

ATOL = 2e-5
B, T, R, H, V = 3, 5, 4, 32, 50  # text and region positions, width, vocab


def _inputs(seed=0):
    """(sequence output [B, T + R, H], a sample list with every head's
    labels), numpy."""
    rng = np.random.RandomState(seed)
    seq = rng.randn(B, T + R, H).astype(np.float32)
    lm = np.full((B, T + R), -1, np.int32)
    lm[:, 1] = rng.randint(0, V, B)
    lm[0, 3] = 7
    probs = rng.rand(B, R, 6).astype(np.float32)
    probs[:, :, 0] = 0.0  # the KLD's zero-target branch
    probs /= probs.sum(-1, keepdims=True)
    txt_pad = np.zeros((B, T), bool)
    txt_pad[0, T - 2:] = True
    img_pad = np.zeros((B, R), bool)
    img_pad[1, R - 1:] = True
    masks = {"text": (~txt_pad).astype(np.int32),
             "image": (~img_pad).astype(np.int32)}
    return seq, {
        "mlm_labels": {"combined_labels": lm},
        "hs_masked_for_mlm": rng.randn(B, T + R, H).astype(np.float32),
        "is_correct": np.array([1, 0, 1], np.int32),
        "mrc_labels": {"targets": probs,
                       "is_masked": np.array([[1, 0, 1, 0], [0, 0, 1, 1],
                                              [1, 1, 0, 0]], bool)},
        "mrfr_labels": {"targets": rng.randn(B, R, 12).astype(np.float32),
                        "is_masked": np.array([[0, 1, 1, 0], [1, 0, 0, 0],
                                               [0, 0, 1, 1]], bool)},
        "wra_info": {"txt_len": (~txt_pad).sum(1), "img_len":
                     (~img_pad).sum(1), "txt_pad": txt_pad,
                     "img_pad": img_pad,
                     "is_correct": np.array([1, 0, 1], np.int32)},
        "contrastive_labels": np.array([0, 2, -1], np.int32),
        "masks": masks,
        "targets": np.eye(4, dtype=np.float32)[[0, 3, 1]],
        "dataset_name": "ds_a", "dataset_type": "train",
    }


MLP = {"type": "mlp", "in_dim": H, "hidden_size": 24, "num_labels": 4,
       "hidden_dropout_prob": 0.0}
CASES = {  # name -> (head config, takes the shared embedding)
    "mlm": ({"type": "mlm", "hidden_size": H, "vocab_size": V}, False),
    "mlm_tied": ({"type": "mlm", "hidden_size": H, "vocab_size": V}, True),
    "mlm_label_key": ({"type": "mlm", "hidden_size": H, "vocab_size": V,
                       "label_key": "lm", "loss_name": "lm_loss"}, False),
    "mlm_multi": ({"type": "mlm_multi", "hidden_size": H,
                   "vocab_size": V}, False),
    "mlm_multi_tied": ({"type": "mlm_multi", "hidden_size": H,
                        "vocab_size": V}, True),
    "mlp": (MLP, False),
    "multilayer_mlp": (dict(MLP, type="multilayer_mlp", num_layers=3),
                       False),
    "mlp_identity": (dict(MLP, pooler_name="identity"), False),
    "itm": ({"type": "itm", "hidden_size": H}, False),
    "itm_labels_dict": ({"type": "itm", "hidden_size": H,
                         "itm_label_key": "matched"}, False),
    "mrc": ({"type": "mrc", "hidden_size": H}, False),
    "mrfr": ({"type": "mrfr", "hidden_size": H}, False),
    "wra": ({"type": "wra"}, False),
    "contrastive": ({"type": "contrastive", "hidden_size": H}, False),
    "contrastive_three_way": ({"type": "contrastive_three_way",
                               "hidden_size": H}, False),
    "refiner": ({"type": "refiner", "hidden_size": H}, False),
    "refiner_no_masks": ({"type": "refiner", "hidden_size": H,
                          "modalities": ["text", "image", "audio"]}, False),
    "refiner_classifier": (dict(MLP, type="refiner_classifier",
                                hidden_size=H, in_dim=H), False),
    "refnet_classifier": ({"type": "refnet_classifier",
                           "refiner_config": {"hidden_size": H},
                           "mlp_config": MLP}, False),
}


def _heads(package):
    if package == "jax":
        from mmf_tpu.common.registry import registry
        from mmf_tpu.utils.env import setup_imports
    else:
        from mmf_tpu_torch.common.registry import registry
        from mmf_tpu_torch.utils.env import setup_imports
    setup_imports()
    return registry


def _sample(case, sl):
    sl = dict(sl)
    if case == "mlm_label_key":
        sl["lm"] = sl["mlm_labels"]["combined_labels"]
    if case == "itm_labels_dict":
        sl["itm_labels"] = {"matched": sl.pop("is_correct")}
    if case == "refiner_no_masks":
        sl.pop("masks")
    return sl


def _compare(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "losses":
            assert list(got[key]) == list(value)
            for name, loss in value.items():
                np.testing.assert_allclose(float(got[key][name]),
                                           float(loss), rtol=1e-5,
                                           atol=1e-6, err_msg=name)
        else:
            assert tuple(got[key].shape) == tuple(value.shape), key
            np.testing.assert_allclose(got[key].detach().numpy(),
                                       np.asarray(value), atol=ATOL,
                                       rtol=0, err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_head_matches_jax(case):
    config, tied = CASES[case]
    seq, sl = _inputs()
    sl = _sample(case, sl)
    jhead = _heads("jax").get_transformer_head_class(config["type"])(
        config=dict(config))
    thead = _heads("port").get_transformer_head_class(config["type"])(
        config=dict(config))
    rng = np.random.RandomState(1)
    table = rng.randn(V, H).astype(np.float32) * 0.1
    jkw = {"shared_embedding": jnp.asarray(table)} if tied else {}
    jsl = tree_map(lambda x: x if isinstance(x, str) else jnp.asarray(x), sl)
    variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(seq),
                           processed_sample_list=jsl, **jkw)
    want = jhead.apply(variables, jnp.asarray(seq),
                       processed_sample_list=jsl, **jkw)
    if tied:
        thead.tie_embeddings()
    tsl = tree_map(lambda x: x if isinstance(x, str) else
                   torch.from_numpy(np.asarray(x)), sl)
    thead.materialize(tsl)
    params = variables.get("params", {})
    thead.load_state_dict(params_from_jax(jax.device_get(params)),
                          strict=True)
    tkw = {"shared_embedding": torch.from_numpy(table)} if tied else {}
    with torch.no_grad():
        got = thead.eval()(torch.from_numpy(seq), processed_sample_list=tsl,
                           **tkw)
    _compare(got, want)


def test_masked_ce_is_zero_without_a_valid_label():
    from mmf_tpu.models.transformers.heads.heads import _masked_ce as jce
    from mmf_tpu_torch.models.transformers.heads.heads import _masked_ce

    logits = np.random.RandomState(0).randn(2, 3, 7).astype(np.float32)
    labels = np.full((2, 3), -1, np.int32)
    got = _masked_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(got) == 0.0 == float(jce(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    labels[1, 2] = 4
    np.testing.assert_allclose(
        float(_masked_ce(torch.from_numpy(logits),
                         torch.from_numpy(labels))),
        float(jce(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


DICTS = {  # name -> head configs in build_heads_dict's two forms
    "list": [dict(MLP, loss="bce"), {"type": "itm", "hidden_size": H},
             dict(MLP, num_labels=2)],
    "per_dataset": {"ds_a": [dict(MLP, loss="bce"),
                             {"type": "mrc", "hidden_size": H}],
                    "ds_b": {"type": "mlp", "in_dim": H, "hidden_size": 16,
                             "num_labels": 3}},
    "named": [dict(MLP, head_name="answers", loss="bce"),
              dict(MLP, head_name="answers", num_labels=6),
              {"type": "contrastive", "hidden_size": H}],
}
LOSSES = {"bce": "logit_bce"}


def _jax_scope(head_configs):
    """A flax module holding ``build_heads_dict``'s heads the way ViLT
    and MMFT do (unnamed, in the compact scope)."""
    import flax.linen as nn

    from mmf_tpu.models.transformers.base import build_heads_dict

    class Scope(nn.Module):
        @nn.compact
        def __call__(self, seq, sl):
            heads = build_heads_dict(head_configs, [], losses=LOSSES)
            return heads(sl["dataset_name"], seq, sl), heads

    return Scope()


@pytest.mark.parametrize("form", sorted(DICTS))
def test_heads_dict_matches_jax(form):
    from mmf_tpu_torch.models.transformers.base import (
        BaseTransformer,
        build_heads_dict,
    )

    seq, sl = _inputs()
    jsl = tree_map(lambda x: x if isinstance(x, str) else jnp.asarray(x), sl)
    scope = _jax_scope(DICTS[form])
    variables = scope.init(jax.random.PRNGKey(0), jnp.asarray(seq), jsl)
    want, jheads = scope.apply(variables, jnp.asarray(seq), jsl)

    _heads("port")
    heads = build_heads_dict(DICTS[form], [], losses=LOSSES)
    assert heads.head_names == jheads.head_names
    assert heads.head_loss_names == jheads.head_loss_names
    # the heads the dataset calls are the ones flax made params for
    called = {heads.scopes[n] for n in heads.names_for("ds_a")}
    assert called == set(variables["params"])
    model = BaseTransformer()
    model.add_heads(heads)
    tsl = tree_map(lambda x: x if isinstance(x, str) else
                   torch.from_numpy(np.asarray(x)), sl)
    model.materialize(tsl)
    state = params_from_jax(jax.device_get(variables["params"]))
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected
    assert all(k.split(".")[0] not in called for k in missing)
    with torch.no_grad():
        got = heads("ds_a", torch.from_numpy(seq), tsl)
    _compare(got, want)
