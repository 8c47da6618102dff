"""MMFTransformer in the port against the JAX package on the CPU: a
small MMFT (2 layers, width 32, a text modality and a 16-wide feature
modality) initialised in JAX, its params carried across by
``params_from_jax``, the same numpy inputs through both. f32: outputs
atol 2e-5, losses rtol 1e-5, step-0 gradients relative 5e-4 over a floor
of 1e-3 of the global scale, a 4-step AdamW trajectory (losses rtol
2e-4, parameters relative 1e-3). bf16 (the config's default dtype), with
``MMF_TPU_GELU`` and f32 attention logits pinned on the JAX side: atol
3e-2, as VisualBERT's bf16 test. The trunk's dropout rates come from
``TransformerConfig`` (no config key reaches them), so the JAX side's
configs are built at rate 0 where gradients are compared."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.test_torch_vilt import (  # noqa: F401 (a fixture)
    _rel_err,
    jax_no_dropout,
    port_no_dropout,
    trajectory,
)
from tests.torch_port_utils import cached_init, tree_map

torch.set_num_threads(2)  # several test workers share the host

META = {"dataset_name": "vqa2", "dataset_type": "train"}
F32_ATOL, BF16_ATOL = 2e-5, 3e-2
B, T, R, V = 4, 6, 4, 100
MODALITIES = [
    {"type": "text", "key": "text", "position_dim": 64, "embedding_dim": 32,
     "segment_id": 0, "hidden_dropout_prob": 0.0},
    {"type": "image", "key": "image", "embedding_dim": 16,
     "position_dim": 1, "segment_id": 1, "hidden_dropout_prob": 0.0},
]
MLP = {"type": "mlp", "in_dim": 32, "hidden_size": 32, "num_labels": 3,
       "hidden_dropout_prob": 0.0}
HEADS = {
    "mlp": [MLP],
    "mlm_itm": [{"type": "mlm", "hidden_size": 32, "vocab_size": V},
                {"type": "itm", "hidden_size": 32}],
    "mlp_mlm_multi": [MLP, {"type": "mlm_multi", "hidden_size": 32,
                            "vocab_size": V}],
    "mlm_untied": [{"type": "mlm", "hidden_size": 32, "vocab_size": V}],
    "per_dataset": {"vqa2": [MLP, {"type": "itm", "hidden_size": 32}],
                    "other": [dict(MLP, num_labels=5)]},
}


def _config(load_yaml, heads, **overrides):
    mc = load_yaml("configs/models/mmf_transformer/defaults.yaml")[
        "model_config"]["mmf_transformer"]
    mc.update({"hidden_size": 32, "num_hidden_layers": 2,
               "num_attention_heads": 4, "vocab_size": V,
               "dtype": "float32", "modalities": MODALITIES, "heads": heads})
    mc.update(overrides)
    return mc


def _model(package, heads, **overrides):
    if package == "jax":
        from mmf_tpu.common.registry import registry
        from mmf_tpu.config.configuration import load_yaml
        from mmf_tpu.utils.env import setup_imports
    else:
        from mmf_tpu_torch.common.registry import registry
        from mmf_tpu_torch.config.configuration import load_yaml
        from mmf_tpu_torch.utils.env import setup_imports
    setup_imports()
    return registry.get_model_class("mmf_transformer")(
        config=_config(load_yaml, heads, **overrides))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, V, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[0, T - 2:] = 0
    lm = np.where(rng.rand(B, T) < 0.4, text, -1).astype(np.int32)
    lm[:, 1] = text[:, 1]
    image_mask = np.ones((B, R), np.int32)
    image_mask[2, R - 1:] = 0
    return {"text": text, "input_mask": mask, "lm_label_ids": lm,
            "image_feature_0": rng.randn(B, R, 16).astype(np.float32),
            "image_mask": image_mask,
            "is_correct": np.array([1, 0, 1, 1], np.int32),
            "hs_masked_for_mlm": rng.randn(B, T + R, 32).astype(np.float32),
            "targets": np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]}


def _pair(heads, batch, **overrides):
    jm = _model("jax", heads, **overrides)
    variables = cached_init(jm, jax.random.PRNGKey(0),
                            dict(tree_map(jnp.asarray, batch), **META), False)
    tm = _model("port", heads, **overrides)
    tm.materialize(dict(tree_map(torch.from_numpy, batch), **META))
    # flax makes params only for the heads the batch's dataset calls;
    # the port builds every head the config names
    missing, unexpected = tm.load_state_dict(params_from_jax(
        jax.device_get(variables["params"])), strict=False)
    called = {tm.heads_dict.scopes[n]
              for n in tm.heads_dict.names_for(META["dataset_name"])}
    assert not unexpected and not any(
        k.split(".")[0] in called or not k.startswith(
            tuple(tm.heads_dict.scopes.values())) for k in missing), missing
    return jm, variables, tm.eval()


def _outputs(jm, variables, tm, batch):
    want = jm.apply(variables, dict(tree_map(jnp.asarray, batch), **META),
                    False)
    with torch.no_grad():
        got = tm(dict(tree_map(torch.from_numpy, batch), **META))
    assert set(got) == set(want)
    assert list(got.get("losses", {})) == list(want.get("losses", {}))
    return got, want


@pytest.mark.parametrize("case", sorted(HEADS))
def test_mmft_forward_matches_jax(case):
    batch = _batch()
    got, want = _outputs(*_pair(HEADS[case], batch), batch)
    for key in ("scores", "logits"):
        if key in want:
            assert got[key].dtype == torch.float32
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]),
                                       atol=F32_ATOL, rtol=0)
    for key, value in want.get("losses", {}).items():
        np.testing.assert_allclose(float(got["losses"][key]), float(value),
                                   rtol=1e-5)


def test_mmft_mlm_is_tied_to_the_first_text_table():
    jm, variables, tm = _pair(HEADS["mlm_itm"], _batch())
    assert "decoder" not in variables["params"]["MLM_0"]["cls"]
    names = dict(tm.named_parameters())
    assert "MLM_0.cls.bias" in names and not any(
        "decoder" in n for n in names)
    untied = _model("port", HEADS["mlm_itm"], tie_weights=False)
    assert "MLM_0.cls.decoder.weight" in dict(untied.named_parameters())


def test_mmft_sizes_its_tables_from_the_data():
    """flax sizes the feature projection by the features' width and the
    position tables by max(position_dim, length): so does the port, from
    a batch or from a state dict."""
    tm = _model("port", HEADS["mlp"])
    assert tm.has_uninitialized_params()
    tm.materialize(dict(tree_map(torch.from_numpy, _batch()), **META))
    assert not tm.has_uninitialized_params()
    assert tuple(tm.token_proj_1.weight.shape) == (32, 16)
    assert tuple(tm.pos_embeddings_0.weight.shape) == (64, 32)
    assert tuple(tm.pos_embeddings_1.weight.shape) == (R, 32)
    fresh = _model("port", HEADS["mlp"])
    fresh.load_state_dict(tm.state_dict(), strict=True)
    assert tuple(fresh.pos_embeddings_1.weight.shape) == (R, 32)


def test_mmft_bf16_matches_jax(monkeypatch):
    monkeypatch.setenv("MMF_TPU_ATTENTION_LOGITS", "f32")
    monkeypatch.setenv("MMF_TPU_GELU", "erf")
    batch = _batch(seed=3)
    jm, variables, tm = _pair(HEADS["mlp_mlm_multi"], batch,
                              dtype="bfloat16")
    tm.to_compute_dtype()
    got, want = _outputs(jm, variables, tm, batch)
    for key in ("scores", "logits"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=BF16_ATOL, rtol=0)


def _grads(heads, batch):
    jm, variables, tm = _pair(heads, batch)
    jb = dict(tree_map(jnp.asarray, batch), **META)
    from mmf_tpu.modules.losses import Losses as JLosses
    from mmf_tpu_torch.modules.losses import Losses

    names = ["logit_bce"] if "mlp" in str(heads) else []

    def loss(params):
        out = jm.apply({"params": params}, jb, True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        values = dict(out.get("losses", {}), **JLosses(names)(jb, out))
        return sum(jnp.mean(v) for v in values.values())

    want = {k: v.numpy() for k, v in params_from_jax(jax.device_get(
        jax.jit(jax.grad(loss))(variables["params"]))).items()}
    port_no_dropout(tm).train()
    tb = dict(tree_map(torch.from_numpy, batch), **META)
    out = tm(tb)
    values = dict(out.get("losses", {}), **Losses(names)(tb, out))
    sum(v.mean() for v in values.values()).backward()
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tm.named_parameters()}
    return want, got


@pytest.mark.parametrize("case", ["mlp", "mlm_itm"])
def test_mmft_step0_gradients_match_jax(case, jax_no_dropout):
    want, got = _grads(HEADS[case], _batch())
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        err = _rel_err(got[name], want[name], floor)
        assert err < 5e-4, f"gradient mismatch at {name}: rel {err:.2e}"


@pytest.mark.parametrize("update_frequency", [1, 2])
def test_mmft_train_steps_match_jax(update_frequency, jax_no_dropout):
    batch = _batch()
    jm, variables, tm = _pair(HEADS["mlm_itm"], batch)
    port_no_dropout(tm)
    want = trajectory(jm, variables, tm, batch, META, update_frequency,
                      ["train/vqa2/itm_loss", "train/vqa2/masked_lm_loss"])
    for name, p in tm.named_parameters():
        if re.search(r"key\.bias$", name):
            continue  # softmax is shift-invariant along keys
        err = _rel_err(p.detach().numpy(), want[name].numpy())
        assert err < 1e-3, f"post-training weight mismatch {name}: {err:.2e}"


@pytest.mark.parametrize("case", ["mlp", "mlm_itm"])
def test_mmft_params_round_trip_through_jax_converter(case):
    from mmf_tpu.utils.checkpoint_updater import (
        _flatten_flax,
        convert_torch_state_dict,
    )

    _, variables, tm = _pair(HEADS[case], _batch())
    params = jax.device_get(variables["params"])
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    converted, stats = convert_torch_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}, zeros)
    assert stats == {"matched": len(_flatten_flax(params)), "missed": 0,
                     "shape_mismatch": 0}
    for path, value in _flatten_flax(params).items():
        np.testing.assert_array_equal(np.asarray(
            _flatten_flax(converted)[path]), np.asarray(value))


def test_mmft_format_state_key_matches_jax():
    from mmf_tpu.models.mmf_transformer import MMFTransformer as J
    from mmf_tpu_torch.models.mmf_transformer import MMFTransformer

    for key in ("pooler.dense.weight", "classifier.0.weight",
                "encoder.layer.0.output.dense.bias"):
        assert MMFTransformer.format_state_key(key) == J.format_state_key(
            key)
    from mmf_tpu_torch.common.registry import registry

    assert registry.get_model_class("mmft") is MMFTransformer


def test_mmft_encodes_4d_images_as_jax():
    """An image modality with an encoder runs a 4-D image through it
    (ResNet-152 grid features, BatchNorm on its running statistics in
    either mode, as JAX calls it without ``train``). flax makes the
    encoder's params only then, and so does the port: ``materialize``
    builds it from such a batch, a state dict that holds it builds it as
    it loads. The names and shapes are held against JAX's (traced, not
    run: the ResNet's numerics are ``tests/test_torch_mmbt.py``'s)."""
    from mmf_tpu.utils.checkpoint_updater import _flatten_flax
    from mmf_tpu_torch.utils.checkpoint import load_model_weights

    modalities = [MODALITIES[0], {
        "type": "image", "key": "image", "embedding_dim": 2048,
        "position_dim": 1, "segment_id": 1, "encoder": {
            "type": "resnet152", "params": {"pretrained": False,
                                            "num_output_features": 1}}}]
    rng = np.random.RandomState(5)
    batch = {"text": rng.randint(1, V, (2, T)).astype(np.int32),
             "image": rng.randn(2, 3, 32, 32).astype(np.float32)}
    jm = _model("jax", HEADS["mlp"], modalities=modalities)
    shapes = jax.eval_shape(
        lambda b: jm.init(jax.random.PRNGKey(0), dict(b, **META), False),
        tree_map(jnp.asarray, batch))
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   shapes)
    want = {k: tuple(v.shape) for k, v in params_from_jax(
        zeros["params"], zeros["batch_stats"]).items()}
    assert any(k.startswith("ResNet152ImageEncoder_0.") for k in want)
    tm = _model("port", HEADS["mlp"], modalities=modalities)
    assert not hasattr(tm, "ResNet152ImageEncoder_0")
    tb = dict(tree_map(torch.from_numpy, batch), **META)
    tm.materialize(tb)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert set(got) == set(want)
    assert all(got[k] == want[k] for k in want
               if not k.endswith("num_batches_tracked"))
    tm.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = tm.eval()(tb)["scores"]
        port_no_dropout(tm).train()  # the encoder stays in inference mode
        np.testing.assert_array_equal(tm(tb)["scores"].numpy(), ref.numpy())
    fresh = _model("port", HEADS["mlp"], modalities=modalities)
    stats = load_model_weights(fresh, tm.state_dict(), "mmf_transformer",
                               strict=True)
    assert stats["missed"] == 0 and hasattr(fresh,
                                            "ResNet152ImageEncoder_0")
    assert len(_flatten_flax(zeros["params"])) < len(want)
