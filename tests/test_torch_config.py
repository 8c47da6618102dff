"""Config, registry and trunk pieces of the port against the JAX package:
the YAML tree read as data, auto-registration, ``TransformerConfig``,
GELU's precision rule, ``apply_padding_idx`` and the attention block's
``prefix_kv`` / ``return_kv`` / cross-attention paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # several test workers share the host


def test_load_yaml_reads_the_jax_config_tree():
    from mmf_tpu.config import omega as jomega
    from mmf_tpu.config.configuration import load_yaml as jax_load_yaml
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.config.configuration import load_yaml

    for path in ("configs/models/visual_bert/defaults.yaml",
                 "configs/models/visual_bert/classification.yaml"):
        got = omega.to_container(load_yaml(path), resolve=True)
        want = jomega.to_container(jax_load_yaml(path), resolve=True)
        assert got == want, path
    vb = load_yaml("configs/models/visual_bert/defaults.yaml")
    mc = vb["model_config"]["visual_bert"]
    assert (mc["hidden_size"], mc["num_hidden_layers"], mc["dtype"]) == (
        768, 12, "bfloat16")


def test_setup_imports_registers_visual_bert_in_the_port_registry():
    from mmf_tpu.common.registry import registry as jax_registry
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.models.visual_bert import VisualBERT
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    assert registry.get_model_class("visual_bert") is VisualBERT
    assert registry is not jax_registry
    assert jax_registry.get_model_class("visual_bert") is not VisualBERT


def test_transformer_config_and_unported_options():
    from mmf_tpu_torch.modules.transformer import (
        TransformerConfig,
        TransformerLayer,
        _dense,
    )

    cfg = TransformerConfig.from_dict(
        {"dtype": "bfloat16", "hidden_size": 16, "remat": True,
         "unknown_key": 1}
    )
    assert cfg.dtype == torch.bfloat16 and cfg.hidden_size == 16
    assert TransformerConfig.from_dict({"dtype": "fp32"}).dtype == \
        torch.float32
    from mmf_tpu_torch.ops.quant import QuantDense

    quant = _dense(TransformerConfig(quant="int8"), 4, 6)
    assert isinstance(quant, QuantDense) and quant.weight.shape == (6, 4)
    with pytest.raises(NotImplementedError):
        TransformerLayer(TransformerConfig(moe_experts=2), moe=True)


@pytest.mark.parametrize("dtype,forced", [
    ("float32", ""), ("bfloat16", ""), ("float32", "tanh"),
    ("bfloat16", "erf"),
])
def test_gelu_follows_the_jax_precision_rule(dtype, forced, monkeypatch):
    from mmf_tpu.modules.transformer import _gelu as jax_gelu
    from mmf_tpu_torch.modules.transformer import _gelu

    monkeypatch.setenv("MMF_TPU_GELU", forced)
    x = np.linspace(-4.0, 4.0, 97).astype(np.float32)
    want = np.asarray(jax_gelu(jnp.asarray(x, getattr(jnp, dtype))),
                      np.float32)
    got = _gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float()
    atol = 1e-6 if dtype == "float32" else 2e-2  # bf16 ulp at |x| <= 4
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_apply_padding_idx_blocks_the_pad_gradient():
    from mmf_tpu_torch.modules.transformer import apply_padding_idx

    table = torch.randn(5, 3, generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
    ids = torch.tensor([[0, 2, 0, 4]])
    out = apply_padding_idx(table[ids], ids, pad_token_id=0)
    torch.testing.assert_close(out, table[ids].detach())
    out.sum().backward()
    assert torch.all(table.grad[0] == 0)
    assert torch.all(table.grad[2] == 1) and torch.all(table.grad[4] == 1)


def test_self_attention_prefix_kv_and_cross_attention_match_jax():
    from mmf_tpu.modules import transformer as jt
    from mmf_tpu_torch.modules import transformer as tt
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    kw = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jcfg = jt.TransformerConfig(**kw)
    rng = np.random.RandomState(0)
    hidden = rng.randn(2, 5, 32).astype(np.float32)
    other = rng.randn(2, 7, 32).astype(np.float32)
    prefix = tuple(rng.randn(2, 4, 3, 8).astype(np.float32)
                   for _ in range(2))

    jmod = jt.SelfAttention(jcfg)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(hidden))
    tmod = tt.SelfAttention(tt.TransformerConfig(**kw)).eval()
    tmod.load_state_dict(
        params_from_jax(jax.device_get(variables["params"])), strict=True
    )

    want, (wk, wv) = jmod.apply(
        variables, jnp.asarray(hidden),
        prefix_kv=tuple(map(jnp.asarray, prefix)), return_kv=True,
    )
    with torch.no_grad():
        got, (gk, gv) = tmod(torch.from_numpy(hidden),
                             prefix_kv=tuple(map(torch.from_numpy, prefix)),
                             return_kv=True)
        cross = tmod(torch.from_numpy(hidden), kv=torch.from_numpy(other))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=2e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=2e-5)
    want_cross = jmod.apply(variables, jnp.asarray(hidden),
                            kv=jnp.asarray(other))
    np.testing.assert_allclose(cross.numpy(), np.asarray(want_cross),
                               atol=2e-5)
