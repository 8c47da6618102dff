"""MMBT-grid in the port against the JAX package on the CPU: the ResNet
family and the ResNet-152 grid encoder against flax (params and
``batch_stats`` carried across by ``params_from_jax``), small MMBT
models (direct features and ResNet-152, f32, and the int8 trunk) on the
same numpy inputs, and ``_modal_token_type``. JAX runs its plain (XLA)
paths, the port its plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

torch.set_num_threads(2)  # several test workers share the host

F32_ATOL = 2e-5  # the repo's own parity bar (README)
META = {"dataset_name": "hateful_memes", "dataset_type": "test"}


def _randomise_batch_norm(variables, seed):
    """BatchNorm scale, bias and running statistics drawn from a numpy
    seed (flax initialises them to 1, 0, 0 and 1, which would hide a
    mapping error)."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.array, jax.device_get(
        variables["params"]))
    stats = jax.tree_util.tree_map(np.array, jax.device_get(
        variables["batch_stats"]))

    def visit(p, s):
        for name, sub in s.items():
            if "mean" in sub:
                c = sub["mean"].shape
                sub["mean"][...] = 0.1 * rng.randn(*c)
                sub["var"][...] = rng.uniform(0.5, 1.5, c)
                p[name]["scale"][...] = 1.0 + 0.1 * rng.randn(*c)
                p[name]["bias"][...] = 0.1 * rng.randn(*c)
            else:
                visit(p[name], sub)

    visit(params, stats)
    return {"params": params, "batch_stats": stats}


def _load(module, variables):
    module.load_state_dict(params_from_jax(variables["params"],
                                           variables["batch_stats"]),
                           strict=True)
    return module.eval()


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# f32 convolutions in other summation orders, compounded over the depth:
# relative to the largest output entry
RESNET_REL = 1e-4


@pytest.mark.parametrize("features_only", [True, False])
def test_resnet18_matches_flax(features_only):
    from mmf_tpu.modules.resnet import ResNet as JaxResNet
    from mmf_tpu_torch.modules.resnet import ResNet

    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    kw = dict(depth=18, features_only=features_only,
              num_classes=0 if features_only else 5)
    jm = JaxResNet(**kw)
    variables = _randomise_batch_norm(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = _load(ResNet(**kw), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((2, 2, 2, 512) if features_only
                                       else (2, 5))
    assert _rel_err(got, want) < RESNET_REL


def test_resnet152_image_encoder_matches_flax():
    from mmf_tpu.modules.encoders import ResNet152ImageEncoder as JaxEncoder
    from mmf_tpu_torch.modules.encoders import ResNet152ImageEncoder

    x = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    jm = JaxEncoder(num_output_features=1)
    variables = _randomise_batch_norm(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = _load(ResNet152ImageEncoder(num_output_features=1), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 2048)
    assert _rel_err(got, want) < RESNET_REL


def test_adaptive_pool_2d_matches_jax():
    from mmf_tpu.modules.encoders import adaptive_pool_2d as jax_pool
    from mmf_tpu_torch.modules.encoders import POOL_GRIDS, adaptive_pool_2d

    x = np.random.RandomState(4).randn(2, 7, 5, 3).astype(np.float32)
    for grid in sorted(set(POOL_GRIDS.values())):
        for kind in ("avg", "max"):
            want = np.asarray(jax_pool(jnp.asarray(x), grid, kind))
            got = adaptive_pool_2d(torch.from_numpy(x), grid, kind).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _small_mmbt_config(load_yaml, direct, quant="none"):
    """The config of tests/models/test_mmbt_vilbert.py: 2 layers, hidden
    32, 4 heads, 3 labels, f32."""
    mc = load_yaml("configs/models/mmbt/defaults.yaml")["model_config"][
        "mmbt"]
    mc["training_head_type"] = "classification"
    mc["direct_features_input"] = direct
    mc["modal_hidden_size"] = 16 if direct else 2048
    mc["dtype"] = "float32"
    mc["num_labels"] = 3
    mc["quant"] = quant
    mc["fused_feature_only"] = True
    mc["text_encoder"]["params"].update(
        {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 64, "vocab_size": 100})
    if not direct:
        mc["modal_encoder"] = {"type": "resnet152",
                               "params": {"num_output_features": 1}}
    return mc


def _mmbt_batch(direct, b=2, t=10):
    """Numpy inputs: a ragged text mask (the end token and the left shift
    read it), two segments in one sample."""
    rng = np.random.RandomState(0)
    batch = {
        "input_ids": rng.randint(5, 100, (b, t)).astype(np.int32),
        "input_mask": np.ones((b, t), np.int32),
        "segment_ids": np.zeros((b, t), np.int32),
    }
    batch["input_mask"][0, t - 3:] = 0
    batch["segment_ids"][1, t // 2:] = 1
    if direct:
        batch["image_feature_0"] = rng.randn(b, 4, 16).astype(np.float32)
    else:
        batch["image"] = rng.randn(b, 3, 64, 64).astype(np.float32)
    return batch


def _mmbt_pair(direct, quant="none"):
    from mmf_tpu.common.registry import registry as jax_registry
    from mmf_tpu.config.configuration import load_yaml as jax_load_yaml
    from mmf_tpu.utils.env import setup_imports as jax_setup_imports
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    jax_setup_imports()
    setup_imports()
    batch = _mmbt_batch(direct)
    jm = jax_registry.get_model_class("mmbt")(
        config=_small_mmbt_config(jax_load_yaml, direct, quant))
    jb = dict({k: jnp.asarray(v) for k, v in batch.items()}, **META)
    variables = jm.init(jax.random.PRNGKey(0), jb, False)
    if not direct:
        variables = _randomise_batch_norm(variables, seed=5)
    want = jax.jit(lambda v, b_: jm.apply(v, dict(b_, **META), False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = registry.get_model_class("mmbt")(
        config=_small_mmbt_config(load_yaml, direct, quant))
    tm.load_state_dict(params_from_jax(variables["params"],
                                       variables.get("batch_stats")),
                       strict=True)
    with torch.inference_mode():
        got = tm.eval()({**{k: torch.from_numpy(v) for k, v in batch.items()},
                         **META})
    return got, {k: np.asarray(v) for k, v in want.items()}


def test_mmbt_direct_features_f32_matches_jax():
    got, want = _mmbt_pair(direct=True)
    assert got["scores"].dtype == torch.float32
    for key in ("scores", "fused_feature"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   atol=F32_ATOL, rtol=0)


def test_mmbt_resnet152_f32_matches_jax():
    got, want = _mmbt_pair(direct=False)
    # the ResNet-152 features may differ by up to RESNET_REL of their
    # largest entry (f32 convolutions in other orders); the projection and
    # the embedding LayerNorm shrink that well below the repo's bar
    for key in ("scores", "fused_feature"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   atol=F32_ATOL, rtol=0)


def test_mmbt_int8_trunk_matches_jax():
    """quant: int8 through the plain version of K5 against JAX's XLA int8
    path. The same integers almost everywhere: f32 round-off that differs
    between the frameworks can flip a rounding at a .5 boundary, moving
    one activation by one quantisation step (1/127 of its row's largest
    entry, ~1e-2 relative) and the outputs by a fraction of that."""
    got, want = _mmbt_pair(direct=True, quant="int8")
    ref, _ = _mmbt_pair(direct=True)
    for key in ("scores", "fused_feature"):
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   atol=2e-3, rtol=0)
    # and the int8 path really ran: it differs from the f32 forward
    assert not np.allclose(got["scores"].numpy(), ref["scores"].numpy(),
                           atol=1e-5, rtol=0)


@pytest.mark.parametrize("segments,num_max,want", [
    ([[0, 0, 0], [0, 0, 0]], 2, 1),  # one segment, id 0: the other id
    ([[1, 1, 1], [1, 1, 1]], 2, 0),  # one segment, id 1
    ([[0, 1, 1], [0, 0, 0]], 2, 0),  # two segments up to the last id
    ([[0, 1, 1], [0, 0, 1]], 3, 2),  # two segments below the last id
])
def test_modal_token_type_matches_jax(segments, num_max, want):
    from mmf_tpu.models.mmbt import MMBT as JaxMMBT
    from mmf_tpu_torch.models.mmbt import MMBT

    seg = np.asarray(segments, np.int32)
    jax_value = np.asarray(JaxMMBT(config={})._modal_token_type(
        jnp.asarray(seg), num_max))
    got = MMBT._modal_token_type(torch.from_numpy(seg), num_max)
    assert got.shape == (1, 1) and jax_value.shape == (1, 1)
    assert int(got[0, 0]) == int(jax_value[0, 0]) == want


def test_params_from_jax_maps_convs_and_batch_stats():
    kernel = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    params = {"m": {"conv": {"kernel": kernel},
                    "bn": {"scale": np.ones(5), "bias": np.zeros(5)}}}
    stats = {"m": {"bn": {"mean": np.full(5, 0.5), "var": np.full(5, 2.0)}}}
    sd = params_from_jax(params, stats)
    assert sd["m.conv.weight"].shape == (5, 4, 2, 3)  # HWIO -> OIHW
    np.testing.assert_array_equal(sd["m.conv.weight"].numpy()[1, 2],
                                  kernel[:, :, 2, 1])
    np.testing.assert_array_equal(sd["m.bn.running_mean"].numpy(),
                                  np.full(5, 0.5))
    np.testing.assert_array_equal(sd["m.bn.running_var"].numpy(),
                                  np.full(5, 2.0))
    assert sd["m.bn.num_batches_tracked"].dtype == torch.int64
    bn = torch.nn.BatchNorm2d(5)
    bn.load_state_dict({k[len("m.bn."):]: v for k, v in sd.items()
                        if k.startswith("m.bn.")}, strict=True)
    with pytest.raises(KeyError):
        params_from_jax(params, {"m": {"bn": {"running_mean": np.zeros(5)}}})
    # a 1-D Conv's [W, I, O] kernel keeps flax's layout
    # (modules/embeddings.py::Conv1d); other ranks raise
    assert tuple(params_from_jax({"c": {"kernel": np.zeros((2, 3, 4))}})[
        "c.weight"].shape) == (2, 3, 4)
    with pytest.raises(ValueError):
        params_from_jax({"c": {"kernel": np.zeros((2, 2, 2, 2, 2))}})


def test_mmbt_grid_and_hateful_memes_batch():
    from mmf_tpu_torch.models.mmbt import MMBT
    from mmf_tpu_torch.utils.flagship import (
        hateful_memes_example_batch,
        mmbt_grid,
    )

    model = mmbt_grid({"text_encoder": {"params": {"num_hidden_layers": 1}}})
    assert isinstance(model, MMBT) and model.encoder_name == \
        "ResNet152ImageEncoder_0"
    text = model.config["text_encoder"]["params"]
    assert (text["hidden_size"], text["num_attention_heads"],
            model.config["num_labels"], model.config["dtype"]) == (
        768, 12, 2, "bfloat16")
    pretraining = mmbt_grid({"training_head_type": "pretraining",
                             "text_encoder": {"params": {
                                 "num_hidden_layers": 1}}})
    assert hasattr(pretraining, "cls") and not hasattr(pretraining,
                                                       "classifier")
    b = hateful_memes_example_batch(2, seed=0)
    rng = np.random.RandomState(0)  # bench_latency.py's draws
    np.testing.assert_array_equal(b["input_ids"],
                                  rng.randint(0, 30522, (2, 128)))
    np.testing.assert_array_equal(b["image"],
                                  rng.randn(2, 3, 224, 224).astype(
                                      np.float32))
    assert b["input_mask"].sum() == 256 and not b["segment_ids"].any()
    assert b["dataset_name"] == "hateful_memes"
