"""Shared helpers of the port's tests (tests/test_torch_*.py): a tiny
VisualBERT built in JAX and in the port from the same YAML, with the JAX
init carried across by ``params_from_jax``, and numpy inputs fed to both;
``registries_restored`` for the tests that fill the registries."""

import contextlib
import hashlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

# 2 layers, hidden 32, 4 heads, visual dim 16, 6 labels
TINY = {
    "vocab_size": 64,
    "hidden_size": 32,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 64,
    "visual_embedding_dim": 16,
    "max_position_embeddings": 32,
    "num_labels": 6,
    "dtype": "float32",
}
META = {"dataset_name": "vqa2", "dataset_type": "val"}


_INITS = {}


def _fingerprint(tree):
    """The tree's structure and every leaf: an array by shape, dtype and
    a hash of its bytes, anything else by its repr."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    parts = [str(treedef)]
    for path, leaf in leaves:
        where = jax.tree_util.keystr(path)
        if isinstance(leaf, (jax.Array, np.ndarray)):
            a = np.asarray(leaf)
            parts.append((where, a.shape, str(a.dtype),
                          hashlib.sha1(a.tobytes()).hexdigest()))
        else:
            parts.append((where, repr(leaf)))
    return tuple(parts)


def cached_init(module, rngs, *args, **kwargs):
    """``module.init(rngs, *args, **kwargs)``, run once a process for a
    module (its repr: class and configuration) and inputs: flax's eager
    initialisers cost seconds a model, and several tests start from the
    same one. Each call gets containers of its own over the shared
    arrays, which nothing changes."""
    key = (repr(module), _fingerprint((rngs, args, kwargs)))
    if key not in _INITS:
        _INITS[key] = module.init(rngs, *args, **kwargs)
    return jax.tree_util.tree_map(lambda leaf: leaf, _INITS[key])


def jit_init(module, rngs, *args, **kwargs):
    """``module.init(rngs, *args, **kwargs)`` compiled as one program:
    flax's initialisers run eagerly compile each operation on its own
    (seconds a model). The array leaves of the arguments are the
    program's inputs; the rest (flags, the batches' strings) are closed
    over."""
    leaves, treedef = jax.tree_util.tree_flatten((args, kwargs))
    dynamic = [i for i, leaf in enumerate(leaves)
               if isinstance(leaf, (jax.Array, np.ndarray))]

    def init(rngs, *values):
        full = list(leaves)
        for i, value in zip(dynamic, values):
            full[i] = value
        a, k = jax.tree_util.tree_unflatten(treedef, full)
        return module.init(rngs, *a, **k)

    return jax.jit(init)(rngs, *[leaves[i] for i in dynamic])


@contextlib.contextmanager
def registries_restored(empty=False):
    """Both registries' state (JAX's and the port's) put back as it was
    after the block; with ``empty``, emptied for the block. A dataset
    caches its processors there under its name (``vqa2_text_processor``,
    ...) and a later dataset of that name, in any test file the process
    runs afterwards, reuses them and reads its data through them."""
    from mmf_tpu.common.registry import registry as jax_registry
    from mmf_tpu_torch.common.registry import registry as port_registry

    saved = [(r, dict(r.mapping["state"]))
             for r in (jax_registry, port_registry)]
    if empty:
        for r, _ in saved:
            r.mapping["state"].clear()
    try:
        yield
    finally:
        for r, state in saved:
            r.mapping["state"].clear()
            r.mapping["state"].update(state)


def jax_visual_bert(overrides):
    from mmf_tpu.common.registry import registry
    from mmf_tpu.config.configuration import load_yaml
    from mmf_tpu.utils.env import setup_imports

    setup_imports()
    cfg = load_yaml("configs/models/visual_bert/defaults.yaml")
    mc = cfg["model_config"]["visual_bert"]
    mc["training_head_type"] = "classification"
    mc.update(overrides)
    return registry.get_model_class("visual_bert")(config=mc)


def port_visual_bert(overrides):
    from mmf_tpu_torch.utils.flagship import visual_bert

    return visual_bert(dict(overrides))


def tiny_batch(n, seed=0, seq_len=8, regions=5, head="classification"):
    """Numpy batch in the _example_batch layout with ragged text masks
    and one sample below the region count."""
    from mmf_tpu_torch.utils.flagship import example_batch

    b = example_batch(n, seq_len, regions, TINY["visual_embedding_dim"],
                      vocab_size=TINY["vocab_size"], seed=seed)
    b["input_mask"][0, seq_len - 2:] = 0
    b["image_info_0"]["max_features"][-1] = regions - 2
    if head == "nlvr2":
        other = example_batch(n, seq_len, regions, TINY["visual_embedding_dim"],
                              vocab_size=TINY["vocab_size"], seed=seed + 100)
        b["img0"] = {"image_feature_0": b.pop("image_feature_0"),
                     "image_info_0": b.pop("image_info_0")}
        b["img1"] = {"image_feature_0": other["image_feature_0"],
                     "image_info_0": other["image_info_0"]}
    return b


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def to_torch(tree):
    return tree_map(torch.from_numpy, tree)


def init_pair(overrides, batch, seed=0):
    """JAX model + variables and the port model holding the same weights
    (eval mode). ``batch`` is a numpy batch used for the JAX init."""
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    jm = jax_visual_bert(overrides)
    jb = dict(tree_map(jnp.asarray, batch), **META)
    variables = cached_init(jm, jax.random.PRNGKey(seed), jb, False)
    tm = port_visual_bert(overrides).eval()
    tm.load_state_dict(
        params_from_jax(jax.device_get(variables["params"])), strict=True
    )
    return jm, variables, tm


def jax_forward(jm, variables, batch):
    jb = dict(tree_map(jnp.asarray, batch), **META)
    out = jm.apply(variables, jb, False)
    return {k: np.asarray(out[k], np.float32)
            for k in ("scores", "pooled_output")}
