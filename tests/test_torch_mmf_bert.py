"""mmf_bert and its pieces against the JAX package on the CPU.

- ``TorchMultiheadAttention`` (query, key and value of different widths,
  torch's key-padding convention) at head dims 8 and 160 (the card runs
  96 and 256 through the kernels; here the plain version), and
  ``ProjectionEmbedding`` in its ``linear`` and ``conv`` forms (flax's
  ``SAME`` padding, kernels 1 and 3) and as the ``projection`` image
  encoder;
- ``MMFBert`` from ``configs/models/mmf_bert/defaults.yaml`` at small
  widths (hidden 32, 4 heads of 8, 50 words, 10 tokens with padding, 5
  regions x 16 through the fc7 encoder and the shared 2048 -> 32
  projection, the intra-attention on), f32, dropout 0, on the same
  weights (a JAX init redrawn from a numpy seed, carried across by
  ``params_from_jax``) and seeded numpy inputs, under every head
  (``pretraining`` with the next-sentence loss, ``vqa``, ``vizwiz``,
  ``nlvr2``, ``visual_entailment``, ``classification``): the outputs
  within atol 2e-5, the step-0 gradients of the head's losses at cosine
  >= 0.99999 for every parameter, and 4 AdamW steps of the VQA2 config's
  optimizer (``adam_w``, lr 5e-5 warmed up linearly): the losses and
  every parameter within 1e-5 relative; the weights' round trip through
  JAX's ``convert_torch_state_dict``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_caption_models import (
    init_shapes,
    TRAJ_RTOL,
    assert_grads_match,
    assert_params_match,
    assert_round_trip,
    build,
    load,
    losses_pair,
    randomize,
    trajectory,
)
from tests.torch_port_utils import tree_map

torch.set_num_threads(2)  # several test workers share the host

ATOL, GRAD_MIN_COSINE = 2e-5, 0.99999
V, T, K, F, H, B, LABELS = 50, 10, 5, 16, 32, 4, 7
HEADS = ("pretraining", "vqa", "vizwiz", "nlvr2", "visual_entailment",
         "classification")
# the head's losses: the model's own in pretraining, else the configured
LOSSES = {"pretraining": [], "vqa": ["logit_bce"], "vizwiz": ["logit_bce"],
          "nlvr2": ["cross_entropy"], "visual_entailment": ["cross_entropy"],
          "classification": ["cross_entropy"]}
# projects/others/mmf_bert/configs/vqa2/defaults.yaml's optimizer and
# schedule, the warmup cut to 2 of 10 steps so that 4 steps cross it
ADAMW = {
    "training": {"lr_scheduler": True, "max_updates": 10},
    "optimizer": {"type": "adam_w", "params": {"lr": 5e-5, "eps": 1e-8}},
    "scheduler": {"type": "warmup_linear",
                  "params": {"num_warmup_steps": 2,
                             "num_training_steps": 10}},
}


def overrides(head):
    att = {"embed_dim": H, "num_heads": 4, "dropout": 0.0}
    out = {"training_head_type": head, "hidden_size": H, "vocab_size": V,
           "max_position_embeddings": 16, "hidden_dropout_prob": 0.0,
           "image_feature_dim": F, "text_embeddings": [att],
           "image_feature_embeddings": [att],
           "image_feature_attentions": [att],
           "image_feature_projection": {"module": "linear", "in_dim": 2048,
                                        "out_dim": H},
           "image_text_modal_combine": {
               "type": "non_linear_element_multiply",
               "params": {"dropout": 0, "hidden_dim": H}}}
    if head in ("vqa", "vizwiz", "classification"):
        out["num_labels"] = LABELS
    return out


def batch(head, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, V, (B, T)).astype(np.int64)
    mask = np.ones((B, T), np.int64)
    mask[1, 6:] = 0
    mask[2, 8:] = 0
    ids[mask == 0] = 0
    out = {"input_ids": ids, "input_mask": mask,
           "segment_ids": (np.arange(T)[None] > 5).astype(np.int64).repeat(
               B, 0),
           "image_feature_0": rng.randn(B, K, F).astype(np.float32)}
    if head == "pretraining":
        lm = np.full((B, T), -1, np.int64)
        lm[:, 2] = rng.randint(1, V, B)
        lm[0, 4] = 3
        out.update(lm_label_ids=lm, is_correct=np.array([0, 1, 1, 0]))
    elif LOSSES[head] == ["logit_bce"]:
        out["targets"] = rng.rand(B, LABELS).astype(np.float32)
    else:
        n = {"nlvr2": 2, "visual_entailment": 3}.get(head, LABELS)
        out["targets"] = rng.randint(0, n, B).astype(np.int64)
    return out


@pytest.fixture(scope="module")
def models():
    """head -> (JAX model, redrawn variables)."""
    out = {}
    for head in HEADS:
        jm = build("jax", "mmf_bert", overrides(head))
        out[head] = (jm, randomize(init_shapes(
            jm, jax.random.PRNGKey(0), tree_map(jnp.asarray, batch(head)),
            False), seed=1))
    return out


def _port(head, variables):
    return load(build("port", "mmf_bert", overrides(head)), variables)


def _total(out, losses):
    """The model's own losses and the configured ones, summed as the
    train step sums them (each a mean)."""
    values = list(out.get("losses", {}).values()) + list(losses.values())
    return sum(v.mean() for v in values)


@pytest.mark.parametrize("head", HEADS)
def test_mmf_bert_outputs_match_jax(models, head):
    jm, variables = models[head]
    tm = _port(head, variables)
    b = batch(head, 5)
    want = jm.apply(variables, tree_map(jnp.asarray, b), False)
    with torch.no_grad():
        got = tm(tree_map(torch.from_numpy, b))
    assert set(got) == set(want)
    for name in want:
        if name == "losses":
            assert set(got[name]) == set(want[name]) == {
                "unknown/train/masked_lm_loss",
                "unknown/train/next_sentence_loss"}
            for k, v in want[name].items():
                np.testing.assert_allclose(float(got[name][k]), float(v),
                                           rtol=1e-6, err_msg=k)
            continue
        w = np.asarray(want[name])
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(got[name].numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)
    assert_round_trip(variables, tm)


@pytest.mark.parametrize("head", HEADS)
def test_mmf_bert_gradients_match_jax(models, head):
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    jm, variables = models[head]
    tm = _port(head, variables)
    b = batch(head, 6)
    jlosses, tlosses = losses_pair(LOSSES[head])
    jb = tree_map(jnp.asarray, b)

    def loss(params):
        out = jm.apply({"params": params}, jb, True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return _total(out, jlosses(jb, out))

    want = {k: v.numpy() for k, v in params_from_jax(jax.device_get(
        jax.jit(jax.grad(loss))(variables["params"]))).items()}
    tm.train()
    tb = tree_map(torch.from_numpy, b)
    out = tm(tb)
    _total(out, tlosses(tb, out)).backward()
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tm.named_parameters()}
    assert_grads_match(want, got, GRAD_MIN_COSINE)


@pytest.mark.parametrize("head", HEADS)
def test_mmf_bert_adamw_trajectory_matches_jax(models, head):
    jm, variables = models[head]
    tm = _port(head, variables)
    b = batch(head, 7)
    j_losses, t_losses, want = trajectory(jm, variables, tm, b, b,
                                          LOSSES[head], train_config=ADAMW)
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    assert len(set(np.round(t_losses, 6))) > 1  # the weights moved
    assert_params_match(tm, want, skip=())  # every parameter


def _flax_and_port(flax_module, port_module, *inputs, seed=0):
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    j_in = [jnp.asarray(x) for x in inputs]
    variables = randomize(init_shapes(flax_module, jax.random.PRNGKey(seed),
                                      *j_in), seed + 1)
    port_module.load_state_dict(params_from_jax(variables["params"]),
                                strict=True)
    want = flax_module.apply(variables, *j_in)
    with torch.no_grad():
        got = port_module.eval()(*[torch.from_numpy(np.asarray(x))
                                   for x in inputs])
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("width,heads", [(16, 2), (320, 2)])
def test_torch_multihead_attention_matches_jax(width, heads):
    """Head dims 8 and 160; a key-padding mask whose True keys are left
    out; key and value 12 wide."""
    from mmf_tpu.modules.attention import TorchMultiheadAttention as JMHA
    from mmf_tpu_torch.modules.attention import TorchMultiheadAttention

    rng = np.random.RandomState(width)
    query = rng.randn(3, 6, width).astype(np.float32)
    key = rng.randn(3, 9, 12).astype(np.float32)
    pad = np.zeros((3, 9), bool)
    pad[1, 5:] = True
    pad[2, 1:] = True

    class Flax(fnn.Module):
        @fnn.compact
        def __call__(self, q, kv, mask):
            return JMHA(width, heads, name="att")(q, kv, kv,
                                                  key_padding_mask=mask)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.att = TorchMultiheadAttention(width, heads, kdim=12,
                                               vdim=12)

        def forward(self, q, kv, mask):
            return self.att(q, kv, kv, key_padding_mask=mask)

    want, got = _flax_and_port(Flax(), Port(), query, key, pad)
    assert got.shape == (3, 6, width)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("form", ["linear", "conv"])
def test_projection_embedding_matches_jax(form):
    """Both forms of ``ProjectionEmbedding`` as a text embedding, and the
    ``projection`` image encoder (``module`` defaulting to linear)."""
    from mmf_tpu.modules.embeddings import TextEmbedding as JText
    from mmf_tpu.modules.encoders import build_image_encoder as j_encoder
    from mmf_tpu_torch.modules.embeddings import TextEmbedding
    from mmf_tpu_torch.modules.encoders import build_image_encoder

    params = {"module": form, "in_dim": 6, "out_dim": 10,
              "convs": [{"out_channels": 8, "kernel_size": 3},
                        {"out_channels": 5, "kernel_size": 1}]}
    x = np.random.RandomState(3).randn(2, 7, 6).astype(np.float32)
    port = TextEmbedding("projection", params)
    assert port.out_dim == (10 if form == "linear" else 5)
    want, got = _flax_and_port(JText("projection", params), port, x)
    assert got.shape == (2, 7, port.out_dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    cfg = {"type": "projection", "params": {"in_dim": 6, "out_dim": 4}}
    want, got = _flax_and_port(j_encoder(cfg, direct_features=True),
                               build_image_encoder(cfg, True), x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
