"""CNN-LSTM: an LSTM over the question and a stack of convolutions over
the image, concatenated and classified.

Port of ``mmf_tpu/models/cnn_lstm.py``. The words go through a table
(``text_embedding``, ``embedding_dim`` wide) and flax's
``OptimizedLSTMCell`` (``lstm_fwd``; with ``bidirectional``, ``lstm_bwd``
run backwards in time): the forward cell's last step and the backward
cell's first. The image [B, 3, H, W] goes through ``cnn_<i>``
(``ConvNet``: conv, leaky ReLU, max pool, BatchNorm), flattened. The
classifier (the config's type, ``mlp`` in both configs) reads the two
concatenated.

The vocabulary and the answers come from the registry under the first
dataset's name (``<dataset>_text_vocab_size``,
``<dataset>_num_final_outputs``), else the config's ``text_vocab_size``
(100) and ``num_labels`` (32), as in JAX. flax infers the classifier's
input width, which the image's size sets: here the classifier's first
Dense is a ``LazyDense``, sized by ``materialize(sample_list)`` from the
image's height and width (``MMFTrainer`` calls it before
``init_weights``), or by loading a state dict.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.ban import first_dataset
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.layers import (
    ClassifierLayer,
    ConvNet,
    LSTMCell,
    run_rnn,
)
from mmf_tpu_torch.modules.transformer import Embed


@registry.register_model("cnn_lstm")
class CNNLSTM(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        dataset = first_dataset("clevr")
        vocab_size = registry.get(dataset + "_text_vocab_size",
                                  no_warning=True) or c.get(
            "text_vocab_size", 100)
        num_answers = registry.get(dataset + "_num_final_outputs",
                                   no_warning=True) or c.get("num_labels", 32)
        emb_dim = c["text_embedding"]["embedding_dim"]
        self.text_embedding = Embed(vocab_size, emb_dim)
        lstm = c["lstm"]
        self.bidirectional = lstm.get("bidirectional", False)
        self.lstm_fwd = LSTMCell(emb_dim, lstm["hidden_size"])
        if self.bidirectional:
            self.lstm_bwd = LSTMCell(emb_dim, lstm["hidden_size"])
        layers = c["cnn"]["layers"]
        self.n_convs = len(layers["input_dims"])
        for i in range(self.n_convs):
            self.add_module(f"cnn_{i}", ConvNet(
                layers["input_dims"][i], layers["output_dims"][i],
                layers["kernel_sizes"][i]))
        cc = c["classifier"]
        params = dict(cc.get("params", {}) or {})
        params.pop("out_dim", None)
        self.classifier = ClassifierLayer(cc["type"], None, num_answers,
                                          params)

    @classmethod
    def config_path(cls):
        return "configs/models/cnn_lstm/defaults.yaml"

    @torch.no_grad()
    def materialize(self, sample_list: Dict[str, Any]) -> "CNNLSTM":
        """Size the classifier from an image's height and width, as
        flax does at init: each ConvNet keeps the size ("same"
        padding) and halves it (floor) in its pool."""
        h, w = sample_list["image"].shape[-2:]
        for i in range(self.n_convs):
            stride = getattr(self, f"cnn_{i}").pool_stride
            h, w = h // stride, w // stride
        channels = getattr(self, f"cnn_{self.n_convs - 1}").conv.out_channels
        hidden = self.lstm_fwd.features * (2 if self.bidirectional else 1)
        for module in self.classifier.modules():
            if hasattr(module, "materialize") and \
                    module.has_uninitialized_params():
                module.materialize(hidden + channels * int(h) * int(w))
                break
        return self

    def forward(self, sample_list: Dict[str, Any]):
        emb = self.text_embedding(sample_list["text"].long())
        out_f = run_rnn(self.lstm_fwd, emb)
        if self.bidirectional:
            out_b = run_rnn(self.lstm_bwd, emb, reverse=True)
            hidden = torch.cat([out_f[:, -1], out_b[:, 0]], dim=-1)
        else:
            hidden = out_f[:, -1]
        x = sample_list["image"]
        for i in range(self.n_convs):
            x = getattr(self, f"cnn_{i}")(x)
        fused = torch.cat([hidden, x.reshape(x.shape[0], -1)], dim=-1)
        return {"scores": self.classifier(fused)}
