"""Decoders: BUTD's language LSTM and the VisDial discriminator.

Port of ``mmf_tpu/modules/decoders.py``. ``LanguageDecoder`` is one
decode step: an LSTM over ``[attended regions, h1]`` whose new ``h2``
goes through dropout and a weight-normalised ``fc`` with a gain an
output; the LSTM state is threaded explicitly (``{"td_hidden": (h1, c1),
"lm_hidden": (h2, c2)}``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from mmf_tpu_torch.modules.layers import (
    LSTMCell,
    add_wn_dense,
    weight_norm_weight,
)
from mmf_tpu_torch.modules.transformer import Dense, Dropout


class LanguageDecoder(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 1024,
                 dropout: float = 0.5, fc_bias_init: float = 0.0):
        super().__init__()
        self.language_lstm = LSTMCell(in_dim + hidden_dim, hidden_dim)
        add_wn_dense(self, "fc", 0, hidden_dim, out_dim, per_output=True)
        self.fc_bias_init = float(fc_bias_init)
        self.dropout = Dropout(dropout)
        self.init_constants()

    @torch.no_grad()
    def init_constants(self):
        """fc's bias starts at ``fc_bias_init`` (flax's constant init)."""
        self.Dense_0.bias.fill_(self.fc_bias_init)

    def prepare(self):
        """The weights every step shares: (the LSTM's, fc's)."""
        return self.language_lstm.fused(), weight_norm_weight(self.Dense_0,
                                                              self.fc)

    def forward(self, weighted_attn, state: Dict[str, Tuple], prepared=None):
        lstm_w, fc_w = self.prepare() if prepared is None else prepared
        h1, _ = state["td_hidden"]
        h2, c2 = state["lm_hidden"]
        (c2, h2), _ = self.language_lstm(
            (c2, h2), torch.cat([weighted_attn, h1], dim=1), lstm_w)
        predictions = nn.functional.linear(self.dropout(h2), fc_w,
                                           self.Dense_0.bias)
        new_state = dict(state)
        new_state["lm_hidden"] = (h2, c2)
        return predictions, new_state


class VisDialDiscriminator(nn.Module):
    """The discriminative VisDial head: the candidate options (embedded
    by the caller's shared question stack) projected and dot-scored
    against the fused dialog state: [N, options, emb] x [N, H] ->
    [N, options]."""

    def __init__(self, embedding_dim: int, hidden_dim: int):
        super().__init__()
        self.projection_layer = Dense(embedding_dim, hidden_dim)

    def forward(self, encoder_output, option_embeddings):
        proj = self.projection_layer(option_embeddings)
        return torch.einsum("noh,nh->no", proj, encoder_output)
