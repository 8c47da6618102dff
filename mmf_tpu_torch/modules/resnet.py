"""ResNet family (grid features for MMBT's image encoder).

Port of ``mmf_tpu/modules/resnet.py``. Module names mirror the flax
scopes (``conv1``, ``bn1``, ``layer{stage}_{block}``, ``downsample_conv``
...), so ``utils/checkpoint_updater.py::params_from_jax`` maps a JAX
param and ``batch_stats`` tree onto them mechanically.

torch convolutions are NCHW, so the JAX version's NCHW -> NHWC transpose
at the input goes; ``features_only`` still returns the final map as
[B, H', W', C], as the JAX version does. ``BatchNorm`` is flax's
``nn.BatchNorm`` (see its docstring). Max pooling is 3 x 3,
stride 2, padding 1. The convolutions are plain cuDNN calls on the card
(XLA convolutions in JAX, not Pallas kernels), computed in float32 like
the JAX version's on an f32 image.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from mmf_tpu_torch.modules.transformer import Dense

STAGE_SIZES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """flax ``nn.BatchNorm(epsilon=1e-5, momentum=0.99)`` over [B, C] or
    [B, C, H, W]: in eval mode the running statistics normalise; in
    training mode the batch's mean and biased variance normalise
    (``F.batch_norm``, cuDNN on the card) and the running statistics
    move by 1 - 0.99 towards them. torch moves ``running_var`` towards
    the unbiased variance, n / (n - 1) times the biased one that flax
    uses: that share is taken back after the call, from the variance
    before it (a few [C] operations, no second pass over the input).
    The parameter and buffer names are torch's (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.01)

    def _check_input_dim(self, x):
        if x.dim() not in (2, 4):
            raise ValueError(f"expected a 2-D or 4-D input, got {x.dim()}-D")

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]  # values a channel
        # the call updates copies: autograd keeps the statistics it was
        # given for the backward, and they must not change after it
        mean, var = self.running_mean.clone(), self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                           self.momentum, self.eps)
        with torch.no_grad():
            # var = (1 - m) before + m n / (n - 1) batch variance; flax's
            # (1 - m) before + m batch variance is this:
            self.running_var.mul_((1.0 - self.momentum) / n).add_(
                var, alpha=1.0 - 1.0 / n)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return out


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = _conv(in_channels, filters, 3, strides)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.downsample = strides != 1 or in_channels != filters
        if self.downsample:
            self.downsample_conv = _conv(in_channels, filters, 1, strides)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        out = filters * 4
        self.conv1 = _conv(in_channels, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, strides)
        self.bn2 = BatchNorm(filters)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = strides != 1 or in_channels != out
        if self.downsample:
            self.downsample_conv = _conv(in_channels, out, 1, strides)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class ResNet(nn.Module):
    """Input NCHW images; ``features_only`` returns the final [B, H', W',
    C] feature map (before pooling), used for grid features; otherwise
    the spatial mean, through a ``fc`` layer when ``num_classes``."""

    def __init__(self, depth: int = 152, num_classes: int = 0,
                 features_only: bool = True):
        super().__init__()
        self.features_only = features_only
        block = BasicBlock if depth in (18, 34) else BottleneckBlock
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        self.blocks = []
        channels = 64
        for i, n_blocks in enumerate(STAGE_SIZES[depth]):
            for j in range(n_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block(channels, 64 * 2 ** i, strides))
                self.blocks.append(name)
                channels = 64 * 2 ** i * block.expansion
        self.fc = (Dense(channels, num_classes)
                   if num_classes and not features_only else None)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        if self.features_only:
            return x.permute(0, 2, 3, 1)  # [B, H', W', C]
        x = x.mean(dim=(2, 3))
        return x if self.fc is None else self.fc(x)
