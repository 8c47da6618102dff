"""Image processors.

Port of ``mmf_tpu/datasets/processors/image_processors.py``: the
transforms ``Compose``, ``Resize``, ``CenterCrop``, ``RandomCrop``,
``RandomHorizontalFlip``, ``ToTensor``, ``ToPILImage`` (a no-op) and
``Normalize``; the registered processors ``torchvision_transforms``
(a config's list of transforms, falling back to registered processors
by name), ``GrayScaleTo3Channels``, ``ResizeShortest``,
``NormalizeBGR255`` and ``vilt_image_processor``. The output is a CHW
float32 numpy array, as in JAX. A decoded image (``RGBImage`` from the
image database's loader, or a PIL image) becomes [0, 1] floats; an array
passes as it is (CHW, or HWC made CHW).

JAX resizes each channel with PIL's ``BILINEAR`` filter in mode ``F``;
the port resizes with ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)``, the same filter (a triangle
widened by the scale when it shrinks), within float32 rounding of PIL's
fixed-point weights (the tests hold it within 1e-4 after ``Normalize(0.5,
0.5)``). ``RandomCrop``, ``RandomHorizontalFlip`` and
``ResizeShortest`` draw from numpy's global generator, as JAX's do. Not
ported yet: ``MelSpectrogram`` (audio).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.processors.processors import BaseProcessor


def _is_decoded(img) -> bool:
    from mmf_tpu_torch.datasets.databases.image_database import RGBImage

    return isinstance(img, RGBImage) or \
        type(img).__module__.startswith("PIL.")


def _to_chw_float(img) -> np.ndarray:
    """A decoded image -> CHW float32 in [0, 1]; an array -> CHW float32
    as it is (JAX's ``_to_chw_float``)."""
    if _is_decoded(img):
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(2, 0, 1)
    arr = np.asarray(img, np.float32)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and \
            arr.shape[-1] not in (1, 3):
        return arr
    if arr.ndim == 3:
        return arr.transpose(2, 0, 1)
    return arr


def _resize_chw(arr: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of a CHW array to ``size`` (h, w), or, for an
    int, of its shortest side to ``size`` with the aspect kept
    (torchvision's ``Resize(int)``)."""
    _, ih, iw = arr.shape
    if isinstance(size, int):
        if ih <= iw:
            size = (size, max(1, int(round(size * iw / ih))))
        else:
            size = (max(1, int(round(size * ih / iw))), size)
    h, w = (int(s) for s in size)
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].numpy()


class Resize:
    def __init__(self, size):
        self.size = int(size) if isinstance(size, (int, str)) else \
            tuple(int(s) for s in size)

    def __call__(self, x):
        return _resize_chw(_to_chw_float(x), self.size)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        x = _to_chw_float(x)
        th, tw = self.size
        _, h, w = x.shape
        i, j = max((h - th) // 2, 0), max((w - tw) // 2, 0)
        return x[:, i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        x = _to_chw_float(x)
        th, tw = self.size
        _, h, w = x.shape
        i = np.random.randint(0, max(h - th, 0) + 1)
        j = np.random.randint(0, max(w - tw, 0) + 1)
        return x[:, i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, x):
        x = _to_chw_float(x)
        if np.random.rand() < self.p:
            return x[:, :, ::-1].copy()
        return x


class ToTensor:
    def __call__(self, x):
        return _to_chw_float(x)


class ToPILImage:
    """A no-op: arrays stay arrays, and the next transform reads either
    layout."""

    def __call__(self, x):
        return x


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, x):
        return (_to_chw_float(x) - self.mean) / self.std


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


_TRANSFORMS = {
    "Resize": Resize,
    "CenterCrop": CenterCrop,
    "ToTensor": ToTensor,
    "Normalize": Normalize,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "RandomCrop": RandomCrop,
    "ToPILImage": ToPILImage,
}


def _on_image(transform, x):
    if isinstance(x, dict) and "image" in x:
        return {"image": transform(x["image"])}
    return transform(x)


@registry.register_processor("torchvision_transforms")
class TorchvisionTransforms(BaseProcessor):
    """The config's ``transforms``, in order: a name or ``{type,
    params}``; a name outside the transforms above is looked up among
    the registered processors, which get the params as their config."""

    def __init__(self, config, *args, **kwargs):
        params = config["transforms"]
        if isinstance(params, str):
            params = [params]
        transforms = []
        for param in params:
            if isinstance(param, str):
                ttype, tparams = param, {}
            else:
                ttype, tparams = param["type"], param.get("params", {}) or {}
            if ttype == "MelSpectrogram":
                raise NotImplementedError(
                    "MelSpectrogram (audio) is not ported yet")
            if ttype in _TRANSFORMS:
                cls = _TRANSFORMS[ttype]
                transforms.append(cls(**tparams) if isinstance(tparams, dict)
                                  else cls(tparams))
                continue
            processor_cls = registry.get_processor_class(ttype)
            if processor_cls is None:
                raise ValueError(
                    f"transform {ttype} is not present in torchvision-"
                    "equivalents or processor registry")
            transforms.append(processor_cls(
                tparams if isinstance(tparams, dict) else {"size": tparams}))
        self.transform = Compose(transforms)

    def __call__(self, x):
        return _on_image(self.transform, x)


@registry.register_processor("GrayScaleTo3Channels")
class GrayScaleTo3Channels(BaseProcessor):
    """A one-channel image repeated to three."""

    def __init__(self, *args, **kwargs):
        return

    def __call__(self, x):
        if isinstance(x, dict) and "image" in x:
            return {"image": self(x["image"])}
        x = _to_chw_float(x)
        if x.shape[0] == 1:
            x = np.concatenate([x] * 3, axis=0)
        return x


@registry.register_processor("ResizeShortest")
class ResizeShortest(BaseProcessor):
    """The shorter side to a size drawn from ``min_size``, the longer
    one kept within ``max_size``. As in JAX, built from a config (the
    ``torchvision_transforms`` path) it reads ``min_size`` from it and
    ``max_size`` only from keyword arguments."""

    def __init__(self, *args, **kwargs):
        min_size = kwargs.get("min_size", args[0] if args else 800)
        if isinstance(min_size, dict):
            min_size = min_size.get("min_size", 800)
        if not isinstance(min_size, (list, tuple)):
            min_size = (min_size,)
        self.min_size = min_size
        self.max_size = kwargs.get("max_size", 1333)

    def get_size(self, image_size):
        h, w = image_size
        size = np.random.choice(self.min_size)
        if self.max_size is not None:
            small, large = float(min(w, h)), float(max(w, h))
            if large / small * size > self.max_size:
                size = int(round(self.max_size * small / large))
        if (w <= h and w == size) or (h <= w and h == size):
            return (h, w)
        if w < h:
            return (int(size * h / w), size)
        return (size, int(size * w / h))

    def __call__(self, x):
        x = _to_chw_float(x)
        return _resize_chw(x, self.get_size(x.shape[1:]))


@registry.register_processor("NormalizeBGR255")
class NormalizeBGR255(BaseProcessor):
    """RGB in [0, 1] to BGR in [0, 255], minus ``mean`` over ``std``;
    zero-padded to ``pad_size`` squared when it is above 0."""

    def __init__(self, *args, **kwargs):
        cfg = args[0] if args and isinstance(args[0], dict) else kwargs
        self.mean = np.asarray(cfg.get("mean", [102.9801, 115.9465,
                                                122.7717]),
                               np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(cfg.get("std", [1.0, 1.0, 1.0]),
                              np.float32).reshape(-1, 1, 1)
        self.to_bgr255 = cfg.get("to_bgr255", True)
        self.pad_size = cfg.get("pad_size", -1)

    def __call__(self, x):
        x = _to_chw_float(x)
        if self.to_bgr255:
            x = x[[2, 1, 0]] * 255
        x = (x - self.mean) / self.std
        if self.pad_size > 0:
            if self.pad_size < x.shape[1] or self.pad_size < x.shape[2]:
                raise ValueError(f"image size: {x.shape} above pad_size "
                                 f"{self.pad_size}")
            padded = np.zeros((x.shape[0], self.pad_size, self.pad_size),
                              np.float32)
            padded[:, :x.shape[1], :x.shape[2]] = x
            x = padded
        return x


@registry.register_processor("vilt_image_processor")
class VILTImageProcessor(BaseProcessor):
    """Resize to ``size`` and normalise to [-1, 1] (reference
    image_processors.py:170-189)."""

    def __init__(self, config, *args, **kwargs):
        image_size = (config or {}).get("size", [224, 224])
        self.transform = Compose([
            Resize(image_size),
            Normalize([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
        ])

    def __call__(self, x: Any):
        return _on_image(self.transform, x)
