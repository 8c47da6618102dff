"""Image processors: the part of ViLT's path.

Port of ``Compose``, ``Resize``, ``Normalize``, ``ToTensor`` and
``vilt_image_processor`` from
``mmf_tpu/datasets/processors/image_processors.py``. The output is a CHW
float32 numpy array, as in JAX. A decoded image (``RGBImage`` from the
image database's loader, or a PIL image) becomes [0, 1] floats; an array
passes as it is (CHW, or HWC made CHW).

JAX resizes each channel with PIL's ``BILINEAR`` filter in mode ``F``;
the port resizes with ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)``, the same filter (a triangle
widened by the scale when it shrinks), within float32 rounding of PIL's
fixed-point weights (the tests hold it within 1e-4 after ``Normalize(0.5,
0.5)``). Not ported yet: ``CenterCrop``, ``RandomCrop``,
``RandomHorizontalFlip``, ``MelSpectrogram``, ``torchvision_transforms``
and the other registered image processors.
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


class ToTensor:
    def __call__(self, x):
        return _to_chw_float(x)


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
        if isinstance(x, dict) and "image" in x:
            return {"image": self.transform(x["image"])}
        return self.transform(x)
