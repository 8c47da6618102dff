"""The image database: images read from a folder by annotation entry.

Port of ``mmf_tpu/datasets/databases/image_database.py``:
``ImageDatabase``, ``get_possible_image_paths`` and ``default_loader``.
JAX's loader is PIL's ``Image.open(...).convert("RGB")``. The card's
machine has no PIL, so the port's loader decodes PNG itself
(``decode_png``: the zlib stream with the standard library, the five row
filters in numpy) into what ``convert("RGB")`` gives, for every standard
PNG mode: grey at 1, 2, 4, 8 and 16 bits, grey with alpha, RGB and RGBA
at 8 and 16 bits, palettes of 1 to 8 bits, each plain or Adam7-interlaced.
As PIL maps them: grey replicated to three channels, 1-, 2- and 4-bit grey
scaled to 0-255, 16-bit grey clipped at 255, 16-bit colour cut to its high
byte, alpha and transparency dropped. It knows a PNG by its signature,
not by its file name, as PIL does. Any
other content (JPEG, ...) goes through PIL where PIL imports, and raises
naming the format where it does not; nothing is substituted. Either way
the loader returns an ``RGBImage``: [H, W, 3] uint8 pixels, which the
image processors scale to [0, 1] as JAX's scale a PIL image.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Optional

import numpy as np

from mmf_tpu_torch.utils.general import get_absolute_path

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}  # the bit depths the PNG standard allows
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_SIGNATURES = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
               (b"RIFF", "WebP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


class RGBImage:
    """A decoded image: ``pixels`` [H, W, 3] uint8, RGB."""

    mode = "RGB"

    def __init__(self, pixels: np.ndarray):
        if pixels.dtype != np.uint8 or pixels.ndim != 3 or \
                pixels.shape[2] != 3:
            raise ValueError(f"RGB pixels must be [H, W, 3] uint8, got "
                             f"{pixels.shape} {pixels.dtype}")
        self.pixels = pixels

    @property
    def size(self):
        """(width, height), as PIL gives it."""
        return self.pixels.shape[1], self.pixels.shape[0]

    def __array__(self, dtype=None, copy=None):
        return self.pixels if dtype is None else self.pixels.astype(dtype)


def _unfilter_average(line: np.ndarray, prev: np.ndarray, bpp: int):
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter_paeth(line: np.ndarray, prev: np.ndarray, bpp: int):
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines -> [H, stride] bytes; ``bpp``:
    bytes a pixel, at least 1 (the filters' left neighbour)."""
    height, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row, per sample
            cur = line.reshape(-1, bpp).cumsum(0, dtype=np.uint8)
            cur = cur.reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind == 3:
            cur = _unfilter_average(line, prev, bpp)
        elif kind == 4:
            cur = _unfilter_paeth(line, prev, bpp)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(raw: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """[H, stride] unfiltered bytes -> [H, width, channels] samples
    (uint16 at 16 bits, else uint8): 16-bit samples big-endian, 1-, 2-
    and 4-bit ones packed the first in the high bits."""
    height = raw.shape[0]
    if depth == 16:
        return np.ascontiguousarray(raw).view(">u2").astype(
            np.uint16).reshape(height, width, channels)
    if depth == 8:
        return raw.reshape(height, width, channels)
    bits = np.unpackbits(raw, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :width, None]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB, as PIL's ``convert("RGB")``.
    Raises, naming it, for what the PNG standard does not define (a bit
    depth a colour type does not take, an unknown filter)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not PNG content")
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth not in _DEPTHS.get(colour, ()):
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}: "
                         "not a standard PNG mode")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace}")
    channels = _CHANNELS[colour]
    bits = channels * depth  # a pixel's
    bpp = max(1, bits // 8)
    passes = []  # (x0, y0, dx, dy, columns, rows, bytes a row) of each
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w > 0 and h > 0:  # an empty pass has no scanlines
            passes.append((x0, y0, dx, dy, w, h, -(-w * bits // 8)))
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    need = sum(h * (stride + 1) for *_, h, stride in passes)
    if stream.size != need:
        raise ValueError(f"PNG data of {stream.size} bytes where its "
                         f"{width} x {height} pixels take {need}")
    samples = np.empty((height, width, channels),
                       np.uint16 if depth == 16 else np.uint8)
    used = 0
    for x0, y0, dx, dy, w, h, stride in passes:
        rows = stream[used:used + h * (stride + 1)].reshape(h, stride + 1)
        used += h * (stride + 1)
        samples[y0::dy, x0::dx] = _samples(_unfilter(rows, bpp), w, depth,
                                           channels)
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)  # PIL's black past the end
        table[:len(palette)] = palette
        return table[samples[..., 0]]
    if depth == 16:  # PIL: grey clipped at 255, colour's high byte
        samples = (np.minimum(samples, 255) if colour == 0
                   else samples >> 8).astype(np.uint8)
    elif depth < 8:  # grey scaled to 0-255
        samples = samples * np.uint8(255 // (2 ** depth - 1))
    if colour in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def image_format(data: bytes) -> str:
    """The format an image's bytes announce."""
    if data[:8] == PNG_SIGNATURE:
        return "PNG"
    for signature, name in _SIGNATURES:
        if data.startswith(signature):
            return name
    return "unrecognised"


def default_loader(path) -> RGBImage:
    """The image at ``path`` as RGB: PNG decoded here, anything else by
    PIL, which must import for it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return RGBImage(decode_png(data))
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: {image_format(data)} content needs PIL to decode, and "
            "PIL does not import here (the port decodes PNG itself)"
        ) from None
    with Image.open(io.BytesIO(data)) as img:
        return RGBImage(np.asarray(img.convert("RGB"), np.uint8))


def get_possible_image_paths(path):
    image_path = path.split(".")
    if len(image_path) == 1 or image_path[-1] not in (
        "jpg", "jpeg", "png", "gif", "bmp",
    ):
        image_path = [".".join(image_path) + ext
                      for ext in [".jpg", ".jpeg", ".png"]]
    else:
        image_path = [path]
    return image_path


class ImageDatabase:
    """Map-style image loader keyed by annotation entries (reference
    image_database.py)."""

    def __init__(self, config, path, annotation_db=None, transform=None,
                 loader=default_loader, is_valid_file=None,
                 image_key: Optional[str] = None, *args, **kwargs):
        self.config = config
        self.base_path = get_absolute_path(path)
        self._transform = transform
        self._annotation_db = annotation_db
        self.loader = loader
        self.image_key = image_key or config.get("image_key", None)
        self.is_valid_file = is_valid_file

    @property
    def annotation_db(self):
        return self._annotation_db

    @annotation_db.setter
    def annotation_db(self, annotation_db):
        self._annotation_db = annotation_db

    @property
    def transform(self):
        return self._transform

    @transform.setter
    def transform(self, transform):
        if isinstance(transform, (list, tuple)):
            from mmf_tpu_torch.datasets.processors.image_processors import (
                Compose,
            )

            transform = Compose(transform)
        self._transform = transform

    def _check_annotation_db_present(self):
        if not self.annotation_db:
            raise AttributeError(
                "'annotation_db' must be set to use __getitem__.")

    def __len__(self):
        self._check_annotation_db_present()
        return len(self.annotation_db)

    def __getitem__(self, idx):
        self._check_annotation_db_present()
        return self.get(self.annotation_db[idx])

    def get(self, item):
        return self.from_path(self._get_attrs(item))

    def from_path(self, paths, use_transforms=True):
        if isinstance(paths, str):
            paths = [paths]
        assert isinstance(paths, (list, tuple))
        loaded_images = []
        for image in paths:
            image_path = self._get_absolute_path(image)
            if os.path.exists(image_path):
                image = self.open_image(image_path)
                if self.transform and use_transforms:
                    image = self.transform(image)
                loaded_images.append(image)
        if not loaded_images:
            raise RuntimeError(f"Image not found from possible paths {paths} "
                               f"under {self.base_path}")
        return {"images": loaded_images}

    def open_image(self, path):
        return self.loader(path)

    def _get_attrs(self, item):
        """The possible file names of an entry's image (reference
        image_database.py)."""
        image, pick = None, None
        for attr in self._get_possible_attrs():
            image = item.get(attr, None)
            if image is not None:
                pick = attr
                break
        if pick == "identifier" and "left_url" in item and \
                "right_url" in item:
            return [image + "-img0", image + "-img1"]
        return get_possible_image_paths(image)

    def _get_possible_attrs(self):
        return [self.image_key, "flickr_30k_id", "Flikr30kID",
                "Flickr30kID", "identifier", "image_path", "image_name",
                "img", "image_id"]

    def _get_absolute_path(self, image):
        if os.path.isabs(str(image)):
            return image
        return os.path.join(self.base_path, str(image))
