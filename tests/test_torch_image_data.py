"""The image path of the port's data stack against PIL and the JAX package
on the CPU: the PNG decoder bit-equal to PIL's ``convert("RGB")`` over
every colour type and row filter, and over every standard PNG mode (bit
depths 1 to 16, alpha, palettes), plain and Adam7-interlaced (written
here: PIL reads Adam7 but does not write it); the ViLT image processor
within 1e-4 of JAX's (PIL's bilinear resize in mode F) after its [-1, 1]
normalisation; ``vilt_text_tokenizer``'s fields equal to JAX's; the VQA2
``use_images`` datasets of both packages giving the same samples on the
synthetic raw-image layout (the images within 1e-4); and JPEG content
without PIL raising, naming the format."""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_utils import registries_restored
from tests.torch_vqa2_layout import (
    IMAGE_SPLITS,
    image_layout_opts,
    png_bytes,
    write_image_layout,
)

torch.set_num_threads(2)  # several test workers share the host

RESIZE_ATOL = 1e-4
MODES = {"L": (6, 9), "LA": (6, 9, 2), "RGB": (7, 5, 3), "RGBA": (5, 8, 4)}


def _pil_png(pixels, mode, **save):
    buf = io.BytesIO()
    Image.fromarray(pixels, mode).save(buf, format="PNG", **save)
    return buf.getvalue()


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _filters(data):
    """The row filter types a PNG's rows use."""
    from mmf_tpu_torch.datasets.databases.image_database import decode_png

    import struct
    import zlib

    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, _, colour = header[:4]
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    assert decode_png(data).shape == (h, w, 3)
    return set(rows.reshape(h, w * bpp + 1)[:, 0].tolist())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_png_decoder_equals_pil_on_what_pil_writes(mode):
    """PIL's encoder picks each row's filter adaptively (Sub, Up and
    Paeth here); ``png_bytes`` writes each of the five below."""
    from mmf_tpu_torch.datasets.databases.image_database import decode_png

    rng = np.random.RandomState(0)
    seen = set()
    for trial in range(6):
        shape = (20 + 7 * trial, 31 - 2 * trial) + MODES[mode][2:]
        yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
        smooth = (yy * (trial + 1) + xx * 3) % 256
        if len(shape) == 3:
            smooth = np.stack([smooth + 40 * c for c in range(shape[2])], -1)
        noisy = smooth + rng.randint(0, 3 + 40 * (trial % 2), shape)
        pixels = (noisy % 256).astype(np.uint8)
        data = _pil_png(pixels, mode)
        np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))
        seen |= _filters(data)
    assert seen <= {0, 1, 2, 3, 4} and len(seen) > 1, seen


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_png_decoder_equals_pil_for_every_filter(mode, filters):
    from mmf_tpu_torch.datasets.databases.image_database import decode_png

    pixels = np.random.RandomState(len(filters)).randint(
        0, 256, MODES[mode]).astype(np.uint8)
    data = png_bytes(pixels, filters)
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))
    assert _filters(data) == set(filters)


# every standard PNG mode: name -> (colour type, bit depth)
PNG_MODES = {"grey1": (0, 1), "grey2": (0, 2), "grey4": (0, 4),
             "grey8": (0, 8), "grey16": (0, 16), "rgb8": (2, 8),
             "rgb16": (2, 16), "palette1": (3, 1), "palette2": (3, 2),
             "palette4": (3, 4), "palette8": (3, 8), "grey_alpha8": (4, 8),
             "grey_alpha16": (4, 16), "rgba8": (6, 8), "rgba16": (6, 16)}
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _packed_rows(samples, depth):
    """[H, W, C] samples -> [H, bytes] scanline bytes at ``depth`` bits
    (16-bit big-endian; 1, 2 and 4 bits packed, the first in the high
    bits)."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = (samples.reshape(h, w, 1) >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(h, w * depth), axis=1)


def _paeth_predict(a, b, c):
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def _png_any(samples, colour, depth, interlace, palette=None):
    """A PNG of ``samples`` ([H, W, C] at ``depth`` bits) in any standard
    mode, plain or Adam7-interlaced, each pass's rows filtered with None,
    Sub, Up, Average and Paeth in turn."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    data = bytearray()
    for i, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace
                                         else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        prev = None
        for y, row in enumerate(_packed_rows(sub, depth)):
            up = np.zeros_like(row) if prev is None else prev
            left = np.concatenate([np.zeros(bpp, np.uint8), row[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.uint8), up[:-bpp]])
            kind = (i + y) % 5
            pred = (np.zeros_like(row), left, up,
                    ((left.astype(np.uint16) + up) // 2).astype(np.uint8),
                    _paeth_predict(left, up, upleft))[kind]
            data.append(kind)
            data += (row - pred).astype(np.uint8).tobytes()
            prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (out + chunk(b"IDAT", zlib.compress(bytes(data)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("mode", sorted(PNG_MODES))
def test_png_decoder_equals_pil_in_every_mode(mode, interlace):
    """Bit-equal to PIL's ``convert("RGB")``: 1-, 2- and 4-bit grey
    scaled to 0-255, 16-bit grey clipped at 255, 16-bit colour cut to its
    high byte, alpha dropped, palettes looked up; sizes that leave Adam7
    passes empty and ragged."""
    from mmf_tpu_torch.datasets.databases.image_database import decode_png

    colour, depth = PNG_MODES[mode]
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    rng = np.random.RandomState(depth * 7 + colour)
    # grey16 straddles PIL's clip at 255
    top = {(0, 16): 600, (3, depth): 12}.get((colour, depth), 2 ** depth)
    palette = rng.randint(0, 256, (12, 3)) if colour == 3 else None
    for shape in ((1, 1), (3, 5), (13, 11), (17, 9)):
        samples = rng.randint(0, top, shape + (channels,)).astype(
            np.uint16 if depth == 16 else np.uint8)
        data = _png_any(samples, colour, depth, interlace, palette)
        with Image.open(io.BytesIO(data)) as img:
            assert img.info.get("interlace", 0) == int(interlace)
            want = np.asarray(img.convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want)


def test_png_decoder_equals_pil_for_palettes():
    from mmf_tpu_torch.datasets.databases.image_database import decode_png

    rng = np.random.RandomState(3)
    palette = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    indices = rng.randint(0, 16, (9, 13)).astype(np.uint8)
    for data in (png_bytes(indices, (0, 1, 2, 3, 4), palette=palette),
                 _pil_png_palette(rng)):
        np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def _pil_png_palette(rng):
    """A 12-colour palette image with a transparent entry, written by PIL
    (at 4 bits an index)."""
    img = Image.fromarray(rng.randint(0, 256, (10, 7, 3)).astype(np.uint8),
                          "RGB").convert("P", palette=Image.ADAPTIVE,
                                         colors=12)
    buf = io.BytesIO()
    img.save(buf, format="PNG", transparency=3)
    return buf.getvalue()


def test_loader_goes_by_content_and_raises_without_pil(tmp_path,
                                                       monkeypatch):
    from mmf_tpu_torch.datasets.databases.image_database import (
        RGBImage,
        default_loader,
    )

    pixels = np.random.RandomState(0).randint(0, 256, (6, 4, 3)).astype(
        np.uint8)
    path = tmp_path / "png_content.jpg"
    path.write_bytes(png_bytes(pixels))
    img = default_loader(str(path))
    assert isinstance(img, RGBImage) and img.size == (4, 6)
    np.testing.assert_array_equal(np.asarray(img), pixels)

    jpeg = tmp_path / "photo.png"
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG")
    jpeg.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(np.asarray(default_loader(str(jpeg))),
                                  np.asarray(Image.open(str(jpeg)).convert(
                                      "RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="JPEG content needs PIL"):
        default_loader(str(jpeg))
    assert isinstance(default_loader(str(path)), RGBImage)


def _vilt_processors(size):
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.utils.env import setup_imports as jsetup
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils.env import setup_imports

    jsetup()
    setup_imports()
    config = {"size": size}
    return (jreg.get_processor_class("vilt_image_processor")(config),
            registry.get_processor_class("vilt_image_processor")(config))


@pytest.mark.parametrize("shape,size", [((480, 640), [384, 384]),
                                        ((200, 300), [384, 384]),
                                        ((384, 384), [224, 224]),
                                        ((37, 90), [40, 40])])
def test_vilt_image_processor_matches_jax(shape, size):
    from mmf_tpu_torch.datasets.databases.image_database import (
        default_loader,
    )

    jax_proc, port_proc = _vilt_processors(size)
    pixels = np.random.RandomState(sum(shape)).randint(
        0, 256, shape + (3,)).astype(np.uint8)
    data = png_bytes(pixels)
    want = jax_proc(Image.open(io.BytesIO(data)).convert("RGB"))
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".jpg") as f:
        f.write(data)
        f.flush()
        got = port_proc({"image": default_loader(f.name)})["image"]
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, size[0], size[1])
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def test_vilt_text_tokenizer_matches_jax():
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu_torch.common.registry import registry

    vocab = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "data", "vocab.txt")
    _vilt_processors([8, 8])  # both registries set up
    config = {"tokenizer_config": {"type": "bert-base-uncased", "params": {
        "do_lower_case": True, "vocab_file": vocab}},
        "mask_probability": 0, "max_seq_length": 12}
    jproc = jreg.get_processor_class("vilt_text_tokenizer")(config)
    proc = registry.get_processor_class("vilt_text_tokenizer")(config)
    for item in ({"text": "What color is the man's shirt?"},
                 {"text": "a very long question " * 6},
                 {"tokens": ["How", "many", "dogs"]}):
        got, want = proc(item), jproc(item)
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value)
                assert got[key].dtype == value.dtype
            else:
                assert got[key] == value


@pytest.fixture
def restore_registries():
    """The datasets register their processors in each registry's state,
    where a later dataset of the same name would find them: put both
    states back as they were."""
    with registries_restored():
        yield


@pytest.fixture(scope="module")
def image_layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vqa2_images"))
    write_image_layout(root, n_train=10, n_val=4, n_test=3, n_images=8,
                       min_side=20, max_side=45, num_answers=6,
                       vocab_size=64, seed=2)
    return root


def _image_opts(root):
    return ["config=projects/vilt/configs/vqa2/defaults.yaml",
            "model=vilt", "datasets=vqa2", "training.device=cpu",
            "other_configs.image_w=24", "other_configs.image_h=24",
            "dataset_config.vqa2.processors.text_processor.params."
            "max_seq_length=12"] + image_layout_opts(root)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_vqa2_image_dataset_matches_jax(image_layout, split,
                                        restore_registries):
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration as JConfig
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration

    _vilt_processors([8, 8])
    datasets = []
    for reg, conf in ((jreg, JConfig), (registry, Configuration)):
        config = conf(_image_opts(image_layout)).get_config()
        reg.register("config", config)
        builder = reg.get_builder_class("vqa2")()
        datasets.append(builder.load_dataset(
            config["dataset_config"]["vqa2"], split))
    jds, ds = datasets
    assert len(ds) == len(jds) == {"train": 10, "val": 4, "test": 3}[split]
    assert len(ds.datasets) == len(IMAGE_SPLITS[split])
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        for key, value in want.items():
            if key == "image":
                assert got[key].shape == value.shape == (3, 24, 24)
                np.testing.assert_allclose(got[key], value,
                                           atol=RESIZE_ATOL, rtol=0)
            elif isinstance(value, (np.ndarray, np.generic)):
                np.testing.assert_array_equal(np.asarray(got[key]), value)
                assert np.asarray(got[key]).dtype == value.dtype, key
            else:
                assert got[key] == value, key
