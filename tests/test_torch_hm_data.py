"""The Hateful Memes data path and BatchNorm's statistics in the port
against the JAX package on the CPU:

- ``BatchNorm`` (the port's flax semantics): after two training steps
  its running mean and variance equal flax ``nn.BatchNorm``'s
  ``batch_stats`` within 1e-6 relative, over [B, C] and [B, C, H, W]
  inputs, and a ResNet-18's after two training forwards (torch's stock
  module moves the variance towards the unbiased batch variance, flax's
  towards the biased one);
- each image transform and processor, and ``torchvision_transforms``
  over the Hateful Memes config, within 1e-4 of JAX's on decoded PNG
  memes (PIL's bilinear resize in mode F against torch's antialiased
  one);
- both Hateful Memes datasets give JAX's samples on the synthetic layout
  (images within 1e-4), the fine-grained labels included, and
  ``format_for_prediction`` gives JAX's rows.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_hm_layout import SPLITS, layout_opts, write_layout
from tests.torch_port_utils import registries_restored
from tests.torch_vqa2_layout import png_bytes

torch.set_num_threads(2)  # several test workers share the host

RESIZE_ATOL = 1e-4
STATS_REL = 1e-6


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# --- BatchNorm -------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 3, 2, 2), (32, 5), (6, 4, 3, 5)])
def test_batch_norm_running_statistics_match_flax(shape):
    """Two training steps from running statistics (0, 1): the first
    shape is a batch of four 2 x 2 maps of 3 channels."""
    import flax.linen as fnn

    from mmf_tpu_torch.modules.resnet import BatchNorm

    rng = np.random.RandomState(sum(shape))
    xs = [(rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)
          for _ in range(2)]
    channels_last = (lambda x: np.moveaxis(x, 1, -1)) if len(shape) == 4 \
        else (lambda x: x)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-5)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.asarray(channels_last(xs[0])))
    bn = BatchNorm(shape[1]).train()
    for x in xs:
        want, mutated = jm.apply(variables, jnp.asarray(channels_last(x)),
                                 mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = bn(torch.from_numpy(x))
        np.testing.assert_allclose(channels_last(got.detach().numpy()),
                                   np.asarray(want), atol=2e-5, rtol=0)
    stats = variables["batch_stats"]
    for ours, theirs in ((bn.running_mean, stats["mean"]),
                         (bn.running_var, stats["var"])):
        assert _rel(ours.numpy(), np.asarray(theirs)) < STATS_REL
    assert int(bn.num_batches_tracked) == 2
    # the eval forward normalises with those statistics
    jm_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-5)
    want = jm_eval.apply(variables, jnp.asarray(channels_last(xs[0])))
    got = bn.eval()(torch.from_numpy(xs[0]))
    np.testing.assert_allclose(channels_last(got.detach().numpy()),
                               np.asarray(want), atol=2e-5, rtol=0)


def test_resnet_batch_stats_after_two_training_forwards_match_flax():
    from mmf_tpu.modules.resnet import ResNet as JaxResNet
    from mmf_tpu_torch.modules.resnet import ResNet
    from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax

    rng = np.random.RandomState(7)
    xs = [rng.randn(4, 3, 32, 32).astype(np.float32) for _ in range(2)]
    jm = JaxResNet(depth=18, features_only=True)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    tm = ResNet(depth=18, features_only=True)
    tm.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])), strict=True)
    tm.train()
    for x in xs:
        _, mutated = jm.apply(variables, jnp.asarray(x), True,
                              mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        with torch.no_grad():
            tm(torch.from_numpy(x))
    want = params_from_jax({}, jax.device_get(variables["batch_stats"]))
    got = tm.state_dict()
    worst = max(_rel(got[k].numpy(), want[k].numpy())
                for k in want if k.endswith(("running_mean", "running_var")))
    # 20 BatchNorms deep: the convolutions' f32 sums in other orders
    assert worst < 2e-5, worst


# --- processors ------------------------------------------------------------
def _processor_classes():
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.utils.env import setup_imports as jsetup
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils.env import setup_imports

    jsetup()
    setup_imports()
    return jreg, registry


def _decoded(pixels, tmp_path, palette=None):
    """(PIL's RGB image, the port's decoded image) of one PNG."""
    from mmf_tpu_torch.datasets.databases.image_database import (
        default_loader,
    )

    data = png_bytes(pixels, palette=palette)
    path = tmp_path / "meme.png"
    path.write_bytes(data)
    return (Image.open(io.BytesIO(data)).convert("RGB"),
            default_loader(str(path)))


TRANSFORMS = [
    ("Resize", {"size": [40, 40]}),
    ("Resize", {"size": 24}),
    ("CenterCrop", {"size": [20, 30]}),
    ("CenterCrop", {"size": 64}),
    ("ToTensor", {}),
    ("ToPILImage", {}),
    ("Normalize", {"mean": [0.5, 0.4, 0.3], "std": [0.2, 0.3, 0.25]}),
]


@pytest.mark.parametrize("name,params", TRANSFORMS)
def test_transform_matches_jax(name, params, tmp_path):
    from mmf_tpu.datasets.processors import image_processors as jip
    from mmf_tpu_torch.datasets.processors import image_processors as ip

    pixels = np.random.RandomState(len(name)).randint(
        0, 256, (45, 57, 3)).astype(np.uint8)
    pil, decoded = _decoded(pixels, tmp_path)
    jt, pt = getattr(jip, name)(**params), getattr(ip, name)(**params)
    want, got = np.asarray(jt(pil), np.float32), np.asarray(pt(decoded),
                                                           np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["RandomCrop", "RandomHorizontalFlip"])
def test_random_transforms_draw_as_jax_does(name, tmp_path):
    """The same draws from numpy's global generator, in one process."""
    from mmf_tpu.datasets.processors import image_processors as jip
    from mmf_tpu_torch.datasets.processors import image_processors as ip

    pixels = np.random.RandomState(3).randint(0, 256, (30, 41, 3)).astype(
        np.uint8)
    pil, decoded = _decoded(pixels, tmp_path)
    arg = [16, 24] if name == "RandomCrop" else 0.5
    seen = set()
    for seed in range(6):
        np.random.seed(seed)
        want = getattr(jip, name)(arg)(pil)
        np.random.seed(seed)
        got = getattr(ip, name)(arg)(decoded)
        np.testing.assert_array_equal(got, want)
        seen.add(got.tobytes())
    assert len(seen) > 1  # the draws move the result


@pytest.mark.parametrize("shape,params", [
    ((45, 31), {"min_size": 20}),
    ((31, 90), {"min_size": [16, 24]}),
    ((20, 20), {"min_size": 20}),
])
def test_resize_shortest_matches_jax(shape, params, tmp_path):
    jreg, registry = _processor_classes()
    pixels = np.random.RandomState(shape[0]).randint(
        0, 256, shape + (3,)).astype(np.uint8)
    pil, decoded = _decoded(pixels, tmp_path)
    np.random.seed(0)
    want = jreg.get_processor_class("ResizeShortest")(params)(pil)
    np.random.seed(0)
    got = registry.get_processor_class("ResizeShortest")(params)(decoded)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)
    # keyword form: max_size caps the longer side
    kw = dict(min_size=40, max_size=50)
    np.random.seed(0)
    want = jreg.get_processor_class("ResizeShortest")(**kw)(pil)
    np.random.seed(0)
    got = registry.get_processor_class("ResizeShortest")(**kw)(decoded)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("params", [{}, {"pad_size": 64, "to_bgr255": False},
                                    {"mean": [1.0, 2.0, 3.0],
                                     "std": [2.0, 3.0, 4.0]}])
def test_normalize_bgr255_matches_jax(params, tmp_path):
    jreg, registry = _processor_classes()
    pixels = np.random.RandomState(5).randint(0, 256, (33, 47, 3)).astype(
        np.uint8)
    pil, decoded = _decoded(pixels, tmp_path)
    want = jreg.get_processor_class("NormalizeBGR255")(params)(pil)
    got = registry.get_processor_class("NormalizeBGR255")(params)(decoded)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def test_grey_scale_to_3_channels_matches_jax():
    jreg, registry = _processor_classes()
    grey = np.random.RandomState(6).rand(1, 9, 7).astype(np.float32)
    for x in (grey, np.concatenate([grey] * 3)):
        want = jreg.get_processor_class("GrayScaleTo3Channels")()(
            {"image": x})["image"]
        got = registry.get_processor_class("GrayScaleTo3Channels")()(
            {"image": x})["image"]
        assert got.shape == want.shape == (3, 9, 7)
        np.testing.assert_array_equal(got, want)


def _hateful_memes_transforms():
    from mmf_tpu_torch.config.configuration import load_yaml

    cfg = load_yaml("configs/datasets/hateful_memes/defaults.yaml")
    return cfg["dataset_config"]["hateful_memes"]["processors"][
        "image_processor"]["params"]


@pytest.mark.parametrize("kind", ["rgb", "grey", "palette", "small"])
def test_torchvision_transforms_of_the_config_match_jax(kind, tmp_path):
    """The dataset config's Resize 256, CenterCrop 224, ToTensor,
    GrayScaleTo3Channels and Normalize on memes of every kind."""
    jreg, registry = _processor_classes()
    rng = np.random.RandomState(len(kind))
    shape = (180, 240) if kind == "small" else (310, 457)
    pixels = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    palette = None
    if kind == "grey":
        pixels = pixels[..., 0]
    elif kind == "palette":
        palette = rng.randint(0, 256, (16, 3))
        pixels = pixels[..., 0] // 16
    pil, decoded = _decoded(pixels, tmp_path, palette)
    params = _hateful_memes_transforms()
    want = jreg.get_processor_class("torchvision_transforms")(params)(
        {"image": pil})["image"]
    got = registry.get_processor_class("torchvision_transforms")(params)(
        {"image": decoded})["image"]
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, 224, 224)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def test_torchvision_transforms_fall_back_to_registered_processors():
    _, registry = _processor_classes()
    cls = registry.get_processor_class("torchvision_transforms")
    proc = cls({"transforms": ["ToTensor", {"type": "NormalizeBGR255",
                                            "params": {"to_bgr255": False}}]})
    x = np.full((3, 2, 2), 200.0, np.float32)
    np.testing.assert_allclose(proc(x)[2], 200.0 - 122.7717, rtol=1e-6)
    with pytest.raises(ValueError, match="Nope"):
        cls({"transforms": ["Nope"]})
    with pytest.raises(NotImplementedError, match="MelSpectrogram"):
        cls({"transforms": [{"type": "MelSpectrogram", "params": {}}]})


# --- datasets --------------------------------------------------------------
@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hateful_memes"))
    write_layout(root, n_train=7, n_val=4, n_test=3, n_images=5,
                 vocab_size=200, seed=3, features=True, regions=6,
                 feature_dim=16, fine_grained=True)
    return root


SMALL_IMAGES = ("dataset_config.hateful_memes.processors.image_processor."
                "params.transforms=[{type: Resize, params: {size: [40, 40]}},"
                " {type: CenterCrop, params: {size: [32, 32]}}, ToTensor, "
                "GrayScaleTo3Channels, {type: Normalize, params: {mean: "
                "[0.46777044, 0.44531429, 0.40661017], std: [0.12221994, "
                "0.12145835, 0.14380469]}}]")
FEATURES = ["dataset_config.hateful_memes.use_features=true",
            "dataset_config.hateful_memes.use_images=false",
            "dataset_config.hateful_memes.max_features=6"] + [
    f"dataset_config.hateful_memes.features.{s}="
    "[hateful_memes/defaults/features]" for s in SPLITS]
FINE_GRAINED = [
    "dataset_config.hateful_memes.fg_dataset_type=pc_attack",
    "dataset_config.hateful_memes.is_multilabel=true",
    "dataset_config.hateful_memes.processors.answer_processor.type="
    "multi_hot_answer_from_vocab",
    "dataset_config.hateful_memes.processors.answer_processor.params="
    "{num_answers: 1, vocab_file: LABELS, preprocessor: "
    "{type: simple_word, params: {}}}",
]
CASES = {
    "images_bert": ("configs/datasets/hateful_memes/bert.yaml",
                    [SMALL_IMAGES], True),
    "images_vocab": ("configs/datasets/hateful_memes/defaults.yaml",
                     [SMALL_IMAGES], False),
    "features_bert": ("configs/datasets/hateful_memes/bert.yaml",
                      FEATURES, True),
    "features_fine_grained": ("configs/datasets/hateful_memes/bert.yaml",
                              FEATURES + FINE_GRAINED, True),
}


def _labels_file(root):
    from tests.torch_hm_layout import ATTACKS, GROUPS

    path = os.path.join(root, "pc_attack_vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(GROUPS + ATTACKS + ["pc_empty", "attack_empty"])
                + "\n")
    return path


def _datasets(root, case, split):
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.config.configuration import Configuration as JConfig
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration

    _processor_classes()
    config_file, opts, bert = CASES[case]
    opts = [o.replace("LABELS", _labels_file(root)) for o in opts]
    args = [f"config={config_file}", "model=mmbt", "datasets=hateful_memes",
            "training.device=cpu",
            "dataset_config.hateful_memes.processors.text_processor.params."
            + ("max_seq_length=16" if bert else "max_length=10")]
    out = []
    for reg, conf in ((jreg, JConfig), (registry, Configuration)):
        config = conf(args + layout_opts(root, bert) + opts).get_config()
        reg.register("config", config)
        builder = reg.get_builder_class("hateful_memes")()
        out.append(builder.load_dataset(
            config["dataset_config"]["hateful_memes"], split))
    return out


def _assert_same_sample(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "image":
            assert got[key].shape == value.shape == (3, 32, 32)
            np.testing.assert_allclose(got[key], value, atol=RESIZE_ATOL,
                                       rtol=0)
        elif isinstance(value, dict):
            _assert_same_sample(got[key], value)
        elif isinstance(value, (np.ndarray, np.generic)):
            np.testing.assert_array_equal(np.asarray(got[key]), value)
            assert np.asarray(got[key]).dtype == value.dtype, key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_hateful_memes_dataset_matches_jax(layout, case, split):
    with registries_restored(empty=True):
        jds, ds = _datasets(layout, case, split)
        assert type(ds.datasets[0]).__name__ == type(
            jds.datasets[0]).__name__
        assert len(ds) == len(jds) == {"train": 7, "val": 4, "test": 3}[split]
        for i in range(len(ds)):
            _assert_same_sample(ds[i], jds[i])
        if case == "features_fine_grained":
            width = ds.datasets[0].answer_processor.get_vocab_size()
            assert width >= 14 and ds[0]["targets"].shape == (width,)


@pytest.mark.parametrize("multilabel", [False, True])
def test_format_for_prediction_matches_jax(layout, multilabel):
    case = "features_fine_grained" if multilabel else "images_bert"
    with registries_restored(empty=True):
        jds, ds = _datasets(layout, case, "test")
        width = 14 if multilabel else 2
        report = {"id": np.asarray([4, 9, 11], np.int32),
                  "scores": np.random.RandomState(1).randn(3, width).astype(
                      np.float32)}
        want = jds.datasets[0].format_for_prediction(report)
        got = ds.datasets[0].format_for_prediction(report)
        assert got == want
        assert json.loads(json.dumps(got)) == got


def test_lmdb_features_raise_naming_the_reader(layout):
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration

    _processor_classes()
    with registries_restored(empty=True):
        opts = [f"config=configs/datasets/hateful_memes/bert.yaml",
                "model=mmbt", "datasets=hateful_memes",
                "dataset_config.hateful_memes.use_features=true",
                "dataset_config.hateful_memes.use_images=false"]
        config = Configuration(opts + layout_opts(layout)).get_config()
        registry.register("config", config)
        lmdb = os.path.join(layout, "datasets", "hateful_memes", "defaults",
                            "features", "detectron.lmdb")
        os.makedirs(lmdb, exist_ok=True)
        builder = registry.get_builder_class("hateful_memes")()
        # the LMDB reader opens the environment at the first read: an
        # empty folder holds no data.mdb
        with pytest.raises(RuntimeError, match="no lmdb database at .*"
                                               "detectron.lmdb"):
            ds = builder.load_dataset(
                config["dataset_config"]["hateful_memes"], "train")
            ds[0]
