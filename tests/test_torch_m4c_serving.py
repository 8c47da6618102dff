"""Serving M4C: a TextVQA M4C checkpoint and a TextCaps captioner
checkpoint, each written by the port's ``mmf_run`` (a small model,
2 updates, on the synthetic layouts with a 5000-answer vocabulary: a
served M4C sizes its classifier from the config's ``num_final_outputs``,
5050, as no dataset registers it outside a run), served on the CPU by
the port's ``ServingEngine.from_checkpoint`` and by ``mmf_serve``'s
``build_server`` (``device=cpu``), against JAX's
``ServingEngine.from_checkpoint`` on the same file (the port's weights
carried into JAX's params by the inverse of ``params_from_jax``).

- The samples are the datasets' own (``TextVQADataset.__getitem__``, its
  nested ``image_info_*`` / ``context_info_*`` dicts and uint8
  ``context_tokens`` included), less the fields that are not arrays
  (``sampled_idx_seq``), which JAX's ``_stack_samples`` refuses where
  they differ within a batch. They survive JAX's ``_stack_samples`` and
  ``_pad_batch``.
- The answers: the greedy decode's ``scores`` [12, 5050] within 2e-5 of
  JAX's at buckets 1, 2 and 4 (a batch of 3 padded to 4), and the
  rendered answer with no ``label``, as JAX's ``default_render`` gives
  it (``scores`` is 2-D). A served captioner masks no ``<unk>`` column:
  no answer processor is registered outside a run, in JAX too
  (ROADMAP C.4).
- JAX's HTTP path cannot take M4C's nested fields: its
  ``default_prepare`` makes a JSON object a 0-d object array, which its
  engine cannot send to the device (ROADMAP C.4). So M4C is served
  through the engine's ``predict_many`` in both packages, here and on
  the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_m4c_family_run import (
    _clear_processors,
    _restore_global_state,  # noqa: F401 (the module's autouse fixture)
    run_opts,
)
from tests.torch_port_utils import registries_restored, tree_map
from tests.torch_textvqa_layout import write_layout

torch.set_num_threads(2)  # several test workers share the host

ANSWERS = 5000
MODELS = {"textvqa": "m4c", "textcaps": "m4c_captioner"}


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """key -> (the run's save dir, its val dataset in the port)."""
    from mmf_tpu_torch.cli.run import run as port_run

    out = {}
    for key in MODELS:
        layout = str(tmp_path_factory.mktemp(f"{key}_serve_layout"))
        write_layout(layout, n_train=16, n_val=8, n_test=8, n_images=10,
                     max_obj=10, max_ocr=8, num_answers=ANSWERS,
                     vocab_size=200, seed=4, dataset=key)
        save = str(tmp_path_factory.mktemp(f"{key}_serve_save"))
        _clear_processors()
        opts = run_opts(key, layout, save, "training.max_updates=2",
                        "run_type=train")
        port_run(opts).teardown()
        out[key] = (save, _port_dataset(key, opts))
    _clear_processors()
    return out


def _port_dataset(key, opts):
    """The port's val dataset of the run's config."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration

    config = Configuration(opts).get_config()
    builder = registry.get_builder_class(key)()
    return builder.load_dataset(config["dataset_config"][key], "val")


def _samples(dataset, n):
    """The dataset's first ``n`` samples as request dicts of arrays."""
    def arrays(tree):
        return {k: arrays(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in tree.items()
                if isinstance(v, dict) or isinstance(v, (np.ndarray,
                                                         np.generic))}

    out = []
    for i in range(n):
        np.random.seed(i)
        out.append(arrays(dataset[i]))
    return out


def _jax_params(template, state):
    """The inverse of ``params_from_jax``: the port's state_dict as a flax
    params tree shaped like ``template``."""
    from mmf_tpu_torch.utils.checkpoint_updater import _LEAF, _VERBATIM

    def walk(tree, path):
        out = {}
        for name, value in tree.items():
            here = path + (name,)
            if isinstance(value, dict):
                out[name] = walk(value, here)
                continue
            key = ".".join(here if name in _VERBATIM
                           else here[:-1] + (_LEAF[name],))
            arr = state[key].numpy()
            if name == "kernel" and arr.ndim == 2:
                arr = arr.T
            assert arr.shape == value.shape, (key, arr.shape, value.shape)
            out[name] = arr
        return out

    return walk(template, ())


def _jax_engine(folder, key, samples, monkeypatch):
    """JAX's engine over the port's checkpoint folder."""
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.serving.engine import ServingEngine as JaxEngine
    from mmf_tpu.utils import checkpoint as jax_checkpoint
    from mmf_tpu.utils.env import setup_imports

    setup_imports()
    load = jax_checkpoint.load_pretrained_model

    def adapted(path, *args, **kwargs):
        from mmf_tpu.models.base_model import build_model
        from mmf_tpu.serving.engine import _stack_samples

        items = load(path, *args, **kwargs)
        jm = build_model(dict(items["config"]))
        batch = tree_map(jnp.asarray, _stack_samples(samples[:1]))
        template = jax.eval_shape(
            lambda b: jm.init(jax.random.PRNGKey(0), b, False), batch)
        state = torch.load(
            [os.path.join(folder, f) for f in os.listdir(folder)
             if f.endswith("_final.pth")][0], weights_only=True)
        params = _jax_params(jax.device_get(template)["params"], state)
        return dict(items, checkpoint={"variables": {"params": params}})

    monkeypatch.setattr(jax_checkpoint, "load_pretrained_model", adapted)
    with registries_restored(empty=True):
        engine = JaxEngine.from_checkpoint(folder, max_batch_size=4)
        assert jreg.get(f"{key}_num_final_outputs", no_warning=True) is None
    return engine


@pytest.mark.parametrize("key", sorted(MODELS))
def test_served_m4c_matches_jax_engine(folders, key, monkeypatch):
    from mmf_tpu.serving.server import default_render as jax_render
    from mmf_tpu_torch.cli import serve as serve_cli
    from mmf_tpu_torch.serving import ServingEngine
    from mmf_tpu_torch.serving.server import default_render

    folder, dataset = folders[key]
    samples = _samples(dataset, 7)
    assert isinstance(samples[0]["context_info_0"], dict)
    assert samples[0]["context_tokens"].dtype == np.uint8
    jengine = _jax_engine(folder, key, samples, monkeypatch)
    with registries_restored(empty=True):
        engine = ServingEngine.from_checkpoint(folder, device="cpu",
                                               max_batch_size=4)
        server = serve_cli.build_server(serve_cli.parse_opts(
            [f"checkpoint={folder}", "port=0", "device=cpu",
             "max_batch_size=4"]))
        assert engine.buckets == server.engine.buckets == (1, 2, 4)
        for chunk in (samples[:1], samples[1:3], samples[3:6]):
            want = jengine.predict_many(chunk)
            for got in (engine.predict_many(chunk),
                        server.engine.predict_many(chunk)):
                assert len(got) == len(want) == len(chunk)
                for g, w in zip(got, want):
                    assert set(g) == set(w) == {"scores"}
                    assert g["scores"].shape == (12, ANSWERS + 50)
                    np.testing.assert_allclose(g["scores"], w["scores"],
                                               atol=2e-5, rtol=0)
                    np.testing.assert_array_equal(
                        g["scores"].argmax(-1), w["scores"].argmax(-1))
                    rendered, jax_rendered = default_render(g), \
                        jax_render(w)
                    assert set(rendered) == set(jax_rendered) == {"scores"}
        one = engine.predict(samples[6])["scores"]
        # no <unk> masking outside a run (no answer processor registered)
        assert (one[:, 3] > -1e9).all()


def test_jax_http_path_cannot_take_m4c_fields(folders):
    """JAX's ``default_prepare`` on an M4C request: the nested
    ``context_info_0`` becomes a 0-d object array, which the model cannot
    index and the device cannot take."""
    from mmf_tpu.serving.server import default_prepare

    sample = _samples(folders["textvqa"][1], 1)[0]

    def conv(v):
        return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) \
            else np.asarray(v).tolist()

    prepared = default_prepare(None, {"fields": conv(sample)})
    info = prepared["context_info_0"]
    assert isinstance(info, np.ndarray) and info.dtype == object
    assert info.shape == ()
    with pytest.raises(IndexError):
        info["max_features"]
    with pytest.raises(TypeError):
        jax.device_put(np.stack([info, info]))
    assert prepared["context_tokens"].dtype == np.int32
