"""The port's checkpoint layer (``utils/checkpoint.py``): each behaviour of
the JAX package's ``tests/utils/test_checkpoint.py`` on a fake trainer
with a torch model, optimizer and schedule (config written, save and
resume, resume off, ``resume_best``, ``resume_file``, the three resets,
``max_to_keep``, ``finalize`` and ``restore``, config and git inside the
file, ``pretrained_state_mapping``, ``async_save``, the early-stopping
counts); then the JAX package as oracle: its ``Checkpoint`` loads a file
the port wrote with no missed key and bit-equal arrays, and a
reference-named BERT state_dict goes through the port's loader and
through JAX's ``convert_torch_state_dict`` to the same forward; the files
load under ``weights_only=True``; a resumed VisualBERT step repeats the
uninterrupted one bit for bit."""

import logging
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mmf_tpu_torch.config import omega
from mmf_tpu_torch.utils.checkpoint import Checkpoint, load_pretrained_model
from mmf_tpu_torch.utils.checkpoint_updater import params_from_jax
from tests.torch_port_utils import init_pair, tree_map

torch.set_num_threads(2)  # several test workers share the host


class _Classifier(nn.Module):
    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(4))


class FakeModel(nn.Module):
    """``encoder.weight`` and ``classifier.bias``, as the JAX test's
    ``encoder/kernel`` and ``classifier/bias``."""

    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.encoder = nn.Linear(4, 4, bias=False)
        self.classifier = _Classifier()
        with torch.no_grad():
            self.encoder.weight.copy_(torch.randn(4, 4, generator=g))
            self.classifier.bias.copy_(torch.randn(4, generator=g))


class FakeTrainer:
    """Duck-typed trainer exposing the surface Checkpoint reads: an AdamW
    with moments from one step, a LambdaLR, the counts and a train
    state's step."""

    def __init__(self, config, seed=0):
        self.config = config
        self.model = FakeModel(seed)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=0.1)
        self.lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda step: 1.0 / (1.0 + step))
        g = torch.Generator().manual_seed(seed + 1)
        for p in self.model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        saved = {n: p.detach().clone()
                 for n, p in self.model.named_parameters()}
        self.optimizer.step()  # moments, but the parameters stay
        self.model.load_state_dict(saved)
        self.train_state = types.SimpleNamespace(step=0)
        self.current_iteration = 0
        self.num_updates = 0
        self.current_epoch = 0
        self.early_stop_callback = None

    def kernel(self):
        return self.model.encoder.weight.detach().clone()

    def bias(self):
        return self.model.classifier.bias.detach().clone()

    def mu(self):
        return self.optimizer.state[self.model.encoder.weight][
            "exp_avg"].clone()


def make_config(tmp_path, **ckpt_overrides):
    ckpt = {"max_to_keep": -1, "resume": False, "reset": {}}
    ckpt.update(ckpt_overrides)
    return omega.create(
        {
            "model": "simple",
            "env": {"save_dir": str(tmp_path)},
            "checkpoint": ckpt,
        }
    )


def _bump(trainer, updates):
    """Mutate trainer state so save/load differences are observable."""
    with torch.no_grad():
        trainer.model.encoder.weight.add_(1.0)
        trainer.model.classifier.bias.sub_(1.0)
    trainer.optimizer.state[trainer.model.encoder.weight]["exp_avg"].add_(
        0.5)
    trainer.lr_scheduler.step()
    trainer.train_state.step = updates
    trainer.num_updates = updates
    trainer.current_iteration = updates
    trainer.current_epoch = 1


def _path(tmp_path, *parts):
    return os.path.join(str(tmp_path), *parts)


def test_save_config_written(tmp_path):
    config = make_config(tmp_path)
    Checkpoint(FakeTrainer(config))
    cfg_file = _path(tmp_path, "config.yaml")
    assert os.path.exists(cfg_file)
    loaded = omega.create(open(cfg_file).read())
    assert loaded["model"] == "simple"
    assert loaded["env"]["save_dir"] == str(tmp_path)


def test_save_and_resume_roundtrip(tmp_path):
    config = make_config(tmp_path, resume=True)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)

    _bump(trainer, updates=5)
    saved_kernel, saved_mu = trainer.kernel(), trainer.mu()
    saved_lr = trainer.optimizer.param_groups[0]["lr"]
    ckpt.save(5, iteration=5)
    assert os.path.isfile(_path(tmp_path, "models", "model_5.ckpt"))
    assert os.path.isfile(_path(tmp_path, "current.ckpt"))

    # fresh trainer resumes from current.ckpt
    trainer2 = FakeTrainer(config, seed=99)
    ckpt2 = Checkpoint(trainer2)
    ckpt2.load_state_dict()
    assert torch.equal(trainer2.kernel(), saved_kernel)
    assert torch.equal(trainer2.mu(), saved_mu)
    assert trainer2.num_updates == 5
    assert trainer2.current_iteration == 5
    assert trainer2.current_epoch == 1
    assert trainer2.train_state.step == 5
    assert trainer2.lr_scheduler.last_epoch == 1  # one schedule step
    assert trainer2.optimizer.param_groups[0]["lr"] == saved_lr


def test_resume_false_does_not_load(tmp_path):
    config = make_config(tmp_path, resume=False)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    _bump(trainer, updates=3)
    ckpt.save(3)

    trainer2 = FakeTrainer(config, seed=99)
    before = trainer2.kernel()
    Checkpoint(trainer2).load_state_dict()
    assert torch.equal(trainer2.kernel(), before)
    assert trainer2.num_updates == 0


def test_resume_best_prefers_best_ckpt(tmp_path):
    config = make_config(tmp_path, resume=True, resume_best=True)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)

    _bump(trainer, updates=2)
    best_kernel = trainer.kernel()
    ckpt.save(2, update_best=True)
    _bump(trainer, updates=7)  # later non-best save
    ckpt.save(7)

    trainer2 = FakeTrainer(config, seed=99)
    Checkpoint(trainer2).load_state_dict()
    assert torch.equal(trainer2.kernel(), best_kernel)
    assert trainer2.num_updates == 2


def test_resume_file(tmp_path):
    config = make_config(tmp_path, resume=False)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    _bump(trainer, updates=4)
    want = trainer.bias()
    ckpt.save(4)

    resume_path = _path(tmp_path, "models", "model_4.ckpt")
    config2 = make_config(tmp_path, resume_file=resume_path)
    trainer2 = FakeTrainer(config2, seed=99)
    Checkpoint(trainer2).load_state_dict()
    assert torch.equal(trainer2.bias(), want)


@pytest.mark.parametrize("option", ["resume_file", "resume_zoo"])
def test_zoo_keys_raise_instead_of_downloading(tmp_path, option):
    config = make_config(tmp_path, **{option: "visual_bert.pretrained.coco"})
    with pytest.raises(RuntimeError, match="downloads nothing"):
        Checkpoint(FakeTrainer(config)).load_state_dict()
    with pytest.raises(RuntimeError, match="downloads nothing"):
        load_pretrained_model("visual_bert.pretrained.coco")


def test_resets(tmp_path):
    config = make_config(tmp_path, resume=True)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    _bump(trainer, updates=6)
    ckpt.save(6)

    # reset counts: params restored, counters untouched
    cfg_counts = make_config(tmp_path, resume=True, reset={"counts": True})
    t = FakeTrainer(cfg_counts, seed=99)
    Checkpoint(t).load_state_dict()
    assert t.num_updates == 0 and t.train_state.step == 0
    assert torch.equal(t.kernel(), trainer.kernel())

    # reset optimizer: optimizer state untouched
    cfg_opt = make_config(tmp_path, resume=True, reset={"optimizer": True})
    t = FakeTrainer(cfg_opt, seed=99)
    before_mu = t.mu()
    Checkpoint(t).load_state_dict()
    assert torch.equal(t.mu(), before_mu)
    assert t.num_updates == 6

    # reset all
    cfg_all = make_config(tmp_path, resume=True, reset={"all": True})
    t = FakeTrainer(cfg_all, seed=99)
    before_mu = t.mu()
    Checkpoint(t).load_state_dict()
    assert torch.equal(t.mu(), before_mu)
    assert t.num_updates == 0


def test_max_to_keep_rotation(tmp_path):
    config = make_config(tmp_path, max_to_keep=2)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    for u in (1, 2, 3, 4):
        ckpt.save(u)
    models = sorted(os.listdir(_path(tmp_path, "models")))
    assert models == ["model_3.ckpt", "model_4.ckpt"]
    # current.ckpt always tracks the latest
    assert torch.load(_path(tmp_path, "current.ckpt"))["num_updates"] == 4


def test_finalize_and_restore(tmp_path):
    config = make_config(tmp_path)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    _bump(trainer, updates=9)
    best_kernel = trainer.kernel()
    ckpt.save(9, update_best=True)
    ckpt.finalize()
    final = _path(tmp_path, "simple_final.pth")
    # the reference's final file: the model's state_dict alone
    sd = torch.load(final, weights_only=True)
    assert set(sd) == {"encoder.weight", "classifier.bias"}
    assert torch.equal(sd["encoder.weight"], best_kernel)

    # restore() pulls best.ckpt back into the trainer
    _bump(trainer, updates=12)
    ckpt.restore()
    assert torch.equal(trainer.kernel(), best_kernel)


def test_meta_contains_config_and_git(tmp_path):
    config = make_config(tmp_path)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    ckpt.save(1)
    meta = torch.load(_path(tmp_path, "models", "model_1.ckpt"),
                      weights_only=True)
    assert isinstance(meta["config"], str)
    assert "model: simple" in meta["config"]
    # repo is a git checkout, so git metadata must be captured
    assert meta.get("git/commit_hash")
    from mmf_tpu_torch.utils.checkpoint_updater import (
        is_model_only_checkpoint,
    )

    assert not is_model_only_checkpoint(meta)
    assert is_model_only_checkpoint({"model": meta["model"]})


def test_pretrained_state_mapping(tmp_path):
    config = make_config(tmp_path)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    _bump(trainer, updates=2)
    pretrained_kernel, pretrained_bias = trainer.kernel(), trainer.bias()
    ckpt.save(2)

    cfg2 = make_config(
        tmp_path,
        resume_file=_path(tmp_path, "models", "model_2.ckpt"),
        resume_pretrained=True,
        pretrained_state_mapping={"encoder": "encoder"},
    )
    trainer2 = FakeTrainer(cfg2, seed=99)
    before_bias, before_mu = trainer2.bias(), trainer2.mu()
    Checkpoint(trainer2).load_state_dict()
    # mapped prefix copied...
    assert torch.equal(trainer2.kernel(), pretrained_kernel)
    # ...unmapped prefix, optimizer and counts untouched
    assert torch.equal(trainer2.bias(), before_bias)
    assert not torch.equal(before_bias, pretrained_bias)
    assert torch.equal(trainer2.mu(), before_mu)
    assert trainer2.num_updates == 0


def test_pretrained_state_mapping_matches_whole_segments(tmp_path):
    """'pooler' must not rewrite 't_pooler' (a bare substring test
    would)."""
    from mmf_tpu_torch.utils.checkpoint_updater import (
        get_pretrained_state_mapping_checkpoint,
    )

    config = make_config(tmp_path)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    torch.save({"model": {"t_encoder.weight": torch.ones(4, 4)}},
               _path(tmp_path, "other.ckpt"))
    cfg2 = make_config(tmp_path, resume_file=_path(tmp_path, "other.ckpt"),
                       resume_pretrained=True,
                       pretrained_state_mapping={"encoder": "t_encoder"})
    t = FakeTrainer(cfg2, seed=99)
    Checkpoint(t).load_state_dict()
    assert torch.equal(t.kernel(), torch.ones(4, 4))
    cfg3 = make_config(tmp_path, resume_file=_path(tmp_path, "other.ckpt"),
                       resume_pretrained=True,
                       pretrained_state_mapping={"coder": "t_encoder"})
    t = FakeTrainer(cfg3, seed=99)
    before = t.kernel()
    Checkpoint(t).load_state_dict()
    assert torch.equal(t.kernel(), before)
    assert ckpt is not None
    assert get_pretrained_state_mapping_checkpoint(
        {"t_encoder.weight": 1, "x": 2}, None, {"encoder": "t_encoder"}
    ) == {"encoder.weight": 1}


def test_async_save_roundtrip(tmp_path):
    config = make_config(tmp_path, resume=True, async_save=True)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    _bump(trainer, updates=3)
    want = trainer.kernel()
    ckpt.save(3)
    # the state was copied at save(): a change made while the write is in
    # flight does not reach the file
    _bump(trainer, updates=4)
    ckpt.wait_pending()
    assert os.path.isfile(_path(tmp_path, "current.ckpt"))

    trainer2 = FakeTrainer(config, seed=99)
    Checkpoint(trainer2).load_state_dict()
    assert torch.equal(trainer2.kernel(), want)
    assert trainer2.num_updates == 3


def test_early_stopping_counts_roundtrip(tmp_path):
    class FakeEarlyStopping:
        best_monitored_iteration = 11
        best_monitored_update = 10
        best_monitored_value = 0.75

        def __init__(self):
            self.restored = None

        def init_from_checkpoint(self, info):
            self.restored = info

    class FakeESCallback:
        def __init__(self):
            self.early_stopping = FakeEarlyStopping()

    config = make_config(tmp_path, resume=True)
    trainer = FakeTrainer(config)
    trainer.early_stop_callback = FakeESCallback()
    ckpt = Checkpoint(trainer)
    ckpt.save(10, iteration=11)

    trainer2 = FakeTrainer(config, seed=99)
    trainer2.early_stop_callback = FakeESCallback()
    Checkpoint(trainer2).load_state_dict()
    restored = trainer2.early_stop_callback.early_stopping.restored
    assert restored == {
        "best_iteration": 11,
        "best_update": 10,
        "best_metric_value": pytest.approx(0.75),
    }


def test_load_pretrained_model_prefers_current_over_final(tmp_path):
    """JAX's choice, kept: the sorted ``*.ckpt`` + ``*.pth`` glob puts
    ``current.ckpt`` before ``<model>_final.pth``."""
    config = make_config(tmp_path)
    trainer = FakeTrainer(config)
    ckpt = Checkpoint(trainer)
    ckpt.finalize()
    loaded = load_pretrained_model(str(tmp_path))
    assert set(loaded["checkpoint"]) == {"encoder.weight", "classifier.bias"}
    _bump(trainer, updates=1)
    ckpt.save(1)
    loaded = load_pretrained_model(str(tmp_path))
    assert loaded["checkpoint"]["num_updates"] == 1
    assert loaded["config"]["model"] == "simple"


# -- tiny VisualBERT: the JAX package as oracle ------------------------------

TINY_PRETRAIN = {
    "vocab_size": 101, "hidden_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "intermediate_size": 64,
    "visual_embedding_dim": 16, "max_position_embeddings": 32,
    "dtype": "float32", "training_head_type": "pretraining",
}
META = {"dataset_name": "masked_coco", "dataset_type": "train"}


def _mlm_batch(n=2, seed=0):
    from mmf_tpu_torch.utils.flagship import masked_coco_train_batch

    return masked_coco_train_batch(n, 8, 5, 16, 101, mask_probability=0.4,
                                   seed=seed)


def _port_trainer(model, tmp_path, seed=0, **ckpt):
    from mmf_tpu_torch.utils import flagship
    from mmf_tpu_torch.trainers.core.train_state import StepTrainer

    cfg = flagship.masked_coco_config([
        f"env.save_dir={tmp_path}", "scheduler.params.num_warmup_steps=1",
        "optimizer.params.lr=1e-3"])
    cfg["model_config"]["visual_bert"].update(TINY_PRETRAIN)
    cfg["checkpoint"].update(ckpt)
    state, step = flagship.masked_coco_trainer(model, cfg, seed=seed,
                                               device="cpu")
    return StepTrainer(cfg, state, step)


def test_jax_checkpoint_loads_a_port_file(tmp_path, caplog):
    from mmf_tpu.config import omega as jomega
    from mmf_tpu.utils.checkpoint import Checkpoint as JaxCheckpoint
    from mmf_tpu.utils.checkpoint_updater import _flatten_flax

    batch = _mlm_batch()
    jm, variables, tm = init_pair(TINY_PRETRAIN, batch)
    trainer = _port_trainer(tm, tmp_path / "port")
    trainer.train(batch)
    trainer.train(batch)
    Checkpoint(trainer).save(2)
    port_file = str(tmp_path / "port" / "current.ckpt")
    # the source of the JAX side's want: the port's weights after 2 steps,
    # as JAX variables
    params = jax.device_get(variables["params"])
    trained = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    class JaxFakeTrainer:
        def __init__(self, config):
            self.config = config
            self.model = jm
            self.variables = {"params": jax.tree_util.tree_map(
                np.zeros_like, params)}
            self.opt_state = {}
            self.current_iteration = self.num_updates = 0
            self.current_epoch = 0
            self.early_stop_callback = None

        def get_variables(self):
            return self.variables

        def set_variables(self, v):
            self.variables = v

        def get_opt_state(self):
            return self.opt_state

        def set_opt_state(self, s):
            self.opt_state = s

    jcfg = jomega.create({
        "model": "visual_bert", "env": {"save_dir": str(tmp_path / "jax")},
        "checkpoint": {"max_to_keep": -1, "resume": False, "reset": {},
                       "resume_file": port_file}})
    jt = JaxFakeTrainer(jcfg)
    with caplog.at_level(logging.INFO, logger="mmf_tpu.utils.checkpoint"):
        JaxCheckpoint(jt).load_state_dict()
    n_leaves = len(_flatten_flax(params))
    said = [r.getMessage() for r in caplog.records
            if "Adapted torch checkpoint" in r.getMessage()]
    assert said, caplog.text
    matched, missed, mismatched = map(int, re.findall(
        r"(\d+) matched / (\d+) missed / (\d+) shape", said[-1])[0])
    assert (matched, missed, mismatched) == (n_leaves, 0, 0)
    assert jt.num_updates == 2 and jt.current_iteration == 2
    got = params_from_jax(jax.device_get(jt.variables["params"]))
    assert set(got) == set(trained)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), trained[key],
                                      err_msg=key)


def _reference_names(sd):
    """The port's VisualBERT names -> the reference MMF's (HF BERT trunk
    under ``model.``, the NSP head under ``model.cls``)."""
    rules = [
        (r"^bert\.embeddings\.layer_norm", "bert.embeddings.LayerNorm"),
        (r"encoder\.layer_(\d+)\.attention\.(query|key|value)",
         r"encoder.layer.\1.attention.self.\2"),
        (r"encoder\.layer_(\d+)\.attention\.output_dense",
         r"encoder.layer.\1.attention.output.dense"),
        (r"encoder\.layer_(\d+)\.attention\.output_layer_norm",
         r"encoder.layer.\1.attention.output.LayerNorm"),
        (r"encoder\.layer_(\d+)\.ffn\.intermediate_dense",
         r"encoder.layer.\1.intermediate.dense"),
        (r"encoder\.layer_(\d+)\.ffn\.output_dense",
         r"encoder.layer.\1.output.dense"),
        (r"encoder\.layer_(\d+)\.ffn\.output_layer_norm",
         r"encoder.layer.\1.output.LayerNorm"),
        (r"^seq_relationship", "cls.seq_relationship"),
    ]
    out = {}
    for key, value in sd.items():
        for pattern, repl in rules:
            key = re.sub(pattern, repl, key)
        out["model." + key] = value
    return out


def test_reference_named_state_dict_loads_like_jax():
    from mmf_tpu.utils.checkpoint_updater import (
        HF_BERT_KEY_MAP,
        MODEL_KEY_MAPS,
        convert_torch_state_dict,
    )
    from mmf_tpu_torch.utils.checkpoint import load_model_weights
    from tests.torch_port_utils import port_visual_bert

    batch = _mlm_batch(3, seed=4)
    jm, variables, tm = init_pair(TINY_PRETRAIN, batch)
    ref_sd = _reference_names(tm.state_dict())
    assert "model.bert.encoder.layer.0.attention.self.query.weight" in ref_sd

    fresh = port_visual_bert(TINY_PRETRAIN).eval()
    stats = load_model_weights(fresh, ref_sd, "visual_bert")
    assert stats == {"matched": len(ref_sd), "missed": 0,
                     "shape_mismatch": 0}

    # the JAX converter CLI's composition (tools/scripts/convert_checkpoint.py)
    key_map = {r"^model\.": ""}
    key_map.update(MODEL_KEY_MAPS["visual_bert"])
    key_map.update({k: v for k, v in HF_BERT_KEY_MAP.items()
                    if k != r"^bert\."})
    zeros = jax.tree_util.tree_map(np.zeros_like,
                                   jax.device_get(variables["params"]))
    converted, jstats = convert_torch_state_dict(
        {k: v.numpy() for k, v in ref_sd.items()}, zeros, key_map=key_map,
        format_state_key=type(jm).format_state_key)
    assert jstats == stats
    jb = dict(tree_map(jnp.asarray, batch), **META)
    want = jm.apply({"params": converted}, jb, False)
    with torch.no_grad():
        got = fresh(dict(tree_map(torch.from_numpy, batch), **META))
    for key in ("scores", "seq_relationship_score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=2e-5, rtol=0)


def test_port_files_load_with_weights_only(tmp_path):
    from tests.torch_port_utils import port_visual_bert

    tm = port_visual_bert(dict(TINY_PRETRAIN, hidden_dropout_prob=0.1))
    tm.init_weights(torch.Generator().manual_seed(0))
    trainer = _port_trainer(tm, tmp_path)
    trainer.train(_mlm_batch())
    ckpt = Checkpoint(trainer)
    ckpt.save(1)
    ckpt.finalize()
    for name in ("current.ckpt", os.path.join("models", "model_1.ckpt"),
                 "visual_bert_final.pth"):
        loaded = torch.load(str(tmp_path / name), weights_only=True)
        assert loaded
    full = torch.load(str(tmp_path / "current.ckpt"), weights_only=True)
    assert {"model", "optimizer", "lr_scheduler", "train_state", "config",
            "num_updates", "current_iteration", "current_epoch"} <= set(full)
    assert full["train_state"] == {"step": 1}
    assert isinstance(full["config"], str)
    # the config snapshot builds the same model
    from mmf_tpu_torch.models.base_model import build_model
    from mmf_tpu_torch.config.configuration import load_yaml

    rebuilt = build_model(load_yaml(str(tmp_path / "config.yaml")))
    assert {k: tuple(v.shape) for k, v in rebuilt.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("restore_step", [True, False])
def test_resumed_step_repeats_the_uninterrupted_one(tmp_path, restore_step):
    """Save after 2 steps, take a third (loss L3); a fresh model,
    optimizer and schedule resumed from current.ckpt take the same third
    step to the same loss, bit for bit, with hidden dropout at 0.1. The
    step counter is part of it: with the resumed step put back to 0 the
    dropout stream, and so the loss, changes."""
    from tests.torch_port_utils import port_visual_bert

    overrides = dict(TINY_PRETRAIN, hidden_dropout_prob=0.1)
    batch = _mlm_batch()
    tm = port_visual_bert(overrides)
    tm.init_weights(torch.Generator().manual_seed(0))
    trainer = _port_trainer(tm, tmp_path)
    for _ in range(2):
        trainer.train(batch)
    Checkpoint(trainer).save(2)
    saved = {k: v.clone() for k, v in tm.state_dict().items()}
    l3 = float(trainer.train(batch)["total_loss"])

    fresh = port_visual_bert(overrides)
    resumed = _port_trainer(fresh, tmp_path, resume=True)
    Checkpoint(resumed).load_state_dict()
    assert resumed.train_state.step == 2 and resumed.num_updates == 2
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k]), k
    if not restore_step:
        resumed.train_state.step = 0
    again = float(resumed.train(batch)["total_loss"])
    assert (again == l3) == restore_step, (again, l3)
