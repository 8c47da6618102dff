"""Checkpointing with MMF semantics on ``torch.save``.

Port of ``mmf_tpu/utils/checkpoint.py``, in the reference MMF's file
format. Layout under ``env.save_dir``:
  - ``config.yaml``                  the config snapshot
  - ``models/model_<update>.ckpt``   interval snapshots (``max_to_keep``)
  - ``current.ckpt``                 rolling latest (the resume target)
  - ``best.ckpt``                    best on validation (``update_best``)
  - ``<prefix><model>_final.pth``    the model's state_dict alone

Each ``.ckpt`` is one ``torch.save`` of a dict holding ``model`` (the
port's ``state_dict`` on the CPU, under the port's own names),
``optimizer`` (the torch ``state_dict``), ``lr_scheduler``, the counts
(``current_iteration``, ``num_updates``, ``current_epoch``, ``best_*``),
``train_state`` (``{"step": ...}``: the step seeds the dropout stream),
``config`` as a YAML string and the git details. Only strings, numbers,
tensors and plain containers are saved, so every file loads under
``torch.load(weights_only=True)`` and runs no pickled code. The JAX
package reads these files too (``_adapt_torch_ckpt``).

Loading takes the port's own files and reference-named MMF state_dicts
(full or model-only) through ``checkpoint_updater``'s key maps, logs the
matched, missed and shape-mismatch counts, and copies onto the live
model's device. Resume precedence: ``resume`` (``current.ckpt``, or
``best.ckpt`` under ``resume_best``), then ``resume_file``, then
``resume_zoo``; the ``reset.{all,optimizer,counts}`` flags;
``pretrained_state_mapping`` under ``resume_pretrained``. A zoo key needs
a download, which the port does not do: it raises.

The trainer is read through MMF's trainer attributes: ``config``,
``model``, ``optimizer``, an optional ``lr_scheduler``,
``current_iteration``, ``num_updates``, ``current_epoch``, an optional
``early_stop_callback`` and an optional ``train_state``
(``trainers.core.train_state.StepTrainer`` has them all).
"""

from __future__ import annotations

import copy
import glob
import logging
import os
import shutil
import subprocess
from typing import Any, Dict, Optional

import torch

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.config import omega
from mmf_tpu_torch.utils.checkpoint_updater import (
    convert_reference_state_dict,
    reference_key_map,
)
from mmf_tpu_torch.utils.distributed import is_main, synchronize

logger = logging.getLogger(__name__)


def _to_cpu(tree):
    """A copy of a nested state on the CPU, taken now: tensors copied,
    containers rebuilt, other leaves deep-copied."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return copy.deepcopy(tree)


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _save(obj, path: str):
    """``torch.save`` to a temporary name, then renamed into place."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _copy(src: str, dst: str):
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _zoo_error(key: str) -> RuntimeError:
    return RuntimeError(
        f"checkpoint {key!r} is not a path here, so it would be a zoo key; "
        "the port downloads nothing: fetch the checkpoint and pass its path"
    )


def get_git_info() -> Dict[str, str]:
    """Best-effort git metadata for reproducibility
    (reference checkpoint.py:476-496)."""
    info = {}
    try:
        here = os.path.dirname(os.path.abspath(__file__))

        def run(args):
            return subprocess.check_output(
                args, cwd=here, stderr=subprocess.DEVNULL
            ).decode("utf-8").strip()

        info["git/branch"] = run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
        info["git/commit_hash"] = run(["git", "rev-parse", "HEAD"])
        info["git/commit_message"] = run(["git", "log", "-1", "--format=%s"])
    except Exception:
        pass
    return info


def model_state(ckpt: Dict[str, Any]) -> Optional[Dict[str, torch.Tensor]]:
    """The model state_dict of a loaded checkpoint: its ``model`` entry,
    or the file itself when it is a bare state_dict (``finalize``'s, or a
    reference ``.pth``)."""
    sd = ckpt.get("model")
    if isinstance(sd, dict):
        return sd
    if ckpt and all(isinstance(v, torch.Tensor) for v in ckpt.values()):
        return ckpt
    return None


def load_model_weights(model: torch.nn.Module, state_dict: Dict[str, Any],
                       model_name: Optional[str] = None,
                       strict: bool = False) -> Dict[str, int]:
    """Load ``state_dict`` (the port's names, or a reference MMF model's
    names through the key maps of ``model_name``) into ``model``, on its
    device. Unfilled entries of the model keep their values, or, when
    ``strict``, raise (as flax does on a missing leaf). Returns the
    counts."""
    if hasattr(model, "materialize_from_state_dict"):
        model.materialize_from_state_dict(state_dict)  # layers it sizes
    own = model.state_dict()
    converted, stats = convert_reference_state_dict(
        state_dict, own, reference_key_map(model_name),
        getattr(type(model), "format_state_key", None))
    unfilled = [k for k in own if k not in converted]
    if strict and unfilled:
        raise KeyError(
            f"the checkpoint leaves {len(unfilled)} of model "
            f"'{model_name}''s {len(own)} entries unfilled: "
            f"{unfilled[:8]}{' ...' if len(unfilled) > 8 else ''}"
        )
    model.load_state_dict(converted, strict=False)
    logger.info(
        f"Loaded weights for model '{model_name}': {stats['matched']} "
        f"matched / {stats['missed']} missed / {stats['shape_mismatch']} "
        "shape mismatches"
    )
    return stats


class Checkpoint:
    def __init__(self, trainer):
        self.trainer = trainer
        self.config = trainer.config
        self.save_dir = self.config["env"]["save_dir"]
        self.model_name = self.config["model"]

        self.ckpt_foldername = self.save_dir
        self.ckpt_prefix = ""
        model = getattr(trainer, "model", None)
        if hasattr(model, "get_ckpt_name"):
            self.ckpt_prefix = model.get_ckpt_name() + "_"

        self.pth_filepath = os.path.join(
            self.ckpt_foldername,
            self.ckpt_prefix + self.model_name + "_final.pth",
        )
        self.models_foldername = os.path.join(self.ckpt_foldername, "models")
        if is_main():
            os.makedirs(self.models_foldername, exist_ok=True)
        synchronize()
        self.max_to_keep = self.config["checkpoint"].get("max_to_keep", -1)
        self.saved_iterations = []
        # async_save: disk writes happen on a single background thread so
        # the train loop only pays the copy to the host. Ordering is
        # preserved (one worker); loads and finalize wait for pending
        # writes.
        self._async = self.config["checkpoint"].get("async_save", False)
        self._writer = None
        self._pending = None
        if self._async:
            from concurrent.futures import ThreadPoolExecutor

            self._writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer"
            )
        self.save_config()

    def wait_pending(self):
        """Block until the in-flight async write (if any) is on disk."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def save_config(self):
        if not is_main():
            return
        cfg_file = os.path.join(self.ckpt_foldername, "config.yaml")
        with open(cfg_file, "w") as f:
            f.write(omega.to_yaml(self.config))

    # ------------------------------------------------------------------
    # load / resume
    # ------------------------------------------------------------------
    def load_state_dict(self):
        self.wait_pending()
        ckpt_config = self.config["checkpoint"]
        suffix = "current.ckpt"
        reverse_suffix = "best.ckpt"
        ckpt_filepath = os.path.join(self.ckpt_foldername, suffix)

        if ckpt_config.get("resume_best", False):
            ckpt_filepath = os.path.join(self.ckpt_foldername, reverse_suffix)

        loaded = False
        if ckpt_config.get("resume", False) and os.path.exists(ckpt_filepath):
            self._load(ckpt_filepath)
            loaded = True

        if not loaded and ckpt_config.get("resume_file", None):
            resume_file = ckpt_config["resume_file"]
            if not os.path.exists(resume_file):
                raise _zoo_error(resume_file)
            self._load(
                resume_file,
                load_pretrained=ckpt_config.get("resume_pretrained", False),
            )
            loaded = True

        if not loaded and ckpt_config.get("resume_zoo", None):
            raise _zoo_error(ckpt_config["resume_zoo"])

    def _load(self, path: str, load_pretrained: bool = False):
        logger.info(f"Loading checkpoint from {path}")
        self._load_into_trainer(_torch_load(path), load_pretrained)
        logger.info("Checkpoint loaded.")

    def _load_into_trainer(self, ckpt: Dict[str, Any], load_pretrained=False):
        reset_config = self.config["checkpoint"].get("reset", {}) or {}
        reset_all = reset_config.get("all", False)
        reset_optimizer = reset_config.get("optimizer", False) or reset_all
        reset_counts = reset_config.get("counts", False) or reset_all
        state_dict = model_state(ckpt)
        if state_dict is None:
            raise ValueError("the checkpoint holds no model state_dict")

        if load_pretrained:
            mapping = self.config["checkpoint"].get(
                "pretrained_state_mapping", {}
            ) or {}
            if mapping:
                self._load_pretrained_mapped(state_dict, mapping)
                return

        load_model_weights(self.trainer.model, state_dict, self.model_name)
        optimizer = getattr(self.trainer, "optimizer", None)
        if (not reset_optimizer and "optimizer" in ckpt
                and optimizer is not None):
            try:
                optimizer.load_state_dict(ckpt["optimizer"])
            except Exception as e:
                logger.warning(f"Could not restore optimizer state: {e}")
        if not reset_counts and "num_updates" in ckpt:
            self._load_counts(ckpt)

    def _load_counts(self, ckpt: Dict[str, Any]):
        trainer = self.trainer
        trainer.current_iteration = int(ckpt.get("current_iteration", 0))
        trainer.num_updates = int(ckpt.get("num_updates", 0))
        trainer.current_epoch = int(ckpt.get("current_epoch", 0))
        registry.register("current_iteration", trainer.current_iteration)
        registry.register("num_updates", trainer.num_updates)
        registry.register("current_epoch", trainer.current_epoch)
        # the reference restores the schedule with the counts
        scheduler = getattr(trainer, "lr_scheduler", None)
        if scheduler is not None and "lr_scheduler" in ckpt:
            scheduler.load_state_dict(ckpt["lr_scheduler"])
        state = getattr(trainer, "train_state", None)
        if state is not None and "train_state" in ckpt:
            state.step = int(ckpt["train_state"]["step"])
        if getattr(trainer, "early_stop_callback", None) is not None:
            trainer.early_stop_callback.early_stopping.init_from_checkpoint(
                {
                    "best_iteration": int(ckpt.get("best_iteration", 0)),
                    "best_update": int(ckpt.get("best_update", 0)),
                    "best_metric_value": float(
                        ckpt.get("best_metric_value", 0.0)
                    ),
                }
            )

    def _load_pretrained_mapped(self, state_dict, mapping: Dict[str, str]):
        """Copy tensors whose name starts with a mapping value into names
        starting with the mapping key (reference checkpoint.py:412-421).
        The checkpoint's names are taken as they are, and, for a
        reference-named file, also as the key maps convert them."""
        model = self.trainer.model
        own = model.state_dict()
        format_fn = getattr(type(model), "format_state_key", lambda k: k)
        converted, _ = convert_reference_state_dict(
            state_dict, own, reference_key_map(self.model_name), format_fn)
        incoming = dict(state_dict, **converted)
        updates = {}
        for attr, pretrained_attr in mapping.items():
            for own_key in own:
                # match attr only on dotted-path segment boundaries: a bare
                # substring test would let 'pooler' rewrite
                # 't_pooler'/'v_pooler' and load the wrong tensors
                dotted = f".{own_key}."
                needle = f".{attr}."
                if needle not in dotted:
                    continue
                candidate = dotted.replace(needle, f".{pretrained_attr}.", 1)
                candidate = format_fn(candidate[1:-1])
                if candidate in incoming and tuple(
                        incoming[candidate].shape) == tuple(own[own_key].shape):
                    updates[own_key] = incoming[candidate]
        model.load_state_dict(updates, strict=False)
        logger.info(f"Pretrained mapping loaded {len(updates)} tensors")

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def _gather_state(self, update, iteration) -> Dict[str, Any]:
        """Everything a resume needs, copied to the CPU before the next
        step can change a parameter."""
        trainer = self.trainer
        state: Dict[str, Any] = {
            "model": _to_cpu(trainer.model.state_dict()),
            "current_iteration": iteration,
            "num_updates": update,
            "current_epoch": getattr(trainer, "current_epoch", 0),
        }
        es = getattr(trainer, "early_stop_callback", None)
        if es is not None:
            state["best_iteration"] = es.early_stopping.best_monitored_iteration
            state["best_update"] = es.early_stopping.best_monitored_update
            state["best_metric_value"] = float(
                es.early_stopping.best_monitored_value
            )
        optimizer = getattr(trainer, "optimizer", None)
        if optimizer is not None:
            state["optimizer"] = _to_cpu(optimizer.state_dict())
        scheduler = getattr(trainer, "lr_scheduler", None)
        if scheduler is not None:
            state["lr_scheduler"] = _to_cpu(scheduler.state_dict())
        train_state = getattr(trainer, "train_state", None)
        if train_state is not None:
            state["train_state"] = {"step": int(train_state.step)}
        return state

    def save(self, update, iteration=None, update_best=False):
        if not is_main():
            synchronize("ckpt-save")
            return
        if iteration is None:
            iteration = update

        state = self._gather_state(update, iteration)
        state["config"] = omega.to_yaml(self.config)
        state.update(get_git_info())

        ckpt_filepath = os.path.join(
            self.models_foldername, f"model_{update}.ckpt"
        )
        current_ckpt_filepath = os.path.join(
            self.ckpt_foldername, "current.ckpt"
        )

        def write_job():
            _save(state, ckpt_filepath)
            _copy(ckpt_filepath, current_ckpt_filepath)
            if update_best:
                _copy(ckpt_filepath,
                      os.path.join(self.ckpt_foldername, "best.ckpt"))
            # rotation (reference checkpoint.py:595-598)
            if self.max_to_keep > 0:
                if len(self.saved_iterations) == self.max_to_keep:
                    self.remove(self.saved_iterations.pop(0))
                self.saved_iterations.append(update)

        if self._writer is not None:
            # the state is already a host copy: safe to write while the
            # next train steps run
            self.wait_pending()
            self._pending = self._writer.submit(write_job)
        else:
            write_job()
        synchronize("ckpt-save")

    def remove(self, update):
        ckpt_filepath = os.path.join(
            self.models_foldername, f"model_{update}.ckpt"
        )
        if os.path.exists(ckpt_filepath):
            os.remove(ckpt_filepath)

    def restore(self):
        """Restore from best.ckpt (end-of-training / early stop)."""
        self.wait_pending()
        synchronize("ckpt-restore")
        logger.info("Restoring checkpoint")
        best_path = os.path.join(self.ckpt_foldername, "best.ckpt")
        if os.path.exists(best_path):
            self._load(best_path)

    def finalize(self):
        """The model's state_dict alone, as the reference writes it."""
        self.wait_pending()
        if is_main():
            _save(_to_cpu(self.trainer.model.state_dict()), self.pth_filepath)
        synchronize("ckpt-finalize")


def load_pretrained_model(model_name_or_path: str, *args, **kwargs):
    """A checkpoint folder's config snapshot and checkpoint
    (reference checkpoint.py:155-162): the first ``*.yaml``, and the
    first of the sorted ``*.ckpt`` + ``*.pth`` (so ``current.ckpt`` comes
    before ``<model>_final.pth``, as in JAX)."""
    from mmf_tpu_torch.config.configuration import load_yaml

    if not os.path.exists(model_name_or_path):
        raise _zoo_error(model_name_or_path)
    download_path = model_name_or_path
    configs = glob.glob(os.path.join(download_path, "*.yaml"))
    assert len(configs) >= 1, (
        "Checkpoint folder must contain a config yaml"
    )
    ckpts = sorted(
        glob.glob(os.path.join(download_path, "*.ckpt"))
        + glob.glob(os.path.join(download_path, "*.pth"))
    )
    assert len(ckpts) >= 1, "Checkpoint folder must contain a .ckpt/.pth"
    config = load_yaml(configs[0])
    ckpt = _torch_load(ckpts[0])
    return {"config": config, "checkpoint": ckpt, "full_config": config}
