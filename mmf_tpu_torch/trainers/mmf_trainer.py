"""MMFTrainer: the default trainer.

Port of ``mmf_tpu/trainers/mmf_trainer.py`` (reference
mmf/trainers/mmf_trainer.py and the mixins in mmf/trainers/core/). The
host loop is thin: the update (forward, loss, backward, clipping,
optimizer, lr schedule, microbatch accumulation) is the train step of
``trainers/core/train_state.py``, which adds no arithmetic of its own
here; the loop feeds it batches, reads the losses back to the host only
at ``log_interval``, evaluates at ``evaluation_interval`` and runs the
callbacks (checkpoints, early stopping, logs, the user's).

The batch's dataset name and split ride in the batch dict the step
receives, so one step serves every dataset. The model is built eagerly
with weights drawn from ``training.seed``; it trains on the card unless
``training.device`` is ``cpu`` (``tpu``, JAX's default, means the
card), and a machine with no card raises unless ``cpu`` was asked for.
Left out of JAX's trainer, each for its reason: the mesh and its batch
divisibility check (one device), flax's lazy init (torch builds the
model eagerly), the jit cache per dataset (the meta rides in the batch),
M4C's decode budget (``decode_budget_samples``, which picks JAX's scan
unroll for the TPU's compile; the port's decode is a Python loop and
compiles nothing), the MoE, pipeline and
sequence-parallel hooks (parallelism comes later), the streaming
``torchmetrics`` and ``evaluation.limit_val_batches``.
"""

from __future__ import annotations

import gc
import logging
import random
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmf_tpu_torch.common.meter import Meter
from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.common.report import Report
from mmf_tpu_torch.common.sample import SampleList
from mmf_tpu_torch.modules.metrics import Metrics
from mmf_tpu_torch.trainers.base_trainer import BaseTrainer
from mmf_tpu_torch.trainers.callbacks.checkpoint import CheckpointCallback
from mmf_tpu_torch.trainers.callbacks.early_stopping import (
    EarlyStoppingCallback,
)
from mmf_tpu_torch.trainers.callbacks.logistics import LogisticsCallback
from mmf_tpu_torch.trainers.callbacks.lr_scheduler import LRSchedulerCallback
from mmf_tpu_torch.trainers.core.profiling import TrainerProfilingMixin
from mmf_tpu_torch.trainers.core.train_state import (
    TrainState,
    create_train_state,
    fold_in,
    make_eval_step,
    make_train_step,
)
from mmf_tpu_torch.utils.general import get_max_updates

logger = logging.getLogger("mmf_tpu_torch")

# the evaluation's sampling stream, apart from the training's dropout
SAMPLING_STREAM = 0x53414D50


@registry.register_trainer("mmf")
class MMFTrainer(TrainerProfilingMixin, BaseTrainer):
    def __init__(self, config):
        super().__init__(config)
        self.num_updates = 0
        self.current_iteration = 0
        self.current_epoch = 0
        self.meter = Meter()
        self.early_stop_callback = None
        self.checkpoint_callback = None
        self.current_lr = None
        self.train_state: Optional[TrainState] = None
        self._train_step = None
        self._eval_step = None

    def load(self):
        super().load()
        self.on_init_start()
        self.on_init_end()

    def configure_device(self):
        """The card unless ``training.device`` is ``cpu``."""
        asked = self.training_config.get("device", None)
        if asked == "cpu":
            self.device = torch.device("cpu")
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"training.device={asked!r} trains on the card, and this "
                    "machine has no CUDA device; pass training.device=cpu "
                    "to train through the plain versions on the CPU"
                )
            self.device = torch.device("cuda")
        self.device_type = self.device.type
        registry.register("current_device", self.device)

    def load_datasets(self):
        logger.info("Loading datasets")
        from mmf_tpu_torch.datasets.multi_datamodule import MultiDataModule

        self.dataset_loader = MultiDataModule(self.config)
        self.train_loader = self.dataset_loader.train_dataloader()
        self.val_loader = self.dataset_loader.val_dataloader()
        self.test_loader = self.dataset_loader.test_dataloader()

    def load_model(self):
        logger.info("Loading model")
        from mmf_tpu_torch.config import omega
        from mmf_tpu_torch.models.base_model import build_model

        # training.fp16 is the reference's autocast flag: bf16 compute
        # with f32 parameters, unless the model names its dtype
        model_key = self.config.get("model", None)
        model_cfg = (self.config.get("model_config", {}) or {}).get(
            model_key, None)
        if (self.training_config.get("fp16", False) and model_cfg is not None
                and not model_cfg.get("dtype", None)):
            with omega.open_dict(self.config):
                model_cfg["dtype"] = "bfloat16"
            logger.info("training.fp16=true: using bf16 compute / f32 params")

        self.model = build_model(self.config)
        if self.model.has_uninitialized_params():
            # a layer sized by its input (flax infers it at init)
            self.model.materialize(self._example_batch())
        if hasattr(self.model, "init_weights"):
            self.model.init_weights(
                torch.Generator().manual_seed(int(self.seed or 0)))
        self.model = self.model.to(self.device)
        self.losses = self.model.build_losses()
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info(f"Model initialized: {n_params:,} parameters")

    def _example_batch(self) -> Dict[str, Any]:
        """The first sample of the first split that has data, as a batch
        of one (the batch a lazily sized layer takes its width from)."""
        for loader in (self.train_loader, self.val_loader, self.test_loader):
            if loader is not None and loader.num_datasets > 0:
                dataset = loader.first_loader.dataset
                if len(dataset) > 0:
                    # a masked dataset draws its masks from Python's and
                    # numpy's generators: the run's own draws stay as
                    # they would be without this sample
                    states = random.getstate(), np.random.get_state()
                    try:
                        return SampleList([dataset[0]]).pytree()
                    finally:
                        random.setstate(states[0])
                        np.random.set_state(states[1])
        raise RuntimeError("no split has a sample to size the model by")

    def load_optimizer(self):
        logger.info("Loading optimizer")
        from mmf_tpu_torch.modules.optimizers import build_optimizer
        from mmf_tpu_torch.modules.schedulers import (
            build_lr_scheduler,
            build_scheduler,
        )

        lr_multipliers = wd_mask = None
        if hasattr(self.model, "get_lr_multipliers"):
            lr_multipliers = self.model.get_lr_multipliers(self.config)
        if hasattr(self.model, "get_weight_decay_mask"):
            wd_mask = self.model.get_weight_decay_mask(self.config)
        optimizer = build_optimizer(self.config, self.model,
                                    lr_multipliers=lr_multipliers,
                                    weight_decay_mask=wd_mask)
        self._schedule_fn = build_scheduler(self.config)
        lr_scheduler = build_lr_scheduler(optimizer, self._schedule_fn)
        self.train_state = create_train_state(self.model, optimizer,
                                              int(self.seed or 0),
                                              lr_scheduler)

    @property
    def optimizer(self):
        return self.train_state.optimizer

    @property
    def lr_scheduler(self):
        return self.train_state.lr_scheduler

    def load_metrics(self):
        evaluation = self.config.get("evaluation", {}) or {}
        self.metrics = Metrics(evaluation.get("metrics", []) or [])
        self.metrics_params = self.metrics.required_params

    def configure_callbacks(self):
        self.lr_scheduler_callback = LRSchedulerCallback(self.config, self)
        self.checkpoint_callback = CheckpointCallback(self.config, self)
        self.logistics_callback = LogisticsCallback(self.config, self)
        self.early_stop_callback = EarlyStoppingCallback(self.config, self)
        self.callbacks = [
            self.lr_scheduler_callback,
            self.checkpoint_callback,
            self.logistics_callback,
            self.early_stop_callback,
        ]
        # user callbacks from the config (reference mmf_trainer.py:66-75)
        for cb_cfg in self.training_config.get("callbacks", []) or []:
            cb_cls = registry.get_callback_class(cb_cfg["type"])
            if cb_cls is None:
                raise ValueError(
                    f"The callback {cb_cfg['type']} was not found in registry")
            self.callbacks.append(
                cb_cls(self.config, self, **(cb_cfg.get("params", {}) or {})))

    def _fire(self, hook: str, **kwargs):
        for cb in getattr(self, "callbacks", []):
            getattr(cb, hook)(**kwargs)

    def on_init_start(self, **kw):
        self._fire("on_init_start", **kw)

    def on_init_end(self, **kw):
        self._fire("on_init_end", **kw)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    @staticmethod
    def _batch_meta(batch: SampleList) -> Dict[str, Any]:
        meta = {}
        if isinstance(batch, SampleList):
            m = batch.meta()
            for key in ("dataset_name", "dataset_type"):
                if key in m:
                    v = m[key]
                    meta[key] = v[0] if isinstance(v, list) else v
        return meta

    def _device_batch(self, batch: SampleList,
                      meta: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's tensors on the device, with its meta beside them."""
        device_batch = batch.to(self.device, non_blocking=True).pytree()
        device_batch.update(meta)
        return device_batch

    def _get_train_step(self):
        if self._train_step is None:
            report_fields = ()
            if (self.training_config.get("evaluate_metrics", False)
                    and len(self.metrics.metrics) > 0):
                # scores ride out of the step for train-time metrics
                # (reference training_loop.py:118-123)
                report_fields = ("scores",)
            from mmf_tpu_torch.utils.general import clip_gradients_config

            self._train_step = make_train_step(
                self.losses,
                update_frequency=self.training_config.get(
                    "update_frequency", 1),
                max_grad_norm=clip_gradients_config(self.config),
                report_fields=report_fields,
            )
        return self._train_step

    def _get_eval_step(self):
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.losses)
        return self._eval_step

    # ------------------------------------------------------------------
    # training loop (reference core/training_loop.py:21-246)
    # ------------------------------------------------------------------
    def train(self):
        logger.info("===== Model =====")
        logger.info(type(self.model).__name__)
        if "train" in self.run_type:
            self._fire("on_train_start")
            self.training_loop()
            self._fire("on_train_end")
        self.inference()

    @property
    def max_updates(self):
        return getattr(self, "_max_updates", None)

    @property
    def num_snapshot_iterations(self):
        return 0 if self.val_loader is None else len(self.val_loader)

    def training_loop(self):
        self._max_updates, self.max_epochs = get_max_updates(
            self.training_config.get("max_updates", None),
            self.training_config.get("max_epochs", None),
            self.train_loader,
            self.training_config.get("update_frequency", 1),
        )
        logger.info("Starting training...")
        log_interval = self.training_config["log_interval"]
        eval_interval = self.training_config["evaluation_interval"]
        exit_on_nan = self.training_config.get("exit_on_nan_losses", True)
        uf = self.training_config.get("update_frequency", 1)
        step_fn = self._get_train_step()
        should_break = False
        self.start_profiler()

        while self.num_updates < self._max_updates and not should_break:
            self.current_epoch += 1
            registry.register("current_epoch", self.current_epoch)
            if self.current_epoch > self.max_epochs + 1:
                break
            self.train_loader.seed_sampler(self.current_epoch)

            for batch in self.train_loader:
                self.profile("Batch load time")
                if self.num_updates >= self._max_updates:
                    break
                self._fire("on_update_start")

                meta = self._batch_meta(batch)
                # a model's per-update host choice (UNITER's pretraining
                # task, drawn from Python's random after the batch's own
                # draws, as in JAX) rides in the batch with the meta
                if hasattr(self.model, "get_step_meta"):
                    meta.update(self.model.get_step_meta() or {})
                with self.trace("batch_prepare"):
                    device_batch = self._device_batch(batch, meta)
                self.profile("Batch prepare time")
                # the update is queued on the device; its time shows in a
                # profiler's trace, not in this host timer
                with self.trace("train_step"):
                    self.train_state, report = step_fn(self.train_state,
                                                       device_batch)
                self.profile("Step dispatch time")

                self.num_updates += 1
                self.current_iteration += uf
                registry.register("num_updates", self.num_updates)
                registry.register("current_iteration", self.current_iteration)

                should_log = self.num_updates % log_interval == 0
                if should_log:
                    self._consume_train_report(report, meta, batch,
                                               exit_on_nan=exit_on_nan)
                self._fire("on_update_end", meter=self.meter,
                           should_log=should_log)
                self.profile("Finished update")

                if (self.num_updates % eval_interval == 0
                        and self.val_loader is not None
                        and len(self.val_loader) > 0):
                    if self._run_validation():
                        logger.info("Early stopping activated")
                        should_break = True
                        break
            gc.collect()

        self.stop_profiler()
        logger.info(
            f"Finished training: {self.num_updates}/{self._max_updates} "
            f"updates, {self.current_epoch} epochs"
        )

    def _consume_train_report(self, report, meta, batch, exit_on_nan=True):
        """The one device-to-host read of an update: the losses and the
        NaN flag, into the meter; with ``training.evaluate_metrics`` the
        train-time metrics over the scores (reference
        training_loop.py:118-123, 173-191)."""
        keys = list(report["losses"].keys())
        values = torch.stack(
            [report["losses"][k].float() for k in keys]
            + [report["nan_flag"].float()]).cpu().tolist()
        losses = dict(zip(keys, values[:-1]))
        if values[-1] and exit_on_nan:
            raise RuntimeError(
                f"NaN occurred in the following loss(es): {', '.join(keys)}; "
                "exiting the training"
            )
        if "scores" in report:
            host_report = Report(batch, {"losses": losses,
                                         "scores": report["scores"]})
            host_report = host_report.to_numpy()
            host_report["dataset_name"] = meta.get("dataset_name", "unknown")
            host_report["dataset_type"] = "train"
            host_report.metrics = self.metrics(host_report, host_report)
        else:
            host_report = Report.__new__(Report)
            dict.__init__(host_report)
            host_report["losses"] = losses
            host_report.batch_size = batch.get_batch_size()
        self.meter.update_from_report(host_report)

    def _run_validation(self) -> bool:
        self._fire("on_validation_start")
        _, meter = self.evaluation_loop("val")
        # every callback hears the hook; early stopping's answer decides
        stop = False
        for cb in getattr(self, "callbacks", []):
            result = cb.on_validation_end(meter=meter)
            if cb is self.early_stop_callback:
                stop = bool(result)
        return stop

    # ------------------------------------------------------------------
    # evaluation (reference core/evaluation_loop.py:18-177)
    # ------------------------------------------------------------------
    def _eval_report(self, batch: SampleList, dataset_type: str) -> Report:
        """One eval forward as a host report, the padded rows trimmed."""
        meta = self._batch_meta(batch)
        meta["dataset_type"] = dataset_type
        output = self._get_eval_step()(self.model,
                                       self._device_batch(batch, meta),
                                       self._sampling_generator())
        report = Report(batch, output).to_numpy()
        true_bs = getattr(batch, "_true_batch_size", None)
        if true_bs is not None:
            report.trim_to_batch_size(true_bs)
        return report

    def _sampling_generator(self) -> torch.Generator:
        """A fresh sampling stream for each evaluation batch, from the
        run's seed and the count of batches evaluated (JAX folds the
        count into its evaluation key)."""
        self._eval_batch_counter = getattr(self, "_eval_batch_counter",
                                           0) + 1
        seed = fold_in(fold_in(int(self.seed or 0), SAMPLING_STREAM),
                       self._eval_batch_counter)
        return torch.Generator(device=self.device).manual_seed(seed)

    def evaluation_loop(self, dataset_type: str, use_tqdm: bool = False,
                        single_batch: bool = False):
        """Reports are gathered on the host (the reference's
        ``evaluation.use_cpu``, always on): one device-to-host copy a
        batch, and no logits held on the card."""
        loader = getattr(self, f"{dataset_type}_loader")
        meter = Meter()
        combined_report = None
        meta = {}
        for batch in loader:
            meta = self._batch_meta(batch)
            report = self._eval_report(batch, dataset_type)
            meter.update_from_report(report)
            if combined_report is None:
                combined_report = report
            else:
                combined_report.accumulate_tensor_fields_and_loss(
                    report, self.metrics_params)
                combined_report.batch_size += report.batch_size
            if single_batch:
                break

        if combined_report is not None and len(self.metrics.metrics) > 0:
            combined_report["dataset_name"] = meta.get("dataset_name",
                                                       "unknown")
            combined_report["dataset_type"] = dataset_type
            combined_report.metrics = self.metrics(combined_report,
                                                   combined_report)
            meter.update_from_report(combined_report, should_update_loss=False)
        return combined_report, meter

    def prediction_loop(self, dataset_type: str):
        """A prediction report (reference evaluation_loop.py:112-142)."""
        logger.info(f"Starting {dataset_type} inference predictions")
        self._fire("on_prediction_start")
        reporter = self.dataset_loader.get_test_reporter(dataset_type)
        loader = getattr(self, f"{dataset_type}_loader")
        while reporter.next_dataset():
            for batch in loader:
                reporter.add_to_report(self._eval_report(batch, dataset_type),
                                       self.model)
        # the last next_dataset() call flushed the last dataset's report
        self._fire("on_prediction_end")

    def teardown(self):
        """Stop the loaders' worker processes; they start again if the
        loaders are iterated later."""
        self.dataset_loader.teardown()

    def inference(self):
        dataset_type = []
        if "val" in self.run_type:
            dataset_type.append("val")
        if any(rt in self.run_type for rt in ["inference", "test", "predict"]):
            dataset_type.append("test")

        for dtype in dataset_type:
            loader = getattr(self, f"{dtype}_loader", None)
            if loader is None or len(loader) == 0:
                continue
            if self.config.get("evaluation", {}).get("predict", False):
                self.prediction_loop(dtype)
            else:
                logger.info(f"Starting inference on {dtype} set")
                report, meter = self.evaluation_loop(dtype)
                if report is not None:
                    self._fire("on_test_end", report=report, meter=meter)


def build_trainer(config) -> BaseTrainer:
    """(reference utils/build.py:56-71)"""
    trainer_cls = registry.get_trainer_class(config["training"]["trainer"])
    return trainer_cls(config)
