"""Logistics callback: updates a second, ETA and progress lines.

Port of ``mmf_tpu/trainers/callbacks/logistics.py``; the TensorBoard
and W&B sinks are not ported yet. On the card the progress line carries
the peak memory allocated (MB).
"""

from __future__ import annotations

import logging

import torch

from mmf_tpu_torch.trainers.callbacks.base import Callback
from mmf_tpu_torch.utils.logger import (
    Timer,
    calculate_time_left,
    summarize_report,
)

logger = logging.getLogger("mmf_tpu_torch")


class LogisticsCallback(Callback):
    def __init__(self, config, trainer):
        super().__init__(config, trainer)
        self.total_timer = Timer()
        self.log_interval = self.training_config["log_interval"]
        self.evaluation_interval = self.training_config["evaluation_interval"]
        self.checkpoint_interval = self.training_config["checkpoint_interval"]

        self.snapshot_timer = Timer()
        self.train_timer = Timer()

    def on_train_start(self, **kwargs):
        self.train_timer.reset()
        self.snapshot_timer.reset()

    def on_update_end(self, **kwargs):
        if self.trainer.num_updates % self.log_interval != 0:
            return
        extra = {}
        meter = kwargs.get("meter", self.trainer.meter)
        should_print = kwargs.get("should_log", True)
        if should_print:
            ups = self.log_interval / max(
                self.train_timer.unix_time_since_start(), 1e-6
            )
            if self.trainer.device.type == "cuda":
                extra["max mem"] = self._device_mem_mb()
            extra.update(
                {
                    "lr": self._current_lr(),
                    "ups": f"{ups:.2f}",
                    "time": self.train_timer.get_time_since_start(),
                    "time_since_start": self.total_timer.get_time_since_start(),
                    "eta": calculate_time_left(
                        self.trainer.max_updates,
                        self.trainer.num_updates,
                        self.train_timer,
                        self.trainer.num_snapshot_iterations,
                        self.log_interval,
                        self.evaluation_interval,
                    ),
                }
            )
            self.train_timer.reset()
        summarize_report(
            self.trainer.current_iteration,
            self.trainer.num_updates,
            self.trainer.max_updates,
            meter,
            should_print=should_print,
            extra=extra,
        )

    def on_validation_start(self, **kwargs):
        self.snapshot_timer.reset()

    def on_validation_end(self, **kwargs):
        extra = {
            "num_updates": self.trainer.num_updates,
            "epoch": self.trainer.current_epoch,
            "iterations": self.trainer.current_iteration,
            "max_updates": self.trainer.max_updates,
            "val_time": self.snapshot_timer.get_time_since_start(),
        }
        if self.trainer.early_stop_callback is not None:
            extra.update(
                self.trainer.early_stop_callback.early_stopping.get_info()
            )
        self.train_timer.reset()
        summarize_report(
            self.trainer.current_iteration,
            self.trainer.num_updates,
            self.trainer.max_updates,
            kwargs["meter"],
            extra=extra,
        )

    def on_test_end(self, **kwargs):
        prefix = f"{kwargs['report'].dataset_name}: full {kwargs['report'].dataset_type}"
        summarize_report(
            self.trainer.current_iteration,
            self.trainer.num_updates,
            self.trainer.max_updates,
            kwargs["meter"],
            extra={"prefix": prefix},
        )
        logger.info(f"Finished run in {self.total_timer.get_time_since_start()}")

    def _current_lr(self) -> str:
        lr = getattr(self.trainer, "current_lr", None)
        if lr is None:
            opt_cfg = self.config.get("optimizer", {}) or {}
            lr = (opt_cfg.get("params", {}) or {}).get("lr", 0.0)
        if callable(lr):
            lr = lr(self.trainer.num_updates)
        try:
            return f"{float(lr):.5f}"
        except (TypeError, ValueError):
            return str(lr)

    @staticmethod
    def _device_mem_mb() -> str:
        return f"{torch.cuda.max_memory_allocated() / (1024 ** 2):.0f}"
