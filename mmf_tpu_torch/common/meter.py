"""Windowed loss/metric smoothing for the training loop.

Port of ``mmf_tpu/common/meter.py``: ``SmoothedValue`` keeps a deque
window of scalar values; ``Meter.update_from_report`` pulls the losses of
a host-side Report (one process, so nothing to reduce) and registers
``<type>/total_loss``.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Dict

import numpy as np

from mmf_tpu_torch.common.registry import registry


class SmoothedValue:
    """Track a series of values and provide access to smoothed values over a
    window or the global series average (reference meter.py:11-53)."""

    def __init__(self, window_size: int = 20):
        self.window_size = window_size
        self.reset()

    def reset(self):
        self.deque = deque(maxlen=self.window_size)
        self.averaged_value_deque = deque(maxlen=self.window_size)
        self.batch_sizes = deque(maxlen=self.window_size)
        self.total_samples = 0
        self.total = 0.0
        self.count = 0

    def update(self, value, batch_size: int = 1):
        value = float(value)
        self.deque.append(value * batch_size)
        self.averaged_value_deque.append(value)
        self.batch_sizes.append(batch_size)
        self.count += 1
        self.total_samples += batch_size
        self.total += value * batch_size

    @property
    def median(self) -> float:
        return float(np.median(np.asarray(self.averaged_value_deque)))

    @property
    def avg(self) -> float:
        return float(np.sum(np.asarray(self.deque)) / np.sum(np.asarray(self.batch_sizes)))

    @property
    def global_avg(self) -> float:
        return self.total / max(self.total_samples, 1)

    def get_latest(self) -> float:
        return self.averaged_value_deque[-1]


class Meter:
    def __init__(self, delimiter: str = ", "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update_from_report(self, report, should_update_loss: bool = True):
        """Losses arriving here are host scalars (or arrays, averaged)."""
        if hasattr(report, "metrics"):
            metrics_dict = report.metrics
            reduced_metrics_dict = {k: np.asarray(v) for k, v in metrics_dict.items()}

        if should_update_loss:
            loss_dict = report.losses
            reduced_loss_dict = {k: np.asarray(v) for k, v in loss_dict.items()}

        with np.errstate(all="ignore"):
            meter_update_dict = {}
            if should_update_loss:
                total_loss_key = None
                total = 0.0
                for key, value in reduced_loss_dict.items():
                    meter_update_dict[key] = float(np.mean(value))
                    total += meter_update_dict[key]
                    total_loss_key = key
                if total_loss_key is not None:
                    # <type>/total_loss, registered globally like the reference
                    prefix = total_loss_key.split("/", 1)[0]
                    total_loss_key = f"{prefix}/total_loss"
                    registry.register(total_loss_key, total)
                    meter_update_dict[total_loss_key] = total

            if hasattr(report, "metrics"):
                for key, value in reduced_metrics_dict.items():
                    meter_update_dict[key] = float(np.mean(value))

        self._update(meter_update_dict, report.batch_size or 1)

    def _update(self, update_dict: Dict[str, Any], batch_size: int):
        for k, v in update_dict.items():
            if isinstance(v, np.ndarray):
                v = float(v)
            assert isinstance(v, (float, int)), f"Meter value for {k} must be scalar"
            self.meters[k].update(v, batch_size)

    def update_from_meter(self, meter: "Meter"):
        for key, value in meter.meters.items():
            assert isinstance(value, SmoothedValue)
            self.meters[key] = value

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        if "meters" in self.__dict__ and attr in self.meters:
            return self.meters[attr]
        if attr in self.__dict__:
            return self.__dict__[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'"
        )

    def get_scalar_dict(self) -> Dict[str, float]:
        return {k: v.get_latest() for k, v in self.meters.items()}

    def get_log_dict(self) -> Dict[str, float]:
        log_dict = {}
        for k, v in self.meters.items():
            if "train" in k:
                log_dict[k] = f"{v.median:.4f}"
                log_dict[f"{k}/avg"] = f"{v.global_avg:.4f}"
            else:
                log_dict[k] = f"{v.global_avg:.4f}"
        return log_dict

    def __str__(self) -> str:
        loss_str = []
        for name, meter in self.meters.items():
            if "train" in name:
                loss_str.append(f"{name}: {meter.median:.4f} ({meter.global_avg:.4f})")
            else:
                loss_str.append(f"{name}: {meter.global_avg:.4f}")
        return self.delimiter.join(loss_str)

    def reset(self):
        self.meters = defaultdict(SmoothedValue)
