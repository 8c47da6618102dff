"""Trainer profiling: timing points, profiler ranges and an optional
trace of the training loop.

Port of ``mmf_tpu/trainers/core/profiling.py``. ``profile(text)`` takes
the host time since the previous point under the names JAX uses
("Batch load time", "Batch prepare time", "Step dispatch time",
"Finished update"): each goes into ``profile_meter`` (a window of the
latest values and the run's mean, in seconds) and, at the debug level,
into the log. ``trace(name)`` wraps a host phase in
``torch.profiler.record_function``, so that it shows on a profiler's
timeline. ``training.profile_dir`` captures a ``torch.profiler`` trace of
the training loop there (a Chrome trace, ``trace.json``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch

from mmf_tpu_torch.common.meter import Meter

logger = logging.getLogger(__name__)


class TrainerProfilingMixin:
    _profile_last: Optional[float] = None
    _profiler = None

    def profile(self, text: str) -> None:
        """Record the host time since the previous profile point."""
        now = time.perf_counter()
        if getattr(self, "profile_meter", None) is None:
            self.profile_meter = Meter()
        if self._profile_last is not None:
            seconds = now - self._profile_last
            self.profile_meter.meters[text].update(seconds)
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug(f"{text}: {seconds * 1e3:.3f} ms")
        self._profile_last = now

    @contextlib.contextmanager
    def trace(self, name: str):
        with torch.profiler.record_function(name):
            yield

    def start_profiler(self, profile_dir: Optional[str] = None) -> None:
        if self._profiler is not None:
            return
        profile_dir = profile_dir or self.training_config.get(
            "profile_dir", None)
        if not profile_dir:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        self._profile_dir = profile_dir
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        logger.info(f"torch.profiler trace capturing to {profile_dir}")

    def stop_profiler(self) -> None:
        if self._profiler is None:
            return
        self._profiler.__exit__(None, None, None)
        path = os.path.join(self._profile_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        logger.info(f"torch.profiler trace written to {path}")
