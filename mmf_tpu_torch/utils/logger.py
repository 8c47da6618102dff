"""Logging: a console handler on rank 0 and a file handler on every
rank, progress summaries, and the ``Timer``.

Port of the parts of ``mmf_tpu/utils/logger.py`` that ``mmf_run`` calls
(``setup_logger``, ``calculate_time_left``, ``summarize_report``,
``log_progress``, ``Timer``), with the same log-line formats. The
logger is ``mmf_tpu_torch``. The TensorBoard and W&B loggers are not
ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional, Union

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.utils.distributed import get_rank, is_main


def setup_logger(
    output: Optional[str] = None,
    color: bool = True,
    name: str = "mmf_tpu_torch",
    disable: bool = False,
    clear_handlers: bool = True,
    *args,
    **kwargs,
):
    """Initialize the port's logger: stdout on rank 0, a file handler on
    every rank (reference logger.py:58-168). With ``clear_handlers`` the
    handlers an earlier call installed are closed and removed first, so
    that runs in one process do not log twice."""
    if disable:
        return None
    logger = logging.getLogger(name)
    logger.propagate = False
    warnings_logger = logging.getLogger("py.warnings")
    if clear_handlers:
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            if handler in warnings_logger.handlers:
                warnings_logger.removeHandler(handler)
            handler.close()

    logging.captureWarnings(True)

    plain_formatter = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(name)s : %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
    )

    distributed_rank = get_rank()
    handlers = []

    config = registry.get("config", no_warning=True)
    if config:
        logging_level = config.get("training", {}).get("logger_level", "info")
    else:
        logging_level = "info"
    logging_level = getattr(logging, logging_level.upper(), logging.INFO)

    if distributed_rank == 0:
        logger.setLevel(logging_level)
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging_level)
        formatter = plain_formatter
        ch.setFormatter(formatter)
        logger.addHandler(ch)
        warnings_logger.addHandler(ch)
        handlers.append(ch)

    # file logging on all ranks
    if output is None:
        try:
            from mmf_tpu_torch.config.configuration import get_mmf_env

            output = get_mmf_env(key="log_dir")
        except Exception:
            output = None
    if output:
        if output.endswith(".txt") or output.endswith(".log"):
            filename = output
        else:
            filename = os.path.join(
                output, f"train_{time.strftime('%Y_%m_%dT%H_%M_%S')}.log"
            )
        if distributed_rank > 0:
            filename = f"{filename}.rank{distributed_rank}"
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging_level)
        fh.setFormatter(plain_formatter)
        logger.addHandler(fh)
        warnings_logger.addHandler(fh)
        handlers.append(fh)
        registry.register("log_file", filename)

    registry.register("writer", logger)
    return logger


def calculate_time_left(
    max_updates: int,
    num_updates: int,
    timer,
    num_snapshot_iterations: int,
    log_interval: int,
    eval_interval: Optional[int],
):
    """ETA string (reference logger.py:255-276)."""
    if num_updates is None or max_updates is None:
        return "Unknown"
    time_taken_for_log = time.time() * 1000 - timer.start
    iterations_left = max_updates - num_updates
    num_logs_left = iterations_left / log_interval
    time_left = num_logs_left * time_taken_for_log

    if eval_interval:
        snapshot_iteration = num_snapshot_iterations / log_interval
        snapshot_iteration *= iterations_left / eval_interval
        time_left += snapshot_iteration * time_taken_for_log

    return timer.get_time_hhmmss(gap=time_left)


def summarize_report(
    current_iteration,
    num_updates,
    max_updates,
    meter,
    should_print: bool = True,
    extra: Optional[Dict[str, Any]] = None,
):
    """The progress line of an update or an evaluation (reference
    logger.py:214-252; the TensorBoard and W&B sinks are not ported
    yet)."""
    if extra is None:
        extra = {}
    if not is_main():
        return
    if not should_print:
        return
    log_dict = {}
    if num_updates is not None and max_updates is not None:
        log_dict.update({"progress": f"{num_updates}/{max_updates}"})
    log_dict.update(meter.get_log_dict())
    log_dict.update(extra)
    log_progress(log_dict)


def log_progress(info: Union[Dict, Any], log_format: Optional[str] = None):
    """Log progress as json or simple key/value line
    (reference logger.py:279-307)."""
    logger = logging.getLogger("mmf_tpu_torch")
    if not isinstance(info, dict):
        logger.info(info)
        return

    if log_format is None:
        config = registry.get("config", no_warning=True)
        log_format = (
            config.get("training", {}).get("log_format", "simple")
            if config
            else "simple"
        )

    if log_format == "simple":
        output = ", ".join([f"{key}: {value}" for key, value in info.items()])
    elif log_format == "json":
        output = json.dumps(info)
    else:
        output = str(info)
    logger.info(output)


class Timer:
    """(reference utils/timer.py)"""

    DEFAULT_TIME_FORMAT_DATE_TIME = "%Y/%m/%d %H:%M:%S"
    DEFAULT_TIME_FORMAT = ["%03d ms", "%02d s", "%02d m", "%02d h"]
    DEFAULT = "%Y_%m_%dT%H_%M_%S"

    def __init__(self):
        self.start = time.time() * 1000

    def get_current(self):
        return self.get_time_hhmmss(self.start)

    def reset(self):
        self.start = time.time() * 1000

    def get_time_since_start(self, format=None):
        return self.get_time_hhmmss(self.start, format)

    def unix_time_since_start(self, in_seconds=True):
        gap = time.time() * 1000 - self.start
        if in_seconds:
            gap = gap // 1000
        return max(gap, 1)

    def get_time_hhmmss(self, start=None, end=None, gap=None, format=None):
        if start is None and gap is None:
            if format is None:
                format = self.DEFAULT_TIME_FORMAT_DATE_TIME
            return time.strftime(format)

        if end is None:
            end = time.time() * 1000
        if gap is None:
            gap = end - start

        s, ms = divmod(gap, 1000)
        m, s = divmod(s, 60)
        h, m = divmod(m, 60)

        if format is None:
            format = self.DEFAULT_TIME_FORMAT
        items = [ms, s, m, h]
        assert len(items) == len(format), "Format length should be same as items"
        time_str = ""
        for idx, item in enumerate(items):
            if item != 0:
                time_str = format[idx] % item + " " + time_str
        if len(time_str) == 0:
            time_str = "0 ms"
        return time_str.strip()
