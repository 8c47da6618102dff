"""Prediction report generation.

Port of ``mmf_tpu/common/test_reporter.py``: accumulates each dataset's
predictions during the prediction loop and dumps them as json or csv
under ``env.report_dir`` (``<save_dir>/reports`` when unset). One process
writes (the port runs at world size 1, so there is nothing to gather).
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Any, Dict, List

import numpy as np

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.config.configuration import get_mmf_env
from mmf_tpu_torch.utils.distributed import is_main
from mmf_tpu_torch.utils.logger import Timer

logger = logging.getLogger(__name__)


@registry.register_test_reporter("file")
@registry.register_test_reporter("default")
class TestReporter:
    def __init__(self, datamodules: Dict[str, Any], config=None,
                 dataset_type: str = "train"):
        self.test_reporter_config = config or {}
        self.datamodules = datamodules
        self.dataset_type = dataset_type
        self.config = registry.get("config")
        self.report: List[Dict[str, Any]] = []
        self.timer = Timer()
        self.training_config = self.config["training"]
        self.num_workers = self.training_config.get("num_workers", 0)
        self.batch_size = self.training_config.get("batch_size", 32)
        self.report_folder_arg = get_mmf_env(key="report_dir")
        self.experiment_name = self.training_config.get("experiment_name", "")
        self.current_datamodule_idx = -1
        self.dataset_names = list(self.datamodules.keys())
        self.current_dataloader = None

        self.save_dir = get_mmf_env(key="save_dir")
        self.report_folder = self.report_folder_arg or os.path.join(
            self.save_dir, "reports"
        )
        if is_main():
            os.makedirs(self.report_folder, exist_ok=True)

    @property
    def current_datamodule(self):
        return self.datamodules[
            self.dataset_names[self.current_datamodule_idx]
        ]

    @property
    def current_dataset_name(self):
        return self.dataset_names[self.current_datamodule_idx]

    @property
    def current_dataset(self):
        return getattr(
            self.current_datamodule, f"{self.dataset_type}_dataset", None
        )

    def next_dataset(self, flush_report: bool = True) -> bool:
        if self.current_datamodule_idx >= 0 and flush_report:
            self.flush_report()
        self.current_datamodule_idx += 1
        if self.current_datamodule_idx == len(self.datamodules):
            return False
        logger.info(
            f"Predicting for {self.dataset_names[self.current_datamodule_idx]}"
        )
        return True

    def get_dataloader(self):
        self.current_dataloader = getattr(
            self.current_datamodule, f"{self.dataset_type}_dataloader"
        )()
        return self.current_dataloader

    def prepare_batch(self, batch):
        ds = self.current_dataset
        if ds is not None and hasattr(ds, "prepare_batch"):
            batch = ds.prepare_batch(batch)
        return batch

    def __len__(self):
        return len(self.current_dataloader or [])

    def add_to_report(self, report, model, execute_on_master_only=True):
        """Format the report's rows through the dataset's and the model's
        hooks and keep them (reference test_reporter.py:198-230)."""
        ds = self.current_dataset
        if ds is not None and hasattr(ds, "format_for_prediction"):
            results = ds.format_for_prediction(report)
        else:
            results = self._default_format(report)
        if hasattr(model, "format_for_prediction"):
            results = model.format_for_prediction(results, report)

        if not execute_on_master_only or is_main():
            self.report.extend(results)

    def _default_format(self, report) -> List[Dict[str, Any]]:
        results = []
        scores = np.asarray(report.get("scores"))
        ids = report.get("question_id", report.get("id", None))
        answers = scores.argmax(axis=-1) if scores is not None else None
        n = scores.shape[0] if scores is not None else 0
        for i in range(n):
            entry = {}
            if ids is not None:
                entry["question_id"] = int(np.asarray(ids[i]))
            if answers is not None:
                entry["answer"] = int(answers[i])
            results.append(entry)
        return results

    def flush_report(self):
        """(reference test_reporter.py:117-164)"""
        ds = self.current_dataset
        if ds is not None and hasattr(ds, "on_prediction_end"):
            # e.g. detection de-dupes per-image entries
            # (reference coco detection_dataset.py:112-120)
            self.report = ds.on_prediction_end(self.report)
        if not is_main():
            self.report = []
            return
        name = self.current_dataset_name
        time_format = "%Y-%m-%dT%H:%M:%S"
        time_ = self.timer.get_time_hhmmss(None, format=time_format)
        filename = name + "_"
        if self.experiment_name:
            filename += self.experiment_name + "_"
        filename += self.dataset_type + "_"
        filename += time_

        use_csv = (
            self.config.get("evaluation", {}).get("predict_file_format", "json")
            == "csv"
        )
        if use_csv:
            filepath = os.path.join(self.report_folder, filename + ".csv")
            self.csv_dump(filepath)
        else:
            filepath = os.path.join(self.report_folder, filename + ".json")
            self.json_dump(filepath)
        logger.info(
            f"Wrote prediction for {name} to {os.path.abspath(filepath)}"
        )
        self.report = []

    def csv_dump(self, filepath):
        with open(filepath, "w") as f:
            title = self.report[0].keys() if self.report else []
            cw = csv.DictWriter(f, title, delimiter=",", quoting=csv.QUOTE_MINIMAL)
            cw.writeheader()
            cw.writerows(self.report)

    def json_dump(self, filepath):
        def default(o):
            if isinstance(o, (np.integer,)):
                return int(o)
            if isinstance(o, (np.floating,)):
                return float(o)
            if isinstance(o, np.ndarray):
                return o.tolist()
            raise TypeError(type(o))

        with open(filepath, "w") as f:
            json.dump(self.report, f, default=default)
