"""A model rebuilt from a checkpoint folder.

Port of ``mmf_tpu/utils/inference.py::Inference._build_model``: the
config snapshot and the checkpoint come from ``load_pretrained_model``,
a plugin folder named by the snapshot's ``env.user_dir`` is imported
first, the model is built through the registry and given the
checkpoint's weights (the port's names, or a reference MMF state_dict's
through the key maps; an entry the checkpoint leaves unfilled raises), and
the dataset's processors config is exposed.

``dataset_name`` is the checkpoint's dataset (its config's
``datasets``), which a served batch carries. Not ported yet: ``forward``
(a local image through the FRCNN detector for region features, ROADMAP
A.6, or as raw pixels, which JAX feeds without the image processor and
under the dataset name ``inference``, for which ViLT has no head) and
``_region_features``; both raise. A served checkpoint's ``text``
requests go through its ``text_processor`` in ``serving/server.py``.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


class Inference:
    def __init__(self, checkpoint_path: str = None,
                 frcnn_checkpoint: str = None):
        self.checkpoint = checkpoint_path
        assert self.checkpoint is not None
        self.frcnn_checkpoint = frcnn_checkpoint
        self.processor, self.model = self._build_model()

    def _build_model(self):
        from mmf_tpu_torch.models.base_model import build_model
        from mmf_tpu_torch.utils.checkpoint import (
            load_model_weights,
            load_pretrained_model,
            model_state,
        )
        from mmf_tpu_torch.utils.env import import_user_module, setup_imports

        setup_imports()
        self.model_items = load_pretrained_model(self.checkpoint)
        config = self.model_items["config"]
        # models registered from a user plugin dir (env.user_dir in the
        # checkpoint's config snapshot) must be importable before
        # build_model resolves the registry key
        user_dir = (config.get("env") or {}).get("user_dir")
        if user_dir:
            import_user_module(user_dir)
        dataset_name = list(config["dataset_config"].keys())[0]
        datasets = config.get("datasets")
        # the dataset the model was trained on: ``dataset_name`` picks a
        # per-dataset model's heads
        self.dataset_name = datasets.split(",")[0] if isinstance(
            datasets, str) and datasets else dataset_name
        # processors are optional (e.g. raw-array models and plugins);
        # text requests then need pre-processed fields
        processor = config["dataset_config"][dataset_name].get("processors")
        model = build_model(config)
        state_dict = model_state(self.model_items["checkpoint"])
        if state_dict is None:
            raise ValueError(
                f"checkpoint {self.checkpoint!r} holds no model weights")
        # every entry of the model must come from the checkpoint: a
        # layer left at its init values would serve without an error
        load_model_weights(model, state_dict, config["model"],
                           strict=True)
        return processor, model.eval()

    def _region_features(self, image_path: str, max_regions: int = 100):
        raise NotImplementedError(
            "on-the-fly region features need the FRCNN detector, which the "
            "port does not have yet (ROADMAP A.6)"
        )

    def forward(self, image_path: str, text: dict, image_format: str = "path"):
        raise NotImplementedError(
            "Inference.forward is not ported yet (its region features need "
            "the FRCNN detector, ROADMAP A.6); send the question as 'text' "
            "and the image or region features as 'fields' to mmf_serve "
            "instead"
        )
