"""The Visual Genome builders.

Port of ``mmf_tpu/datasets/builders/visual_genome/builder.py``:
``visual_genome`` (Visual Genome's QA in VQA2's imdb format, read by the
VQA2 dataset under its own name and config tree) and
``masked_visual_genome`` (the masked LM over the questions, with the
region features and, with ``add_answer``, the answer's targets). The
detection builder (``detection_visual_genome``) is not ported yet.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.common.sample import Sample
from mmf_tpu_torch.datasets.builders.vqa2.builder import VQA2Builder
from mmf_tpu_torch.datasets.builders.vqa2.dataset import VQA2Dataset
from mmf_tpu_torch.datasets.mmf_dataset import MMFDataset
from mmf_tpu_torch.datasets.mmf_dataset_builder import MMFDatasetBuilder


class VisualGenomeDataset(VQA2Dataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        super().__init__(config, dataset_type, imdb_file_index,
                         dataset_name="visual_genome", *args, **kwargs)


class MaskedVisualGenomeDataset(MMFDataset):
    """The question through ``masked_token_processor`` (``is_correct``
    -1), the region features (``add_masked_features``) and, with
    ``add_answer`` (default true), the first answer's targets after
    ``vg_answer_preprocessor`` (which strips ``?``, ``,``, ``.``, ``a``,
    ``an`` and ``the`` as substrings, as MMF does)."""

    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        super().__init__("masked_visual_genome", config, dataset_type,
                         index=imdb_file_index)
        self._add_answer = config.get("add_answer", True)

    def load_item(self, idx):
        sample_info = self.annotation_db[idx]
        sample_info = self._preprocess_answer(sample_info)
        sample_info["question_id"] = sample_info["id"]
        current_sample = Sample()
        if self._use_features:
            current_sample = self.add_masked_features(idx, current_sample)
        current_sample = self._add_masked_question(sample_info,
                                                   current_sample)
        if self._add_answer:
            current_sample = self.add_answer_info(sample_info,
                                                  current_sample)
        return current_sample

    def _preprocess_answer(self, sample_info):
        sample_info["answers"] = [self.vg_answer_preprocessor(
            {"text": sample_info["answers"][0]},
            remove=["?", ",", ".", "a", "an", "the"])["text"]]
        return sample_info

    def add_answer_info(self, sample_info, sample):
        if "answers" in sample_info:
            processed = self.answer_processor(
                {"answers": sample_info["answers"]})
            sample.targets = processed["answers_scores"]
        return sample

    def _add_masked_question(self, sample_info, current_sample):
        processed = self.masked_token_processor(
            {"text_a": sample_info["question"], "text_b": None,
             "is_correct": -1})
        processed.pop("tokens", None)
        current_sample.update(processed)
        return current_sample


@registry.register_builder("visual_genome")
class VisualGenomeBuilder(VQA2Builder):
    def __init__(self, dataset_name="visual_genome",
                 dataset_class=VisualGenomeDataset, *args, **kwargs):
        super().__init__(dataset_name, dataset_class)
        self.dataset_class = VisualGenomeDataset

    @classmethod
    def config_path(cls):
        return "configs/datasets/visual_genome/defaults.yaml"


@registry.register_builder("masked_visual_genome")
class MaskedVisualGenomeBuilder(MMFDatasetBuilder):
    def __init__(self, dataset_name="masked_visual_genome", *args,
                 **kwargs):
        super().__init__(dataset_name, MaskedVisualGenomeDataset)

    @classmethod
    def config_path(cls):
        return "configs/datasets/visual_genome/masked.yaml"
