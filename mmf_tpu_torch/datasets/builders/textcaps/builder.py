"""The TextCaps builder.

Port of ``mmf_tpu/datasets/builders/textcaps/builder.py`` (reference
textcaps/builder.py and dataset.py): TextVQA's dataset read as a
captioning dataset. The question is empty, so the M4C trunk sees no
question text; ``caption_id`` stands for ``question_id``; the one
caption (``caption_str``) is the decoding target, given to the answer
processor as ``answers = [caption_str]``; the sample then carries the
packed ``caption_str`` and ``ref_strs`` (the annotation's
``reference_strs``, else the caption alone) in place of ``answers``.
Prediction rows are ``{"caption_id", "image_id", "caption",
"pred_source"}``.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.datasets.builders.textvqa.builder import TextVQABuilder
from mmf_tpu_torch.datasets.builders.textvqa.dataset import TextVQADataset
from mmf_tpu_torch.utils.distributed import object_to_byte_tensor


class TextcapsDataset(TextVQADataset):
    def __init__(self, config, dataset_type, imdb_file_index=0, *args,
                 **kwargs):
        super().__init__(config, dataset_type, imdb_file_index,
                         dataset_name="textcaps", *args, **kwargs)

    def preprocess_sample_info(self, sample_info):
        sample_info = super().preprocess_sample_info(sample_info)
        sample_info["question_str"] = ""
        if "caption_id" in sample_info:
            sample_info["question_id"] = sample_info["caption_id"]
        return sample_info

    def postprocess_evalai_entry(self, entry):
        return {
            "caption_id": entry["question_id"],
            "image_id": entry["image_id"],
            "caption": entry["answer"],
            "pred_source": entry["pred_source"],
        }

    def add_answer_info(self, sample_info, sample):
        has_caption = "caption_str" in sample_info
        if has_caption:
            sample_info = dict(sample_info,
                               answers=[sample_info["caption_str"]])
        sample = super().add_answer_info(sample_info, sample)
        if has_caption:
            sample.caption_str = object_to_byte_tensor(
                sample_info["caption_str"])
            sample.ref_strs = object_to_byte_tensor(
                sample_info.get("reference_strs",
                                [sample_info["caption_str"]]))
            sample.pop("answers")
        return sample


@registry.register_builder("textcaps")
class TextcapsBuilder(TextVQABuilder):
    def __init__(self, dataset_name="textcaps",
                 dataset_class=TextcapsDataset, *args, **kwargs):
        super().__init__(dataset_name, dataset_class)
        self.dataset_class = TextcapsDataset

    @classmethod
    def config_path(cls):
        return "configs/datasets/textcaps/defaults.yaml"
