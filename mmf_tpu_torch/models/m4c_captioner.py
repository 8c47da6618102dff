"""M4C-Captioner: M4C whose decode never emits ``<unk>``.

Port of ``mmf_tpu/models/m4c_captioner.py`` (reference
mmf/models/m4c_captioner.py:23). The M4C trunk with
``remove_unk_in_pred``: the ``<unk>`` column of the scores is set to
-1e10 at every output step (``M4C._finalize_scores``), in the
teacher-forced training pass and in each step of the greedy decode, so
the argmax fed back never picks it. ``<unk>``'s index is the config's
``unk_idx``, else the ``UNK_IDX`` of the first configured dataset's
answer processor in the registry (which the dataset's builder registers);
with neither, no column is masked, as in JAX. The empty question comes
from the TextCaps dataset, not from the model.
"""

from __future__ import annotations

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.m4c import M4C


@registry.register_model("m4c_captioner")
class M4CCaptioner(M4C):
    @classmethod
    def config_path(cls):
        return "configs/models/m4c_captioner/defaults.yaml"

    def _unk_idx(self):
        if "unk_idx" in self.config:
            return int(self.config["unk_idx"])
        datasets = self.config.get("datasets", None) or (
            registry.get("config", no_warning=True) or {}
        ).get("datasets", None)
        if isinstance(datasets, str):
            dataset = datasets.split(",")[0].strip()
        elif isinstance(datasets, (list, tuple)) and datasets:
            dataset = datasets[0]
        else:
            dataset = "textcaps"
        answer_processor = registry.get(f"{dataset}_answer_processor",
                                        no_warning=True)
        return getattr(answer_processor, "UNK_IDX", None)

    def _finalize_scores(self, scores):
        if not self.config.get("remove_unk_in_pred", True):
            return scores
        unk = self._unk_idx()
        if unk is None:
            return scores
        scores[..., unk] = -1e10  # a fresh tensor (the concatenated scores)
        return scores
