"""The flagship models and their example inputs, as the port builds them.

Counterparts of ``__graft_entry__.py::_visual_bert`` and
``_example_batch``: VisualBERT through the registry and the JAX
package's ``defaults.yaml`` (VisualBERT-base: 12 x 768, 12 heads, bf16
compute) with a VQA2 classification head (3129 answers), and VQA2-shaped
inputs (128 text tokens, 100 regions of 2048-dim features) drawn from a
numpy seed.

For training: ``vqa2_config`` merges
``projects/visual_bert/configs/vqa2/defaults.yaml`` over the JAX
package's ``config/defaults.yaml`` (both read as data),
``vqa2_visual_bert`` builds the model of its ``model_config``,
``vqa2_train_batch`` adds soft VQA targets to ``example_batch``, and
``vqa2_trainer`` builds the optimizer, schedule, losses and train step
from that config, as ``MMFTrainer`` does.

For masked-LM pretraining: ``masked_coco_config`` reads
``projects/visual_bert/configs/masked_coco/pretrain.yaml`` the same way
(VisualBERT with the ``pretraining`` head, AdamW lr 5e-5,
``warmup_linear``), ``masked_coco_train_batch`` adds ``lm_label_ids`` to
``example_batch``, and ``masked_coco_trainer`` builds the step as
``vqa2_trainer`` does (the model returns its own losses).

ViLBERT-base (``configs/models/vilbert/defaults.yaml``: a 12 x 768 text
stream, a 6 x 1024 image stream with 8 heads of 128, 6 co-attention
layers at 1024, bf16 compute): ``vilbert`` with the VQA2 head;
``vqa2_vilbert_config`` reads ``projects/vilbert/configs/vqa2/
defaults.yaml`` and ``masked_vqa2_vilbert_config`` ``projects/vilbert/
configs/masked_vqa2/pretrain.yaml``, each with the overrides those YAML
files need to run (``VILBERT_VQA2_OVERRIDES``,
``VILBERT_MASKED_VQA2_OVERRIDES``: the one place the chip run and the
tests take them from); ``vqa2_vilbert`` builds the model of either
config, sized by an example batch;
``vilbert_example_batch`` adds normalised region boxes and ragged region
counts to ``example_batch``, ``vilbert_train_batch`` VQA2 targets and
``masked_vqa2_train_batch`` the masked-LM labels, masked-region labels
and class probabilities.

ViLT-base (``projects/vilt/configs/vqa2/defaults.yaml``: a 12 x 768
pre-LN ViT over 40 text tokens and 384 px images in 16 px patches, f32,
the VQA2 MLP head at 1536 over 3129 answers): ``vilt_vqa2_config`` and
``vilt_pretrain_config`` (``masked_coco/pretrain.yaml``: the
``mlm_multi`` and ``itm`` heads) read the YAML, ``vilt`` builds the model
of either, ``vilt_example_batch`` draws its inputs (a ragged question
mask, images in [-1, 1] as ``vilt_image_processor`` gives them),
``vilt_train_batch`` adds VQA2 targets and ``vilt_pretrain_batch`` the
masked ids, their labels and ``is_correct``. MMFTransformer
(``projects/mmf_transformer/configs/vqa2/defaults.yaml``, bf16, 14
``vocab`` tokens and 100 regions of 2048): ``mmft_vqa2_config`` (with
``MMFT_VQA2_OVERRIDES``), ``mmft`` (sized by an example batch),
``mmft_example_batch`` and ``mmft_train_batch``.

For Hateful Memes at batch 1 (the JAX package's latency metric,
``tools/benchmarks/bench_latency.py``): ``mmbt_grid`` builds MMBT-grid
(ResNet-152 grid features, 12 x 768 trunk, 2 labels, bf16 compute) from
``configs/models/mmbt/defaults.yaml`` with the classification head, and
``hateful_memes_example_batch`` draws that script's inputs. For
training on Hateful Memes: ``HATEFUL_MEMES_CONFIGS`` names each model's
project config (MMBT, the five baselines and CNN-LSTM),
``hateful_memes_config(model, opts)`` reads one,
``hateful_memes_model(config)`` builds its model,
``hateful_memes_train_batch`` draws a training batch of the
``bert_tokenizer`` datasets' layout, and ``hateful_memes_trainer``
builds the step as ``vqa2_trainer`` does.

M4C on TextVQA (``projects/m4c/configs/textvqa/defaults.yaml``: TextBert
3 x 768 over 20 question tokens, MMT 4 x 768 over 100 objects, 50 OCR
tokens and 12 decode steps, 5000 answers, f32): ``textvqa_m4c_config``
reads the YAML with ``TEXTVQA_M4C_OVERRIDES``, ``textvqa_m4c_batch``
draws a batch of the TextVQA dataset's layout with teacher-forced
targets, and ``textvqa_trainer`` builds the step as ``vqa2_trainer``
does.

The M4C family: ``M4C_FAMILY`` names each config of ``mmf_run`` (M4C on
TextVQA, ST-VQA, OCR-VQA and TextVQA jointly with ST-VQA; the M4C
captioner on TextCaps) with its datasets, model and the overrides it
needs (``M4C_FAMILY_OVERRIDES``, in JAX too); ``m4c_family_model``
builds the model a config names.

The M4C captioner trained jointly on TextCaps and COCO is
``M4C_FAMILY["joint_coco"]``.

BUTD on COCO (``BUTD`` names its three configs: teacher forcing with
greedy evaluation, beam search, nucleus sampling; each with
``BUTD_OVERRIDES``) and Pythia on VQA2 (``PYTHIA_VQA2_CONFIG``, for each
of ``PYTHIA_MODELS``): ``pythia_config`` reads Pythia's, ``caption_model``
builds the model a config names, and ``caption_trainer`` builds the step
as ``vqa2_trainer`` does.

UNITER, LXMERT and VinVL (each BERT-base: 768 wide, 12 heads, f32):
``VL3`` names each config of ``mmf_run`` (UNITER finetuned on VQA2 and
pretrained on masked COCO, LXMERT finetuned on VQA2 and pretrained on
masked VQA2, VinVL finetuned on VQA2) with its dataset and model, and
``VL3_OVERRIDES`` what each YAML lacks to run (in JAX too);
``vl3_config(key, opts)`` reads one, ``vl3_model`` builds its model
(sized by an example batch where the model takes a width from the
data), ``vl3_batch(key, ...)`` draws a batch of the config's layout at
its widths, and ``vl3_trainer`` builds the step with the dataset's meta
fields.

mmf_bert (VQA2, masked VQA2), Pythia's multihead (VQA2) and Pythia on
Visual Genome: ``PYTHIA2`` names each config with its dataset and model,
``PYTHIA2_OVERRIDES`` what each YAML lacks to run (in JAX too);
``pythia2_config(key, opts)`` reads one, ``pythia2_model`` builds its
model, and ``mmf_bert_batch`` draws an mmf_bert batch (VQA2 targets, or
the masked LM's labels).

LoRRA (TextVQA, VQA2, VizWiz), BAN (VQA2, TextVQA, VizWiz) and CNN-LSTM
(Hateful Memes): ``LORRA_BAN`` names each config with its dataset and
model, ``LORRA_BAN_OVERRIDES`` what each YAML lacks to run (in JAX too);
``lorra_ban_model`` builds the model of a run's config, and
``text_vocab_size(config)`` reads the size of a config's text
vocabulary, which CNN-LSTM's Hateful Memes run must be given.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

VQA2_NUM_LABELS = 3129
VQA2_CONFIG = "projects/visual_bert/configs/vqa2/defaults.yaml"
VQA2_META = {"dataset_name": "vqa2", "dataset_type": "train"}
MASKED_COCO_CONFIG = "projects/visual_bert/configs/masked_coco/pretrain.yaml"
MASKED_COCO_META = {"dataset_name": "masked_coco", "dataset_type": "train"}
HATEFUL_MEMES_META = {"dataset_name": "hateful_memes", "dataset_type": "test"}
HATEFUL_MEMES_TRAIN_META = {"dataset_name": "hateful_memes",
                            "dataset_type": "train"}
# model -> (project config, the dataset config's text processor is BERT's)
HATEFUL_MEMES_CONFIGS = {
    "mmbt": ("projects/hateful_memes/configs/mmbt/defaults.yaml", True),
    "concat_bert": ("projects/hateful_memes/configs/concat_bert/"
                    "defaults.yaml", True),
    "late_fusion": ("projects/hateful_memes/configs/late_fusion/"
                    "defaults.yaml", True),
    "concat_bow": ("projects/hateful_memes/configs/concat_bow/defaults.yaml",
                   False),
    "unimodal_text": ("projects/hateful_memes/configs/unimodal/text.yaml",
                      True),
    "unimodal_text_bert": ("projects/hateful_memes/configs/unimodal/"
                           "bert.yaml", True),
    "unimodal_image": ("projects/hateful_memes/configs/unimodal/image.yaml",
                       False),
    "cnn_lstm": ("projects/others/cnn_lstm/hateful_memes/defaults.yaml",
                 False),
}
VILBERT_VQA2_CONFIG = "projects/vilbert/configs/vqa2/defaults.yaml"
VILBERT_MASKED_VQA2_CONFIG = "projects/vilbert/configs/masked_vqa2/pretrain.yaml"
MASKED_VQA2_META = {"dataset_name": "masked_vqa2", "dataset_type": "train"}
V_TARGET_SIZE = 1601  # the detector's classes (cls_prob's width)
# what projects/vilbert/configs/vqa2/defaults.yaml lacks to run ViLBERT
# (faults of the YAML, ROADMAP C): the dataset's GloVe ``vocab`` text
# processor yields no ``input_ids``, so the question goes through
# bert_tokenizer at 128 tokens, as VisualBERT's VQA2 config does; and
# ``return_features_info: false`` gives no box locations, so the info is
# returned and its boxes go through masked.yaml's transformer_bbox
VILBERT_VQA2_OVERRIDES = [
    "dataset_config.vqa2.processors.text_processor={type: bert_tokenizer, "
    "params: {tokenizer_config: {type: bert-base-uncased, params: "
    "{do_lower_case: true}}, max_seq_length: 128}}",
    "dataset_config.vqa2.return_features_info=true",
    "dataset_config.vqa2.processors.transformer_bbox_processor={type: "
    "transformer_bbox, params: {bbox_key: bbox, image_width_key: "
    "image_width, image_height_key: image_height}}",
]
# configs/datasets/vqa2/masked.yaml names a transformer_bbox processor
# and the masked-region loss reads cls_prob, both from the features'
# info, which its ``return_features_info: false`` leaves out
VILBERT_MASKED_VQA2_OVERRIDES = [
    "dataset_config.masked_vqa2.return_features_info=true",
]
VILT_VQA2_CONFIG = "projects/vilt/configs/vqa2/defaults.yaml"
VILT_PRETRAIN_CONFIG = "projects/vilt/configs/masked_coco/pretrain.yaml"
VILT_SEQ, VILT_IMAGE = 40, 384  # the VQA2 config's tokens and pixels
MMFT_VQA2_CONFIG = "projects/mmf_transformer/configs/vqa2/defaults.yaml"
MMFT_SEQ = 14  # configs/datasets/vqa2/defaults.yaml's vocab max_length
# what projects/mmf_transformer/configs/vqa2/defaults.yaml lacks to run
# (a fault of the YAML, ROADMAP C): it sets num_labels 3129 but keeps the
# model defaults' head list, a 2-label mlp, whose scores do not meet the
# 3129 VQA2 targets
MMFT_VQA2_OVERRIDES = [
    "model_config.mmf_transformer.heads=[{type: mlp, num_labels: 3129}]",
]


TEXTVQA_M4C_CONFIG = "projects/m4c/configs/textvqa/defaults.yaml"
TEXTVQA_META = {"dataset_name": "textvqa", "dataset_type": "train"}
# M4C's answer space: fixed_answer_vocab_textvqa_5k.txt's 5000 answers,
# then the 50 OCR copy slots; 12 decode steps (max_copy_steps)
M4C_ANSWERS, M4C_OCR, M4C_STEPS = 5000, 50, 12
M4C_TEXT, M4C_OBJECTS = 20, 100  # max_seq_length, max_features
# what configs/datasets/textvqa/defaults.yaml lacks to run M4C (a fault
# of the YAML, in JAX too; ROADMAP C.4): M4C reads the OCR boxes' fc7
# features as image_feature_1, the second LMDB of one comma-joined
# features entry (the reference's "detectron.lmdb,ocr_en_frcn_features.
# lmdb"), and the YAML lists detectron.lmdb alone
TEXTVQA_FEATURES = ("textvqa/defaults/features/open_images/detectron.lmdb,"
                    "textvqa/ocr_en/features/ocr_en_frcn_features.lmdb")
TEXTVQA_M4C_OVERRIDES = [
    f"dataset_config.textvqa.features.{split}=['{TEXTVQA_FEATURES}']"
    for split in ("train", "val", "test")
]


def _ocr_features_overrides(dataset: str) -> List[str]:
    """``dataset``'s object LMDB (its YAML's) and the OCR boxes' LMDB as
    one comma-joined features entry, as ``TEXTVQA_M4C_OVERRIDES`` gives
    TextVQA's: the YAMLs of ST-VQA, OCR-VQA and TextCaps list the object
    LMDB alone, and M4C reads the OCR features as image_feature_1 (in
    JAX too, ROADMAP C.4)."""
    features = (f"{dataset}/defaults/features/open_images/detectron.lmdb,"
                f"{dataset}/ocr_en/features/ocr_en_frcn_features.lmdb")
    return [f"dataset_config.{dataset}.features.{split}=['{features}']"
            for split in ("train", "val", "test")]


# the TextCaps YAML's m4c_answer processor asserts ten answers a sample,
# and the dataset gives it one, the caption (AssertionError on every
# train and val sample, in JAX too; ROADMAP C.4): one answer
TEXTCAPS_ONE_ANSWER = ("dataset_config.textcaps.processors.answer_processor."
                       "params.num_answers=1")
# the joint config's early stopping watches val/textvqa/textvqa_accuracy,
# but an evaluation over several datasets scores the combined report under
# the name of the dataset of its last batch, which size_proportional
# draws at random (ValueError: the metric is not present in meter, at the
# first validation, in JAX too; ROADMAP C.4): it watches the loss
JOINT_EARLY_STOP = ["training.early_stop.criteria=total_loss",
                    "training.early_stop.minimize=true"]
# key -> (project config, datasets, model)
M4C_FAMILY = {
    "textvqa": (TEXTVQA_M4C_CONFIG, "textvqa", "m4c"),
    "stvqa": ("projects/m4c/configs/stvqa/defaults.yaml", "stvqa", "m4c"),
    "ocrvqa": ("projects/m4c/configs/ocrvqa/defaults.yaml", "ocrvqa", "m4c"),
    "joint": ("projects/m4c/configs/textvqa/joint_with_stvqa.yaml",
              "textvqa,stvqa", "m4c"),
    "textcaps": ("projects/m4c_captioner/configs/m4c_captioner/textcaps/"
                 "defaults.yaml", "textcaps", "m4c_captioner"),
}
M4C_FAMILY_OVERRIDES = {
    "textvqa": TEXTVQA_M4C_OVERRIDES,
    "stvqa": _ocr_features_overrides("stvqa"),
    "ocrvqa": _ocr_features_overrides("ocrvqa"),
    "joint": (TEXTVQA_M4C_OVERRIDES + _ocr_features_overrides("stvqa")
              + JOINT_EARLY_STOP),
    "textcaps": _ocr_features_overrides("textcaps") + [TEXTCAPS_ONE_ANSWER],
}
# the captioner trained jointly on TextCaps and COCO: the YAML's own train
# features and annotations (32 tiles of TextCaps', read from TextVQA's
# LMDBs, and COCO's); val and test keep TextCaps' object LMDB alone, which
# needs the OCR features' (as the TextCaps config does), and the
# ``m4c_answer`` processor one answer a caption. Its zoo requirements name
# textvqa.defaults and textvqa.ocr_en, whose versions differ and share
# datasets/textvqa's build markers, so JAX downloads one of them on every
# run: the override keeps textvqa.defaults (ROADMAP C.4)
JOINT_COCO = ("projects/m4c_captioner/configs/m4c_captioner/textcaps/"
              "joint_with_coco.yaml", "textcaps", "m4c_captioner")
M4C_FAMILY["joint_coco"] = JOINT_COCO
M4C_FAMILY_OVERRIDES["joint_coco"] = [
    o for o in _ocr_features_overrides("textcaps") if ".train=" not in o
] + [TEXTCAPS_ONE_ANSWER,
     "dataset_config.textcaps.zoo_requirements=[textvqa.defaults,"
     "textcaps.defaults,coco.m4c_captioner,coco.ocr_en]"]

# BUTD on COCO and Pythia on VQA2. BUTD's COCO config hands Adamax a
# ``weight_decay: 0``, which optax.adamax does not take: JAX raises
# TypeError before the first update (so does the port, ROADMAP C.4); the
# override drops the key. Pythia's VQA2 config runs as it is
BUTD = {"defaults": "projects/butd/configs/coco/defaults.yaml",
        "beam_search": "projects/butd/configs/coco/beam_search.yaml",
        "nucleus_sampling": "projects/butd/configs/coco/nucleus_sampling.yaml"}
BUTD_OVERRIDES = ["optimizer.params={lr: 0.01, eps: 1.0e-08}"]
PYTHIA_VQA2_CONFIG = "projects/pythia/configs/vqa2/defaults.yaml"
PYTHIA_MODELS = ("pythia", "pythia_question_only", "pythia_image_only")


# UNITER, LXMERT and VinVL. Each YAML lacks something to run (ROADMAP
# C.4, in JAX too): the VQA2 defaults' GloVe ``vocab`` text processor
# yields no ``input_ids``, and ``return_features_info: false`` no boxes,
# so UNITER's and LXMERT's VQA2 configs take ViLBERT's overrides; LXMERT's
# VQA2 config keeps the defaults' pretraining head (the masked LM scores
# [B·T, 30522] meet the 3129 VQA2 targets at the first evaluation); the
# masked datasets' ``transformer_bbox`` reads the features' info that
# ``return_features_info: false`` drops (KeyError: 'image_info_0'); UNITER's
# masked-COCO config names no pretraining heads, so every task builds a
# 2-label ``mlp`` that returns no loss; LXMERT's pretraining config
# inherits ``vqa_accuracy``, which its scores cannot meet; VinVL's base
# VQA2 dataset must give its question as text (the ``vocab`` processor
# gives indices) and the features' info its tags read, and its early
# stopping watches vqa2/vqa_accuracy where the dataset is named vinvl
UNITER_PRETRAIN_TASKS = ("mlm", "itm", "mrc", "mrfr")
VL3 = {  # key -> (project config, dataset, model)
    "uniter_vqa2": ("projects/uniter/configs/vqa2/defaults.yaml", "vqa2",
                    "uniter"),
    "uniter_masked_coco": ("projects/uniter/configs/masked_coco/"
                           "defaults.yaml", "masked_coco", "uniter"),
    "lxmert_vqa2": ("projects/lxmert/configs/vqa2/defaults.yaml", "vqa2",
                    "lxmert"),
    "lxmert_pretrain": ("projects/lxmert/configs/vqa2/pretrain.yaml",
                        "masked_vqa2", "lxmert"),
    "vinvl_vqa2": ("projects/vinvl/configs/vqa2/defaults.yaml", "vinvl",
                   "vinvl"),
}
VL3_OVERRIDES = {
    "uniter_vqa2": list(VILBERT_VQA2_OVERRIDES),
    "uniter_masked_coco": [
        "dataset_config.masked_coco.return_features_info=true"] + [
        f"model_config.uniter.heads.{task}={{type: {task}}}"
        for task in UNITER_PRETRAIN_TASKS],
    "lxmert_vqa2": VILBERT_VQA2_OVERRIDES + [
        "model_config.lxmert.training_head_type=classification"],
    "lxmert_pretrain": ["evaluation.metrics=[]"],
    "vinvl_vqa2": [VILBERT_VQA2_OVERRIDES[0],
                   "dataset_config.vqa2.return_features_info=true",
                   "training.early_stop.criteria=vinvl/vqa_accuracy"],
}
# mmf_bert on VQA2 and its masked-VQA2 pretraining, Pythia's multihead on
# VQA2 and Pythia on Visual Genome. What each YAML lacks to run (ROADMAP
# C.4, in JAX too): mmf_bert's pretraining head returns its own losses,
# keyed <dataset>/<split>/<name>, so the meter holds no val/total_loss and
# the masked-VQA2 run's early stopping raises ValueError at its first
# validation: it watches the masked LM's val loss (a criterion that names
# "val" is taken as it is). The other three run as they are (mmf_bert's
# VQA head is num_labels wide, 3129 by default, VQA2's answers)
PYTHIA2 = {  # key -> (project config, dataset, model)
    "mmf_bert_vqa2": ("projects/others/mmf_bert/configs/vqa2/defaults.yaml",
                      "vqa2", "mmf_bert"),
    "mmf_bert_masked_vqa2": ("projects/others/mmf_bert/configs/masked_vqa2/"
                             "defaults.yaml", "masked_vqa2", "mmf_bert"),
    "multihead": ("projects/pythia/configs/multihead/defaults.yaml", "vqa2",
                  "multihead"),
    "pythia_visual_genome": ("projects/pythia/configs/visual_genome/"
                             "defaults.yaml", "visual_genome", "pythia"),
}
PYTHIA2_OVERRIDES = {
    "mmf_bert_vqa2": [],
    "mmf_bert_masked_vqa2": [
        "training.early_stop.criteria=masked_vqa2/val/masked_lm_loss",
        "training.early_stop.minimize=true"],
    "multihead": [],
    "pythia_visual_genome": [],
}
# LoRRA on TextVQA, VQA2 and VizWiz, BAN on VQA2, TextVQA and VizWiz,
# CNN-LSTM on Hateful Memes
LORRA_BAN = {  # key -> (project config, dataset, model)
    "lorra_textvqa": ("projects/lorra/configs/textvqa/defaults.yaml",
                      "textvqa", "lorra"),
    "lorra_vqa2": ("projects/lorra/configs/vqa2/defaults.yaml", "vqa2",
                   "lorra"),
    "lorra_vizwiz": ("projects/lorra/configs/vizwiz/defaults.yaml",
                     "vizwiz", "lorra"),
    "ban_vqa2": ("projects/ban/configs/vqa2/defaults.yaml", "vqa2", "ban"),
    "ban_textvqa": ("projects/ban/configs/textvqa/defaults.yaml", "textvqa",
                    "ban"),
    "ban_vizwiz": ("projects/ban/configs/vizwiz/defaults.yaml", "vizwiz",
                   "ban"),
    "cnn_lstm_hateful_memes": (HATEFUL_MEMES_CONFIGS["cnn_lstm"][0],
                               "hateful_memes", "cnn_lstm"),
}
LORRA_BAN_OVERRIDES = {key: [] for key in LORRA_BAN}
for _key in ("lorra_textvqa", "lorra_vqa2", "lorra_vizwiz"):
    LORRA_BAN_OVERRIDES[_key] = list(BUTD_OVERRIDES)
LORRA_BAN_OVERRIDES["lorra_vqa2"].append(
    "dataset_config.vqa2.zoo_requirements=[coco.defaults,vqa2.defaults]")
for _key in ("ban_textvqa", "ban_vizwiz"):
    LORRA_BAN_OVERRIDES[_key] = ["optimizer.type=Adamax",
                                 "optimizer.params={lr: 0.005, eps: 1.0e-08}"]
for _key in ("lorra_textvqa", "ban_textvqa"):
    LORRA_BAN_OVERRIDES[_key].append(
        "dataset_config.textvqa.processors.answer_processor={type: "
        "soft_copy_answer, params: {vocab_file: textvqa/defaults/extras/"
        "vocabs/fixed_answer_vocab_textvqa_5k.txt, preprocessor: {type: "
        "simple_word, params: {}}, context_preprocessor: {type: "
        "simple_word, params: {}}, max_length: 50, num_answers: 10}}")
LORRA_BAN_OVERRIDES["cnn_lstm_hateful_memes"] = [
    "model_config.cnn_lstm.num_labels=2"]
# mmf_bert's tokens (bert_tokenizer's max_seq_length), the regions
MMF_BERT_SEQ, PYTHIA_REGIONS = 128, 100
# the widths the configs give their inputs: tokens and regions
VL3_SEQ = {"uniter_vqa2": 128, "uniter_masked_coco": 128,
           "lxmert_vqa2": 128, "lxmert_pretrain": 20, "vinvl_vqa2": 70}
VL3_REGIONS = {"lxmert_pretrain": 36}


def visual_bert(model_overrides: Optional[Dict[str, Any]] = None):
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    cfg = load_yaml("configs/models/visual_bert/defaults.yaml")
    mc = cfg["model_config"]["visual_bert"]
    mc["training_head_type"] = "classification"
    mc["num_labels"] = VQA2_NUM_LABELS
    if model_overrides:
        mc.update(model_overrides)
    return registry.get_model_class("visual_bert")(config=mc)


def example_batch(batch_size: int = 8, seq_len: int = 128,
                  regions: int = 100, vdim: int = 2048,
                  vocab_size: int = 30522,
                  seed: int = 0) -> Dict[str, Any]:
    """Batch dict of numpy arrays in the ``_example_batch`` layout (same
    draws from ``np.random.RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    return {
        "input_ids": rng.randint(0, vocab_size,
                                 (batch_size, seq_len)).astype(np.int32),
        "input_mask": np.ones((batch_size, seq_len), np.int32),
        "segment_ids": np.zeros((batch_size, seq_len), np.int32),
        "image_feature_0": rng.randn(batch_size, regions,
                                     vdim).astype(np.float32),
        "image_info_0": {
            "max_features": np.full((batch_size,), regions, np.int32)
        },
    }


def mmbt_grid(model_overrides: Optional[Dict[str, Any]] = None):
    """MMBT-grid for Hateful Memes, as ``bench_latency.py`` builds it: the
    MMBT defaults with the classification head, 2 labels and bf16
    compute, then ``model_overrides`` (e.g. ``{"quant": "int8"}``)."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    cfg = load_yaml("configs/models/mmbt/defaults.yaml")
    mc = cfg["model_config"]["mmbt"]
    mc["training_head_type"] = "classification"
    mc["num_labels"] = 2
    mc["dtype"] = "bfloat16"
    mc = omega.merge(mc, model_overrides or {})
    return registry.get_model_class("mmbt")(config=mc)


def hateful_memes_example_batch(batch_size: int = 1,
                                seed: int = 0) -> Dict[str, Any]:
    """``bench_latency.py``'s inputs (same draws from
    ``np.random.RandomState(seed)``): 128 text tokens, all-ones mask,
    zero segments, a [B, 3, 224, 224] f32 image, and the
    ``hateful_memes`` meta fields."""
    rng = np.random.RandomState(seed)
    input_ids = rng.randint(0, 30522, (batch_size, 128)).astype(np.int32)
    return {
        "input_ids": input_ids,
        "input_mask": np.ones((batch_size, 128), np.int32),
        "segment_ids": np.zeros((batch_size, 128), np.int32),
        "image": rng.randn(batch_size, 3, 224, 224).astype(np.float32),
        **HATEFUL_MEMES_META,
    }


def split_samples(batch: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Batch dict -> list of per-sample dicts (one request each); fields
    that are not arrays (meta strings) go to every sample as they are."""
    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i] if isinstance(tree, np.ndarray) else tree

    n = len(next(v for v in batch.values() if isinstance(v, np.ndarray)))
    return [take(batch, i) for i in range(n)]


def _project_config(path: str, dataset: str, opts: Optional[List[str]],
                    model: str = "visual_bert"):
    """A project config merged over the root defaults, ``model`` and
    ``datasets`` set as the command line sets them, then ``opts``
    (``a.b.c=value`` overrides) applied, every interpolation resolved."""
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.config.configuration import load_yaml

    cfg = omega.merge(load_yaml("config/defaults.yaml"), load_yaml(path))
    omega.merge_with_dotlist(cfg, [f"model={model}", f"datasets={dataset}"]
                             + list(opts or []))
    # interpolations inside lists (ViLT's image_size) resolve only here,
    # as Configuration resolves them eagerly
    return omega.resolve_all(cfg)


def vqa2_config(opts: Optional[List[str]] = None):
    """The VQA2 VisualBERT config merged over the root defaults, then
    ``opts`` applied."""
    return _project_config(VQA2_CONFIG, "vqa2", opts)


def masked_coco_config(opts: Optional[List[str]] = None):
    """The masked-COCO VisualBERT pretraining config merged over the
    root defaults, then ``opts`` applied. The YAML quotes
    ``num_training_steps`` ('11000'); it is read as the number it names,
    since the schedule does arithmetic on it."""
    cfg = _project_config(MASKED_COCO_CONFIG, "masked_coco", opts)
    params = cfg["scheduler"]["params"]
    params["num_training_steps"] = int(params["num_training_steps"])
    return cfg


def vqa2_vilbert_config(opts: Optional[List[str]] = None):
    """The VQA2 ViLBERT config merged over the root defaults, then
    ``VILBERT_VQA2_OVERRIDES`` and ``opts`` applied."""
    return _project_config(VILBERT_VQA2_CONFIG, "vqa2",
                           VILBERT_VQA2_OVERRIDES + list(opts or []),
                           "vilbert")


def masked_vqa2_vilbert_config(opts: Optional[List[str]] = None):
    """The masked-VQA2 ViLBERT pretraining config (AdamW lr 1e-4,
    ``warmup_linear``) merged over the root defaults, then
    ``VILBERT_MASKED_VQA2_OVERRIDES`` and ``opts`` applied; the schedule's
    ``num_training_steps`` is read as the number it names."""
    cfg = _project_config(VILBERT_MASKED_VQA2_CONFIG, "masked_vqa2",
                          VILBERT_MASKED_VQA2_OVERRIDES + list(opts or []),
                          "vilbert")
    params = cfg["scheduler"]["params"]
    params["num_training_steps"] = int(params["num_training_steps"])
    return cfg


# the unimodal text configs name no optimizer and the root defaults give
# none a type, so they do not run as they stand, in JAX either; they take
# concat_bow's
HATEFUL_MEMES_OVERRIDES = {
    key: ["optimizer.type=adam_w", "optimizer.params.lr=5.0e-05",
          "optimizer.params.eps=1.0e-08"]
    for key in ("unimodal_text", "unimodal_text_bert")
}


def hateful_memes_model_name(key: str) -> str:
    """The registered model of a ``HATEFUL_MEMES_CONFIGS`` key."""
    return "unimodal_text" if key == "unimodal_text_bert" else key


def hateful_memes_config(key: str = "mmbt",
                         opts: Optional[List[str]] = None):
    """The Hateful Memes project config of ``key`` (a
    ``HATEFUL_MEMES_CONFIGS`` key) merged over the root defaults, then
    its ``HATEFUL_MEMES_OVERRIDES`` and ``opts``. The schedule's ``num_training_steps`` quotes an
    interpolation (``'${training.max_updates}'``), which resolves to the
    number it names."""
    path = HATEFUL_MEMES_CONFIGS[key][0]
    cfg = _project_config(path, "hateful_memes",
                          HATEFUL_MEMES_OVERRIDES.get(key, [])
                          + list(opts or []),
                          hateful_memes_model_name(key))
    params = (cfg.get("scheduler", {}) or {}).get("params", {}) or {}
    if "num_training_steps" in params:
        params["num_training_steps"] = int(params["num_training_steps"])
    return cfg


def hateful_memes_model(config,
                        model_overrides: Optional[Dict[str, Any]] = None):
    """The model the config's ``model`` key names, from its
    ``model_config``, with ``model_overrides`` on a copy."""
    return _model(config["model"], config, model_overrides)


def hateful_memes_train_batch(batch_size: int = 32, seq_len: int = 128,
                              image_size: int = 224, vocab_size: int = 30522,
                              seed: int = 0) -> Dict[str, Any]:
    """A Hateful Memes training batch from a numpy seed: BERT inputs
    with ragged masks (6 tokens up to ``seq_len``) and two segments in
    about half the samples, a [B, 3, S, S] f32 image, class
    ``targets``, and ``text`` ids as the ``vocab`` processor gives them
    (14 tokens)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(6, seq_len + 1, batch_size)
    mask = (np.arange(seq_len)[None] < lengths[:, None]).astype(np.int32)
    two = rng.rand(batch_size) < 0.5
    segments = ((np.arange(seq_len)[None] >= lengths[:, None] // 2)
                & two[:, None] & (mask > 0)).astype(np.int32)
    return {
        "input_ids": rng.randint(0, vocab_size, (batch_size, seq_len)
                                 ).astype(np.int32),
        "input_mask": mask,
        "segment_ids": segments,
        "image": rng.randn(batch_size, 3, image_size, image_size).astype(
            np.float32),
        "targets": rng.randint(0, 2, batch_size).astype(np.int64),
        "text": rng.randint(0, 64, (batch_size, MMFT_SEQ)).astype(np.int64),
    }


def hateful_memes_trainer(model, config, seed: int = 0,
                          device: Any = "cuda"):
    """``vqa2_trainer`` with the Hateful Memes training meta fields."""
    return vqa2_trainer(model, config, seed, device,
                        HATEFUL_MEMES_TRAIN_META)


def _sized(model, example):
    """``model`` with its lazily sized layers materialised by
    ``example`` (numpy), or by ``vilbert_example_batch``'s layout."""
    import torch

    if example is None:
        example = vilbert_example_batch(1, seq_len=1, regions=1, vdim=1)

    def to_torch(tree):
        if isinstance(tree, dict):
            return {k: to_torch(v) for k, v in tree.items()}
        return torch.from_numpy(np.asarray(tree))

    return model.materialize(to_torch(example))


def vilbert(model_overrides: Optional[Dict[str, Any]] = None,
            example: Optional[Dict[str, Any]] = None):
    """ViLBERT-base from ``configs/models/vilbert/defaults.yaml`` with the
    classification head and VQA2's 3129 answers, then
    ``model_overrides``; sized by ``example`` (see ``_sized``)."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    mc = load_yaml("configs/models/vilbert/defaults.yaml")["model_config"][
        "vilbert"]
    mc["training_head_type"] = "classification"
    mc["num_labels"] = VQA2_NUM_LABELS
    mc = omega.merge(mc, model_overrides or {})
    return _sized(registry.get_model_class("vilbert")(config=mc), example)


def vqa2_vilbert(config, model_overrides: Optional[Dict[str, Any]] = None,
                 example: Optional[Dict[str, Any]] = None):
    """ViLBERT from the config's ``model_config.vilbert`` (whichever head
    it names) with ``model_overrides`` on a copy, sized by ``example``."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    mc = omega.merge(config["model_config"]["vilbert"],
                     model_overrides or {})
    return _sized(registry.get_model_class("vilbert")(config=mc), example)


def vqa2_visual_bert(config, model_overrides: Optional[Dict[str, Any]] = None):
    """VisualBERT from the config's ``model_config.visual_bert`` (whichever
    head it names: the masked-COCO config's too) with ``model_overrides``
    on a copy."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    mc = omega.merge(config["model_config"]["visual_bert"],
                     model_overrides or {})
    return registry.get_model_class("visual_bert")(config=mc)


def vilt_vqa2_config(opts: Optional[List[str]] = None):
    """ViLT's VQA2 config merged over the root defaults, then ``opts``."""
    return _project_config(VILT_VQA2_CONFIG, "vqa2", opts, "vilt")


def vilt_pretrain_config(opts: Optional[List[str]] = None):
    """ViLT's MLM + ITM pretraining config (masked COCO) merged over the
    root defaults, then ``opts``."""
    return _project_config(VILT_PRETRAIN_CONFIG, "masked_coco", opts, "vilt")


def mmft_vqa2_config(opts: Optional[List[str]] = None):
    """MMFTransformer's VQA2 config merged over the root defaults, then
    ``MMFT_VQA2_OVERRIDES`` and ``opts``."""
    return _project_config(MMFT_VQA2_CONFIG, "vqa2",
                           MMFT_VQA2_OVERRIDES + list(opts or []),
                           "mmf_transformer")


def _model(name, config, model_overrides):
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    mc = omega.merge(config["model_config"][name], model_overrides or {})
    return registry.get_model_class(name)(config=mc)


def vilt(config, model_overrides: Optional[Dict[str, Any]] = None):
    """ViLT from the config's ``model_config.vilt`` (whichever heads it
    names) with ``model_overrides`` on a copy."""
    return _model("vilt", config, model_overrides)


def mmft(config, model_overrides: Optional[Dict[str, Any]] = None,
         example: Optional[Dict[str, Any]] = None):
    """MMFTransformer from the config's ``model_config.mmf_transformer``
    with ``model_overrides`` on a copy, its feature projections and
    position tables sized by ``example`` (``mmft_example_batch(1)`` by
    default)."""
    model = _model("mmf_transformer", config, model_overrides)
    return _sized(model, mmft_example_batch(1) if example is None
                  else example)


def vilt_example_batch(batch_size: int = 8, seq_len: int = VILT_SEQ,
                       image_size: int = VILT_IMAGE,
                       vocab_size: int = 30522,
                       seed: int = 0) -> Dict[str, Any]:
    """ViLT's inputs, drawn from ``np.random.RandomState(seed)``: questions
    of 6 to ``seq_len`` tokens ([CLS] ... [SEP], padded with 0 and
    masked), zero segments, and ``image`` [B, 3, S, S] uniform in [-1,
    1], the range ``vilt_image_processor`` gives."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1000, vocab_size, (batch_size, seq_len))
    lengths = rng.randint(min(6, seq_len), seq_len + 1, batch_size)
    mask = (np.arange(seq_len)[None] < lengths[:, None]).astype(np.int64)
    ids[:, 0] = 101
    ids[np.arange(batch_size), lengths - 1] = 102
    return {
        "input_ids": (ids * mask).astype(np.int64),
        "input_mask": mask,
        "segment_ids": np.zeros((batch_size, seq_len), np.int64),
        "image": rng.uniform(-1.0, 1.0, (batch_size, 3, image_size,
                                         image_size)).astype(np.float32),
    }


def vilt_train_batch(batch_size: int = 8, seq_len: int = VILT_SEQ,
                     image_size: int = VILT_IMAGE, vocab_size: int = 30522,
                     num_labels: int = VQA2_NUM_LABELS,
                     seed: int = 0) -> Dict[str, Any]:
    """``vilt_example_batch`` plus ``vqa2_train_batch``'s targets."""
    batch = vilt_example_batch(batch_size, seq_len, image_size, vocab_size,
                               seed)
    batch["targets"] = vqa2_train_batch(batch_size, 1, 1, 1, vocab_size,
                                        num_labels, seed)["targets"]
    return batch


def vilt_pretrain_batch(batch_size: int = 8, seq_len: int = VILT_SEQ,
                        image_size: int = VILT_IMAGE,
                        vocab_size: int = 30522,
                        mask_probability: float = 0.15,
                        false_caption_probability: float = 0.1,
                        seed: int = 0) -> Dict[str, Any]:
    """``vilt_example_batch`` plus the MLM + ITM fields, drawn from
    ``np.random.RandomState(seed + 1)``: ``input_ids_masked`` (each
    question token replaced by [MASK] with ``mask_probability``; the
    ``masked_token`` processor's rate), ``lm_label_ids`` (the replaced
    tokens' ids, -1 elsewhere) and ``is_correct`` (0 with
    ``false_caption_probability``, the config's false-caption rate)."""
    batch = vilt_example_batch(batch_size, seq_len, image_size, vocab_size,
                               seed)
    rng = np.random.RandomState(seed + 1)
    ids, mask = batch["input_ids"], batch["input_mask"]
    inner = (mask > 0) & (ids != 101) & (ids != 102)
    masked = inner & (rng.rand(batch_size, seq_len) < mask_probability)
    batch["input_ids_masked"] = np.where(masked, 103, ids).astype(np.int64)
    batch["lm_label_ids"] = np.where(masked, ids, -1).astype(np.int64)
    batch["is_correct"] = (rng.rand(batch_size)
                           >= false_caption_probability).astype(np.int64)
    return batch


def mmft_example_batch(batch_size: int = 8, seq_len: int = MMFT_SEQ,
                       regions: int = 100, vdim: int = 2048,
                       vocab_size: int = 100, seed: int = 0
                       ) -> Dict[str, Any]:
    """MMFTransformer's VQA2 inputs: ``text`` [B, seq_len], the ``vocab``
    processor's word indices (padded with 0), and ``example_batch``'s
    region features, drawn from ``np.random.RandomState(seed)``."""
    batch = example_batch(batch_size, 1, regions, vdim, 2, seed)
    rng = np.random.RandomState(seed + 4)
    lengths = rng.randint(3, seq_len + 1, batch_size)
    words = rng.randint(4, vocab_size, (batch_size, seq_len))
    batch["text"] = np.where(np.arange(seq_len)[None] < lengths[:, None],
                             words, 0).astype(np.int64)
    for key in ("input_ids", "input_mask", "segment_ids"):
        batch.pop(key)
    return batch


def mmft_train_batch(batch_size: int = 8, seq_len: int = MMFT_SEQ,
                     regions: int = 100, vdim: int = 2048,
                     vocab_size: int = 100,
                     num_labels: int = VQA2_NUM_LABELS,
                     seed: int = 0) -> Dict[str, Any]:
    """``mmft_example_batch`` plus ``vqa2_train_batch``'s targets."""
    batch = mmft_example_batch(batch_size, seq_len, regions, vdim,
                               vocab_size, seed)
    batch["targets"] = vqa2_train_batch(batch_size, 1, 1, 1, 2, num_labels,
                                        seed)["targets"]
    return batch


def vqa2_train_batch(batch_size: int = 8, seq_len: int = 128,
                     regions: int = 100, vdim: int = 2048,
                     vocab_size: int = 30522,
                     num_labels: int = VQA2_NUM_LABELS,
                     seed: int = 0) -> Dict[str, Any]:
    """``example_batch`` plus ``targets`` [B, num_labels]: VQA soft
    scores, three answers per question at 0.3, 0.6, 0.9 or 1.0, drawn
    from ``np.random.RandomState(seed + 1)``."""
    batch = example_batch(batch_size, seq_len, regions, vdim, vocab_size,
                          seed)
    rng = np.random.RandomState(seed + 1)
    targets = np.zeros((batch_size, num_labels), np.float32)
    for i in range(batch_size):
        idx = rng.choice(num_labels, size=min(3, num_labels), replace=False)
        targets[i, idx] = rng.choice([0.3, 0.6, 0.9, 1.0], size=len(idx))
    batch["targets"] = targets
    return batch


def masked_coco_train_batch(batch_size: int = 8, seq_len: int = 128,
                            regions: int = 100, vdim: int = 2048,
                            vocab_size: int = 30522,
                            mask_probability: float = 0.15,
                            seed: int = 0) -> Dict[str, Any]:
    """``example_batch`` plus ``lm_label_ids`` [B, seq_len]: each valid
    text position is labelled with its token id with probability
    ``mask_probability`` (the masked_token processor's 0.15) and -1
    otherwise, drawn from ``np.random.RandomState(seed + 1)``."""
    batch = example_batch(batch_size, seq_len, regions, vdim, vocab_size,
                          seed)
    rng = np.random.RandomState(seed + 1)
    masked = (rng.rand(batch_size, seq_len) < mask_probability) & (
        batch["input_mask"] > 0)
    batch["lm_label_ids"] = np.where(masked, batch["input_ids"],
                                     -1).astype(np.int32)
    return batch


def vilbert_example_batch(batch_size: int = 8, seq_len: int = 128,
                          regions: int = 100, vdim: int = 2048,
                          vocab_size: int = 30522,
                          seed: int = 0) -> Dict[str, Any]:
    """``example_batch`` with ViLBERT's region geometry, drawn from
    ``np.random.RandomState(seed + 2)``: ``image_info_0.bbox`` [B, R, 5],
    boxes [x1, y1, x2, y2] in [0, 1] and their area, as
    ``transformer_bbox`` gives them, and ragged ``max_features`` from
    half the regions to all of them."""
    batch = example_batch(batch_size, seq_len, regions, vdim, vocab_size,
                          seed)
    rng = np.random.RandomState(seed + 2)
    xy = 0.5 * rng.rand(batch_size, regions, 2)
    wh = 0.5 * rng.rand(batch_size, regions, 2)
    batch["image_info_0"]["bbox"] = np.concatenate(
        [xy, xy + wh, wh.prod(-1, keepdims=True)], -1).astype(np.float32)
    batch["image_info_0"]["max_features"] = rng.randint(
        max(regions // 2, 1), regions + 1, batch_size).astype(np.int32)
    return batch


def vilbert_train_batch(batch_size: int = 8, seq_len: int = 128,
                        regions: int = 100, vdim: int = 2048,
                        vocab_size: int = 30522,
                        num_labels: int = VQA2_NUM_LABELS,
                        seed: int = 0) -> Dict[str, Any]:
    """``vilbert_example_batch`` plus ``vqa2_train_batch``'s targets."""
    batch = vilbert_example_batch(batch_size, seq_len, regions, vdim,
                                  vocab_size, seed)
    batch["targets"] = vqa2_train_batch(batch_size, 1, 1, 1, vocab_size,
                                        num_labels, seed)["targets"]
    return batch


def masked_vqa2_train_batch(batch_size: int = 8, seq_len: int = 128,
                            regions: int = 100, vdim: int = 2048,
                            vocab_size: int = 30522,
                            target_size: int = V_TARGET_SIZE,
                            mask_probability: float = 0.15,
                            seed: int = 0) -> Dict[str, Any]:
    """``vilbert_example_batch`` plus the masked-VQA2 fields, drawn from
    ``np.random.RandomState(seed + 3)``: ``lm_label_ids`` (each valid text
    position labelled with its token with ``mask_probability``, else -1),
    ``image_labels`` (each region 1 with ``mask_probability``, else -1,
    the masked_region processor's labels) and ``image_info_0.cls_prob``
    [B, R, target_size], the detector's class probabilities."""
    batch = vilbert_example_batch(batch_size, seq_len, regions, vdim,
                                  vocab_size, seed)
    rng = np.random.RandomState(seed + 3)
    masked = (rng.rand(batch_size, seq_len) < mask_probability) & (
        batch["input_mask"] > 0)
    batch["lm_label_ids"] = np.where(masked, batch["input_ids"],
                                     -1).astype(np.int32)
    batch["image_labels"] = np.where(
        rng.rand(batch_size, regions) < mask_probability, 1, -1).astype(
            np.int64)
    logits = 3.0 * rng.randn(batch_size, regions, target_size)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    batch["image_info_0"]["cls_prob"] = (
        probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    return batch


def vqa2_trainer(model, config, seed: int = 0, device: Any = "cuda",
                 meta: Optional[Dict[str, Any]] = None):
    """``(state, train_step)`` for ``model``, moved to ``device``, as
    ``MMFTrainer`` builds them: the model's weight-decay mask and lr
    multipliers as optimizer groups, the configured schedule as a
    ``LambdaLR``, clipping from ``training``, the model's losses, and
    the meta fields (VQA2's unless ``meta`` is given). Trains on the
    card unless the caller passes ``device="cpu"``; raises where there
    is no card."""
    import torch

    from mmf_tpu_torch.modules.optimizers import build_optimizer
    from mmf_tpu_torch.modules.schedulers import (
        build_lr_scheduler,
        build_scheduler,
    )
    from mmf_tpu_torch.trainers.core.train_state import (
        create_train_state,
        make_train_step,
    )
    from mmf_tpu_torch.utils.general import clip_gradients_config

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vqa2_trainer trains on the card by default, and this machine "
            "has no CUDA device; pass device='cpu' to train through the "
            "plain versions on the CPU"
        )
    if model.has_uninitialized_params():
        raise ValueError("a layer of the model waits for its input width: "
                         "call model.materialize(batch) first")
    # before the optimizer is built: its groups hold the moved parameters
    model = model.to(device)
    optimizer = build_optimizer(
        config, model, lr_multipliers=model.get_lr_multipliers(config),
        weight_decay_mask=model.get_weight_decay_mask(config),
    )
    lr_scheduler = build_lr_scheduler(optimizer, build_scheduler(config))
    step = make_train_step(
        model.build_losses(),
        update_frequency=config["training"].get("update_frequency", 1),
        max_grad_norm=clip_gradients_config(config),
        meta=VQA2_META if meta is None else meta,
    )
    return create_train_state(model, optimizer, seed, lr_scheduler), step


def masked_coco_trainer(model, config, seed: int = 0, device: Any = "cuda"):
    """``vqa2_trainer`` with the masked-COCO meta fields: pretraining has
    no ``targets``; the model returns its own ``losses``, which the train
    step prefers."""
    return vqa2_trainer(model, config, seed, device, MASKED_COCO_META)


def masked_vqa2_trainer(model, config, seed: int = 0, device: Any = "cuda"):
    """``vqa2_trainer`` with the masked-VQA2 meta fields (the model returns
    its own masked-LM and masked-region losses)."""
    return vqa2_trainer(model, config, seed, device, MASKED_VQA2_META)


def textvqa_m4c_config(opts: Optional[List[str]] = None):
    """The TextVQA M4C config merged over the root defaults, then
    ``TEXTVQA_M4C_OVERRIDES`` and ``opts`` applied."""
    return _project_config(TEXTVQA_M4C_CONFIG, "textvqa",
                           TEXTVQA_M4C_OVERRIDES + list(opts or []), "m4c")


def m4c_family_model(config,
                     model_overrides: Optional[Dict[str, Any]] = None):
    """The model an M4C family config names (M4C or the captioner), from
    its ``model_config`` with ``model_overrides`` on a copy; M4C's
    classifier is over ``M4C_ANSWERS`` answers unless the registry holds
    ``<dataset>_num_final_outputs`` (the dataset registers it)."""
    return _model(config["model"], config, model_overrides)


def textvqa_m4c_batch(batch_size: int = 128, seed: int = 0,
                      text_bert_vocab: int = 30522) -> Dict[str, Any]:
    """A batch in the TextVQA dataset's layout at M4C's widths, from a
    numpy seed: ragged questions, objects and OCR tokens (some with
    none), unit fasttext rows and sparse PHOC rows, boxes, teacher-forced
    indices over answers and OCR copies with their targets and loss
    mask."""
    rng = np.random.RandomState(seed)
    n_ocr = rng.randint(0, M4C_OCR + 1, batch_size)
    n_ocr[::8] = 0
    fasttext = rng.randn(batch_size, M4C_OCR, 300).astype(np.float32)
    phoc = (rng.rand(batch_size, M4C_OCR, 604) < 0.03).astype(np.float32)
    order = np.zeros((batch_size, M4C_OCR, M4C_OCR), np.float32)
    for i, n in enumerate(n_ocr):
        fasttext[i, n:] = 0
        phoc[i, n:] = 0
        order[i, :n, :n] = np.eye(n)
    steps = rng.randint(2, M4C_STEPS + 1, batch_size)
    prev = rng.randint(0, M4C_ANSWERS + M4C_OCR, (batch_size, M4C_STEPS))
    prev[:, 0] = 1
    targets = np.zeros((batch_size, M4C_STEPS, M4C_ANSWERS + M4C_OCR),
                       np.float32)
    targets[np.arange(batch_size)[:, None], np.arange(M4C_STEPS)[None],
            rng.randint(0, M4C_ANSWERS, (batch_size, M4C_STEPS))] = 1.0
    return {
        "text": rng.randint(1, text_bert_vocab,
                            (batch_size, M4C_TEXT)).astype(np.int64),
        "text_len": rng.randint(4, M4C_TEXT + 1, batch_size).astype(
            np.int64),
        "image_feature_0": rng.randn(batch_size, M4C_OBJECTS, 2048).astype(
            np.float32),
        "image_info_0": {"max_features": rng.randint(
            M4C_OBJECTS // 2, M4C_OBJECTS + 1, batch_size).astype(np.int64)},
        "obj_bbox_coordinates": rng.rand(batch_size, M4C_OBJECTS, 4).astype(
            np.float32),
        "context_feature_0": fasttext,
        "context_feature_1": phoc,
        "context_info_0": {"max_features": n_ocr.astype(np.int64)},
        "image_feature_1": rng.randn(batch_size, M4C_OBJECTS, 2048).astype(
            np.float32),
        "order_vectors": order,
        "ocr_bbox_coordinates": rng.rand(batch_size, M4C_OCR, 4).astype(
            np.float32),
        "train_prev_inds": prev.astype(np.int64),
        "train_loss_mask": (np.arange(M4C_STEPS)[None] < steps[:, None]
                            ).astype(np.float32),
        "targets": targets,
    }


def textvqa_trainer(model, config, seed: int = 0, device: Any = "cuda"):
    """``vqa2_trainer`` with the TextVQA meta fields."""
    return vqa2_trainer(model, config, seed, device, TEXTVQA_META)


def vl3_config(key: str, opts: Optional[List[str]] = None):
    """The ``VL3`` config of ``key`` merged over the root defaults, then
    its ``VL3_OVERRIDES`` and ``opts``; the schedule's
    ``num_training_steps`` is read as the number it names."""
    path, dataset, model = VL3[key]
    cfg = _project_config(path, dataset, VL3_OVERRIDES[key]
                          + list(opts or []), model)
    params = (cfg.get("scheduler", {}) or {}).get("params", {}) or {}
    if isinstance(params.get("num_training_steps"), str):
        params["num_training_steps"] = int(params["num_training_steps"])
    return cfg


def vl3_model(config, model_overrides: Optional[Dict[str, Any]] = None,
              example: Optional[Dict[str, Any]] = None):
    """The model of a ``VL3`` config, from its ``model_config`` with
    ``model_overrides`` on a copy; a layer flax sizes from the data
    (VinVL's region projection, UNITER's ``mrc`` decoder) is sized by
    ``example`` (a 1-sample ``vl3_batch`` of the model by default)."""
    model = _model(config["model"], config, model_overrides)
    if model.has_uninitialized_params():
        key = {"vinvl": "vinvl_vqa2", "uniter": "uniter_masked_coco"}[
            config["model"]]
        _sized(model, vl3_batch(key, 1, seq_len=2, regions=2)
               if example is None else example)
    return model


def vl3_batch(key: str, batch_size: int = 8,
              seq_len: Optional[int] = None,
              regions: Optional[int] = None, vdim: int = 2048,
              vocab_size: int = 30522, num_labels: int = VQA2_NUM_LABELS,
              seed: int = 0) -> Dict[str, Any]:
    """A batch of the ``VL3`` config ``key``'s layout at its widths
    (``VL3_SEQ`` tokens and ``VL3_REGIONS`` regions unless given), from a
    numpy seed: ``vilbert_train_batch``'s (boxes, ragged region counts,
    VQA2 targets) for the VQA2 configs, with two segments (caption and
    tags) for VinVL's; ``masked_vqa2_train_batch``'s (masked-LM labels,
    masked regions, class probabilities) for the pretraining configs,
    with ``is_correct`` -1 (neither masked dataset pairs a mismatch in
    these configs)."""
    seq_len = VL3_SEQ[key] if seq_len is None else seq_len
    regions = VL3_REGIONS.get(key, 100) if regions is None else regions
    if key in ("uniter_masked_coco", "lxmert_pretrain"):
        batch = masked_vqa2_train_batch(batch_size, seq_len, regions, vdim,
                                        vocab_size, seed=seed)
        batch["is_correct"] = np.full((batch_size,), -1, np.int64)
        return batch
    batch = vilbert_train_batch(batch_size, seq_len, regions, vdim,
                                vocab_size, num_labels, seed)
    if key == "vinvl_vqa2":
        batch["segment_ids"][:, seq_len // 2:] = 1
    return batch


def vl3_trainer(model, config, seed: int = 0, device: Any = "cuda"):
    """``vqa2_trainer`` with the meta fields of the config's dataset (a
    UNITER pretraining batch carries the task the trainer drew)."""
    return vqa2_trainer(model, config, seed, device,
                        {"dataset_name": config["datasets"],
                         "dataset_type": "train"})


def pythia_config(opts: Optional[List[str]] = None, model: str = "pythia"):
    """Pythia's VQA2 config over the root defaults for ``model`` (one of
    ``PYTHIA_MODELS``), then ``opts``."""
    return _project_config(PYTHIA_VQA2_CONFIG, "vqa2", opts, model)


def caption_model(config,
                  model_overrides: Optional[Dict[str, Any]] = None):
    """The model a BUTD or Pythia config names, from its
    ``model_config`` with ``model_overrides`` on a copy (the vocabulary
    and the answers from the registry's processors when a run registered
    them, else the config's ``text_vocab_size`` and ``num_labels``)."""
    return _model(config["model"], config, model_overrides)


def caption_trainer(model, config, seed: int = 0, device: Any = "cuda"):
    """``vqa2_trainer`` with the meta fields of the config's dataset
    (COCO's for BUTD, VQA2's for Pythia)."""
    return vqa2_trainer(model, config, seed, device,
                        {"dataset_name": config["datasets"],
                         "dataset_type": "train"})


def pythia2_config(key: str, opts: Optional[List[str]] = None):
    """The config of ``PYTHIA2[key]`` over the root defaults with its
    ``PYTHIA2_OVERRIDES``, then ``opts``."""
    path, dataset, model = PYTHIA2[key]
    return _project_config(path, dataset, PYTHIA2_OVERRIDES[key] +
                           list(opts or []), model)


def pythia2_model(config,
                  model_overrides: Optional[Dict[str, Any]] = None):
    """The model a ``PYTHIA2`` config names, from its ``model_config``
    with ``model_overrides`` on a copy."""
    return _model(config["model"], config, model_overrides)


def mmf_bert_batch(batch_size: int = 8, seq_len: int = MMF_BERT_SEQ,
                   regions: int = PYTHIA_REGIONS, feature_dim: int = 2048,
                   vocab_size: int = 30522, num_labels: int = VQA2_NUM_LABELS,
                   pretraining: bool = False,
                   seed: int = 0) -> Dict[str, Any]:
    """An mmf_bert batch as ``bert_tokenizer`` and the VQA2 dataset give
    it, drawn from ``np.random.RandomState(seed)``: [CLS] question [SEP]
    of 6 to ``seq_len`` tokens, padded and masked, zero segments, region
    features [B, regions, feature_dim], and VQA2 soft ``targets``; with
    ``pretraining``, 15% of the real tokens labelled (``lm_label_ids``,
    -1 elsewhere) and ``is_correct``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1000, vocab_size, (batch_size, seq_len))
    lengths = rng.randint(min(6, seq_len), seq_len + 1, batch_size)
    mask = (np.arange(seq_len)[None] < lengths[:, None]).astype(np.int64)
    ids[:, 0] = 101
    ids[np.arange(batch_size), lengths - 1] = 102
    ids = (ids * mask).astype(np.int64)
    batch = {"input_ids": ids, "input_mask": mask,
             "segment_ids": np.zeros_like(ids),
             "image_feature_0": rng.randn(batch_size, regions,
                                          feature_dim).astype(np.float32)}
    if pretraining:
        labels = np.where((rng.rand(batch_size, seq_len) < 0.15) & (
            mask == 1), ids, -1)
        labels[:, 1] = ids[:, 1]  # every row holds a label
        batch["lm_label_ids"] = labels.astype(np.int64)
        batch["is_correct"] = rng.randint(0, 2, batch_size).astype(np.int64)
    else:
        targets = np.zeros((batch_size, num_labels), np.float32)
        for i in range(batch_size):
            targets[i, rng.randint(num_labels, size=3)] = [1.0, 0.6, 0.3]
        batch["targets"] = targets
    return batch


def lorra_ban_model(config):
    """The model a ``LORRA_BAN`` config names, from its ``model_config``;
    CNN-LSTM's classifier is sized by a 224 px Hateful Memes batch (the
    configs' images)."""
    model = _model(config["model"], config, None)
    if model.has_uninitialized_params():
        _sized(model, hateful_memes_train_batch(1, seq_len=6))
    return model


def text_vocab_size(config) -> int:
    """The size of the first dataset's text vocabulary as its text
    processor reads it (a ``vocab`` processor's ``get_vocab_size``), from
    the dataset's ``data_dir``. CNN-LSTM's Hateful Memes run gives it as
    ``model_config.cnn_lstm.text_vocab_size``: the Hateful Memes builder
    registers no vocabulary, and the model's default of 100 words is
    smaller than any real one."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    dataset = str(config["datasets"]).split(",")[0].strip()
    ds = config["dataset_config"][dataset]
    tp = ds["processors"]["text_processor"]
    return registry.get_processor_class(tp["type"])(
        tp["params"], data_dir=ds["data_dir"]).get_vocab_size()
