"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line starting with "phase"; any failure raises and
the script exits non-zero without a result line):

1. build    - the card's name and power limit, torch's version, and the
              build of every kernel on the serving and training paths
              from this checkout's sources, all started together: nvcc
              for the CUDA flash-attention forward (K1) and backward (K2,
              K3), the int8 GEMM (K5) and the LayerNorm backward
              (K4-bwd), Triton's JIT for the LayerNorm (K4), with build
              times, and the registers and spills of the wgmma kernels
              (K1, K2, K3, K5), the f32 K1, K2 and K3 (split-TF32 on
              mma.sync), with their shared memory, and of K4-bwd's, and
              ptxas's C75xx notes (a serialised wgmma shows there); the
              dynamic shared memory and blocks an SM
              (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of every
              bf16 K1 and K2 block the launchers take.
2. kernels  - each kernel against its plain PyTorch version on the card
              at the main paths' shapes, with stated tolerances, and both
              timed (best of several runs): K1 in its inference, stats
              and raw-stats forms (the raw states of the two kv halves
              merged against K1 over the whole kv), K2 and K3 (also
              against autograd through mha_reference; two calls
              bit-equal; B=64 S=228, B=8 Sq=128 Skv=100 and a long-kv
              case B=8 S=1024), all five by device_ms with CUDA events
              over back-to-back calls beside them, and the wrappers' host
              time per call; K4 in its four forms (bf16, f32, with and
              without the residual) at [14592, 768] and bf16 at bucket
              32's [7296, 768], and K4-bwd in the four forms at [14592,
              768] (two calls bit-equal), by device_ms over input sets
              rotated so that every call reads device memory, with the
              wrappers' host time; and K5 at the MMBT trunk's and
              pooler's shapes (M = 131 and 1) and VisualBERT's bucket 32
              (M = 7296), by device_ms, with its wrapper's host time.
              F.scaled_dot_product_attention (forward, forward with the
              rows' logsumexp, backward; by device_ms), F.layer_norm
              (forward and backward, by device_ms) and torch._int_mm are
              timed beside them for information; each
              kernel's bound (bytes over the memory rate, operations over
              the peak rate) is computed from its shapes.
3. serving  - VisualBERT-base at full width (12 x 768, 12 heads, 3129
              answers, bf16 compute; weights from a seeded
              torch.Generator) behind ServingEngine(max_batch_size=32) and
              ServingServer on 127.0.0.1, port 0. Concurrent /v1/predict
              requests in the VQA2 example layout; answers checked for
              status, shape and finiteness; the kernels' launch counts
              checked against the model's structure; one request's scores
              checked against the same weights' f32 forward on the CPU
              (plain versions); samples/s at bucket 32, request latency,
              and the bucket-32 forward's time (CUDA events) and device
              time by kind of kernel (torch.profiler).
4. training - VisualBERT-base at full width (f32 parameters, bf16
              compute, hidden dropout 0.1 from the step's generator,
              attention-probability dropout 0) trained with the VQA2
              config (AdamW lr 5e-5, BERT no-decay groups, warmup_cosine
              with its warmup cut to 2 updates, logit_bce) on B=64 VQA2
              batches: 1 warm-up and 6 timed steps, finite losses, exact
              launch counts per step (K4-bwd included), ms per step,
              samples/s, peak memory and device time by kind of kernel;
              then 3 steps through the kernels against
              3 steps through the plain versions from the same weights and
              batch at dropout 0, with each side's launches counted (the
              losses, the last after an update at lr > 0; per-parameter
              first-step gradient cosine and norm-relative error; update
              cosine; all against stated bounds).
5. mmbt     - MMBT-grid at full width (ResNet-152 at 224 px, 12 x 768,
              12 heads, 2 labels, bf16 compute, seeded weights) served at
              batch 1 through ServingEngine(max_batch_size=1) in bf16, with
              quant: int8 from the config, and with MMF_TPU_QUANT=int8 (the
              route mmf_serve takes): exact launch counts per forward,
              latency p50 and p95 over 50 calls (host clock, outputs on
              the host), device time per forward by kind of kernel; pooled
              features and scores against the f32 CPU forward (bf16) and
              the int8 CPU forward through the plain versions (int8), and
              the ResNet features under cuDNN's TF32 default against f32.
6. vb-int8  - the serving phase's VisualBERT-base with quant: int8 at
              bucket 32: K5 launches per forward, forward time beside
              bf16's, and one sample against the int8 CPU forward; K5 at
              every shape the forward launches it at (recorded from a
              forward), against its plain version, by device_ms beside
              torch._int_mm, with launches per shape and the K5 total per
              forward.
7. pretrain - VisualBERT-base masked-LM pretraining at full width with
              the masked_coco config (AdamW lr 5e-5, warmup_linear with
              its warmup cut to 2 updates, hidden dropout 0.1,
              attention-probability dropout 0) on B=64 batches with about
              15% of the text positions labelled: 1 warm-up and 4 timed
              steps, finite losses, exact launches per step, ms per step,
              samples/s, peak memory and device time by kind of kernel
              (the MLM decoder's GEMMs and the f32 log_softmax on their
              own); 2 steps through the kernels against 2 through the
              plain versions at dropout 0 (the training phase's bounds);
              the checkpoint round trip (Checkpoint.save at update 2, a
              third step; a fresh model, optimizer and schedule resumed
              from current.ckpt: parameters, optimizer state and step
              bit-equal, the same third loss; file size, save and load
              times); one MMBT-grid pretraining step at B=8 through the
              kernels against the plain versions, with exact launches.
8. serve-ckpt - the training phase's VisualBERT-base written by
              Checkpoint.finalize with its config.yaml, served by
              mmf_serve (cli/serve.py build_server, port 0): 32
              concurrent /v1/predict requests checked for status, shape
              and finiteness, exact launches per forward, each answer
              against a ServingEngine on the same weights in memory
              (within batching noise; the served engine bit-equal to it
              at the same bucket), the time from build_server
              to the first answer; then with quant=int8: K5 launches per
              bucket-32 forward and one answer against the int8 CPU
              forward.

9. mmf-run  - mmf_run (cli/run.py's run(opts), in the process) trains,
              evaluates and predicts VisualBERT-base at full width with
              the VQA2 config on a synthetic VQA2 layout written from a
              seed (tests/torch_vqa2_layout.py: MMF's imdb files, 640 /
              128 / 64 questions over 160 images, [100, 2048] f32
              region features a file, 3129 answers, a 30522-entry
              WordPiece vocabulary): B=64, 4 loader workers, pinned
              batches, 8 updates, evaluation and checkpoints every 4,
              then the val and test prediction reports. Checks: 8
              updates with finite losses, exact launches per update and
              per eval forward, the losses equal to the train step's
              (flagship.vqa2_trainer) on the same initial weights and
              the loader's same batches, 128 val samples scored with
              vqa_accuracy in [0, 1], the run folder's checkpoints and
              one report row a test question. Printed: the CLI's train
              samples/s beside the training phase's, the loader's
              batches/s alone, the host split of an update (the
              profiling mixin's points), device time per update and the
              idle share (torch.profiler, 2 updates), eval samples/s,
              the time to the first update and peak memory.
10. vilbert-kernels - K1, K1-stats, K2 and K3 at ViLBERT-base's attention
              shapes (bf16, B=64, 8 heads of 128: image self-attention
              100x100, text queries over 100 regions, region queries
              over 128 tokens, a padding mask over the keys; and the
              text queries at a served bucket of 8) against their plain
              versions, timed beside SDPA and the bound.
11. vilbert-serving - ViLBERT-base from the VQA2 project config (with
              flagship.VILBERT_VQA2_OVERRIDES) behind ServingEngine at
              buckets 1-32: exact launches, one sample against the f32
              CPU forward, the bucket-32 forward and its device time.
12. vilbert-training - 1 warm-up and 4 timed steps at B=64 (exact
              launches, ms and device time a step, peak memory); 3 steps
              through the kernels against 3 through the plain versions
              (the training phase's bounds, the norm-relative one on the
              parameters whose plain bf16 gradient is within it of an
              f32 step's; on the others the kernels at most 1.5x as far
              from the f32 gradient as the plain versions).
13. vilbert-mmf-run - mmf_run finetunes ViLBERT-base on VQA2 (8 updates,
              one evaluation and checkpoint, the reports) and pretrains
              it on masked VQA2 (3 updates), each run's losses equal to
              the train step's on the same batches; then mmf_serve on
              the finetuned folder against an in-memory engine.
14. vilt-kernels - K1, K1-stats, K1-raw, K2 and K3 in f32 at ViLT's
              [64, 12, 617, 64] (40 text tokens masked by length, 577
              image tokens; K1's three forms and K2/K3 bit-equal across
              two calls), K4 and K4-bwd in f32 without the residual at
              [39488, 768], each against its plain version and timed
              beside SDPA / F.layer_norm, with host time and the bound
              (split-TF32 operations over the TF32 peak, and the same work
              over the FP32 non-tensor peak beside it).
15. vilt-serving - ViLT-base (f32, projects/vilt/configs/vqa2/defaults.yaml)
              behind ServingEngine at buckets 1-32: exact launches (12 K1
              and 27 K4 a forward), one sample against the f32 CPU
              forward, the bucket-32 forward and its device time.
16. vilt-training - the VQA2 finetuning step at B=64 (attention-
              probability dropout cut to 0): exact launches, ms, device
              time by kind and peak memory; 3 steps through the kernels
              against 3 through the plain versions; then the MLM + ITM
              pretraining step (masked_coco/pretrain.yaml, the second
              masked encoder pass) at B=32, the same measurements and 2
              compared steps.
17. vilt-run - mmf_run finetunes ViLT-base on VQA2 over raw images (the
              synthetic raw-image layout: PNG content decoded and resized
              by the loader), its losses equal to the train step's; the
              loader alone; mmf_serve on the run's folder.
18. mmft-kernels - K1, K1-stats, K2 and K3 in bf16 at MMFT's
              [64, 12, 114, 64] and [32, 12, 114, 64] (every token
              valid, as its VQA2 inputs give) against their plain
              versions, timed beside SDPA.
19. mmft-run - mmf_run trains MMFTransformer (bf16, 14 + 100 tokens) on
              VQA2 features with flagship.MMFT_VQA2_OVERRIDES, its losses
              equal to the train step's; 3 steps from the run's initial
              weights on its first batch through the kernels against 3
              through the plain versions; the bucket-32 forward through
              both; mmf_serve on the run's folder.
20. hm-kernels - K1 (its three forms), K2 and K3 at Hateful Memes' shapes:
              MMBT's [32, 12, 131, 64] bf16 (3 modal tokens and 128 text
              tokens masked by length) and the baselines' f32 BERT at
              [64, 12, 128, 64], against their plain versions, timed
              beside SDPA with host time and the bound.
21. hm-mmbt-run - mmf_run trains MMBT on Hateful Memes from
              projects/hateful_memes/configs/mmbt/defaults.yaml over raw
              images (tests/torch_hm_layout.py: PNG memes of 300-800 px;
              ResNet-152 at 224 px in training mode, its BatchNorm
              statistics updated; bf16 trunk, B=32): 8 updates, one
              evaluation (accuracy, binary_f1, roc_auc), csv predictions
              (id,proba,label); exact launches per update and eval
              forward; samples/s, the loader alone, the host split, device
              time by kind and the idle share, peak memory; 3 steps from
              the run's initial weights through the kernels against the
              plain versions at attention dropout 0, the ResNet's running
              statistics included.
22. hm-baselines - concat_bert, late_fusion, concat_bow, unimodal_text
              (text.yaml and bert.yaml) and unimodal_image through mmf_run
              from their project configs at their batch sizes: 2 updates,
              one evaluation, csv predictions, exact launches (none for
              the models without BERT); concat_bert's bucket-32 forward
              against the f32 CPU forward of the same weights.
23. m4c-kernels - K1 (its three forms), K2 and K3 in f32 at M4C's four
              attention shapes (B=128, 12 heads of 64, its -10000 biases):
              TextBert [128, 12, 20, 64], the training pass [128, 12, 182,
              64] with the per-row prefix-LM bias [B, 1, 182, 182], the
              prefill [128, 12, 170, 64] and the cached decode (12 queries
              over 182 keys), against their plain versions, timed beside
              SDPA with host time and the bound; K1 over the cached prefix
              K/V against K1 over the whole sequence's last 12 rows.
24. m4c-run - mmf_run trains M4C at full width on TextVQA from
              projects/m4c/configs/textvqa/defaults.yaml with
              flagship.TEXTVQA_M4C_OVERRIDES (tests/torch_textvqa_layout.py:
              seeded imdb files, two LMDBs of 2048-wide object and OCR
              features written by the port's core, a 5000-word answer
              vocabulary, the seeded fasttext stand-in; B=128, 8 updates),
              evaluates with the greedy decode and textvqa_accuracy, and
              predicts json answers: exact launches (22 K4 and K4-bwd an
              update; 55 K1 and 151 K4 a greedy-decode forward), the
              reports' rows, samples/s, the loader alone, the host split,
              device time by kind and the idle share, peak memory, the
              decode's ms a batch; the cached decode against 12 full
              passes, step by step; 3 steps through the kernels against
              the plain versions at dropout 0; the LMDB and PHOC libraries
              built from the checkout (PHOC's C against its python twin).
25. m4c-family - mmf_run at full width for the rest of the M4C family
              (flagship.M4C_FAMILY with its overrides; synthetic layouts
              of 256 / 128 / 128 samples over 48 images each, B=128): the
              M4C captioner on TextCaps (4 updates; the <unk> column at
              -1e10 in every decoded step, textcaps_bleu4, caption
              predictions; its update's and the greedy decode's device
              time and idle share; 2 steps through the kernels against
              the plain versions at dropout 0 on the run's first batch
              without and with <unk> targets), M4C on ST-VQA (stvqa_anls,
              stvqa_accuracy), OCR-VQA (ocrvqa_accuracy) and TextVQA
              jointly with ST-VQA (size_proportional): 2 updates each;
              exact launches per update and greedy-decode forward, the
              reports' rows, the edit-distance library built from the
              checkout.
26. m4c-serve - mmf_serve (cli/serve.py build_server) on m4c-run's
              TextVQA M4C folder and m4c-family's captioner folder, as a
              fresh process holds them: the datasets' val samples through
              the served engine's predict_many at buckets 1-32 (JAX's
              HTTP path cannot take M4C's nested fields), exact launches
              a batch (55 K1, 151 K4), the answers against a CPU engine
              on the same checkpoint (within 1e-4 of the largest score,
              up to a near-tie's argmax flip), per-bucket ms beside device
              time, batch-1 p50 / p95; K1 at the served decode's shapes
              ([b, 12, 12, 182] at buckets 1, 8, 32) against its plain
              version, timed beside SDPA with the bound and host us.
27. vl3-kernels - K1 (its three forms), K2 and K3 in f32 at UNITER's
              [64, 12, 228, 64], VinVL's [64, 12, 170, 64] and LXMERT's
              100x100, 128x100, 100x128, 20x36 and 36x20, and K4 and
              K4-bwd in f32 with the residual at their trunks' rows,
              against their plain versions, timed beside SDPA and
              F.layer_norm with the bounds and host us.
28. vl3-runs - mmf_run at full width (B=64, 4 loader workers, f32) of
              the five flagship.VL3 configs with their overrides on a
              synthetic VQA2 and COCO layout: UNITER and LXMERT finetuned
              on VQA2 and VinVL (3 updates; val and test predicted, val
              evaluated by the run's trainer), UNITER
              pretrained on masked COCO (4 updates, each of mlm, itm,
              mrc, mrfr drawn once) and LXMERT on masked VQA2 (20 tokens,
              36 regions, 2 updates): exact launches (training attention
              plain at the configs' dropout 0.1), losses equal to the
              train step's on the same batches; 3 steps through the
              kernels against the plain versions for each config, the
              kernels' steps' device time and their LayerNorm backward
              (K4-bwd) by torch.profiler; mmf_serve of the three
              finetuned folders, 32 requests against a CPU engine on the
              same weights (1e-4 of the largest score).
29. butd-run - BUTD at full width (B=256, 100 regions x 2048, LSTMs and
              attention 1024, words 300, a 9,491-word COCO vocabulary,
              52 steps, f32) through mmf_run on a synthetic COCO layout:
              the defaults config (flagship.BUTD_OVERRIDES) trains 3
              updates on the reference's targets (text[:, 1:]) and
              evaluates BLEU-4; beam_search.yaml (k = 5) and
              nucleus_sampling.yaml evaluate the trained weights and
              write {image_id, caption} rows; the step's and each
              decode's device time by kind, wall time, idle share and
              peak memory; teacher-forced scores and greedy captions
              against the CPU; the beam config's folder served by
              ServingEngine.from_checkpoint at batch 1 (p50 / p95) and
              bucket 32, its captions against a CPU engine's. No
              hand-written kernel runs on this path (launches 0).
30. pythia-run - Pythia at full width (B=512, combine and classifier
              5000 wide, the attention text embedding 1024 wide, 3129
              answers, f32) through mmf_run on the synthetic VQA2
              layout: 3 updates, val accuracy, prediction rows, the
              step's device time by kind, the card against the CPU,
              served at bucket 32 from the run's folder;
              pythia_question_only and pythia_image_only one forward
              each against the CPU. Launches 0.
31. m4c-coco-joint - the M4C captioner trained jointly on TextCaps and
              COCO (flagship.JOINT_COCO, B=128, full width) through
              mmf_run on write_joint_coco_layout: exact K4 and K4-bwd
              launches an update and K1 and K4 in each greedy-decode
              forward, BLEU-4, caption rows, and the first batch through
              the kernels (K1-stats, K2, K3, K4, K4-bwd) against the
              plain versions.
32. multihead-run - Pythia's multihead (B=512: the 2048-wide question
              over 100 regions in 8 heads of 256, the wide f32 kernels)
              and Pythia on Visual Genome (B=128) through mmf_run on the
              caption layout: exact launches (multihead: 1 K1-stats, K2
              and K3 an update, 1 K1 an evaluation forward; Pythia none),
              the losses against the train step, multihead's step device
              time by kind, card against CPU, one served bucket of 32 of
              each from its run's folder. Runs right after pythia-run.
32b. lorra-ban-run - LoRRA (B=512: two feature sets and the OCR
              context, the soft copy's answers) and BAN (B=512: a GRU of
              1280, 4 bilinear glimpses over 100 regions) on VQA2 and
              LoRRA on VizWiz (one update of 128, evaluated: prediction
              rows with OCR copies) through mmf_run on the caption
              layout: no kernel launched, the losses against the train
              step, the step's device time by kind, wall, idle share and
              peak memory, card against CPU, bucket 32 served from the
              run's folder against the CPU forward.
33. pythia2-kernels - K1 (inference and stats forms), K2 and K3 in f32
              at mmf_bert's shapes (B=512, 8 heads of 96: the text
              self-attention over 128 tokens with its key padding, the
              regions' intra-attention over 100, the text over the
              regions) and multihead's [512, 8, 1 x 100, 256], against
              the plain versions, by device_ms beside SDPA (its backend
              named), with the bound and host us a call; the wide
              kernels' edges at D=256 (Sq 1-17 x Skv 1-130).
34. mmf-bert-run - mmf_bert at full width through mmf_run: VQA2
              finetuning at B=512 (exact launches an update and a
              prediction forward; the training attention is plain at the
              config's dropout 0.1), served at bucket 32 from its folder,
              masked-VQA2 pretraining at B=480 (flagship.
              PYTHIA2_OVERRIDES), the losses against the train step, and
              3 steps of each head through the kernels against the plain
              versions at dropout 0 (3 K1-stats, K2, K3 and 2 K4, K4-bwd
              a step).
34b. lorra-textvqa, cnn-lstm-run - LoRRA on TextVQA (B=128, the
              soft-copy answers of flagship.LORRA_BAN_OVERRIDES) and
              CNN-LSTM on Hateful Memes (B=480, 224 px memes, cuDNN's
              convolutions in f32) through mmf_run on layouts of their
              own, with lorra-ban-run's checks.
35. ln-bwd-shapes - K4-bwd at every (rows, hidden, dtype, residual) at
              which the optimizer steps of phases 1-34 ran it (recorded
              as they ran: LnBwdRecord), with the phases' steps and calls
              a step: against its plain backward within the kernels
              phase's tolerances, bit-equal across two calls, by
              device_ms over rotating input sets beside F.layer_norm's
              backward, with the byte bound and host us a call; and K4,
              the forward, at the same shape beside F.layer_norm.

Then one JSON line describing the kernels, the nvidia-smi line, and the
last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import collections
import contextlib
import copy
import ctypes
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
import warnings

import numpy as np
import torch

# the loader's worker processes import this file again as __mp_main__:
# they never ask for the card
if __name__ == "__main__" and not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this run "
             "needs an NVIDIA card")

import torch.nn.functional as F  # noqa: E402

from mmf_tpu_torch.modules import transformer as T  # noqa: E402
from mmf_tpu_torch.ops import attention as A  # noqa: E402
from mmf_tpu_torch.ops import layernorm as L  # noqa: E402
from mmf_tpu_torch.common.sample import SampleList  # noqa: E402
from mmf_tpu_torch.ops import quant as Q  # noqa: E402
from mmf_tpu_torch.serving import ServingEngine  # noqa: E402
from mmf_tpu_torch.serving import engine as engine_lib  # noqa: E402
from mmf_tpu_torch.serving.server import ServingServer  # noqa: E402
from mmf_tpu_torch.trainers.callbacks.base import Callback  # noqa: E402
from mmf_tpu_torch.trainers.core import train_state  # noqa: E402
from mmf_tpu_torch.trainers.core.train_state import StepTrainer  # noqa: E402
from mmf_tpu_torch.utils import flagship  # noqa: E402
from mmf_tpu_torch.utils.checkpoint import Checkpoint  # noqa: E402

DEV = torch.device("cuda")
SEQ, REGIONS, VDIM, HEADS, HEAD_DIM, HIDDEN = 128, 100, 2048, 12, 64, 768
S = SEQ + REGIONS  # 228 tokens per sample
# f32: same algorithm, other summation order; bf16: outputs rounded to
# bf16, one ulp is 2^-8 relative
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
# served bf16 scores vs the f32 CPU forward on the same weights: twelve
# layers of bf16 activations; random-init scores have |s| ~ 0.5-2
SERVE_ATOL = 0.1
SERVE_MIN_COSINE = 0.999
# served bf16 scores vs the same kernels and weights in another batch:
# rows padded into another bucket, or put at another place in it, may take
# another summation order in a GEMM and flip a bf16 rounding, which the
# later layers carry on. Bound in bf16 ulps at the largest score's binade
SERVE_BATCH_ULPS = 4
SERVE_BATCH_MIN_COSINE = 0.99999
N_REQUESTS = 8
# backward kernels: max abs error over the largest entry of the plain
# version's gradient. f32: same formulas, other summation order, the
# kernels' products in split-TF32 (inputs kept to ~21 bits; the plain
# version's TF32 off); bf16: p and ds rounded to bf16 before the
# tensor-core products and the gradients stored in bf16 (one ulp is 2^-8
# relative). Against autograd through mha_reference (other formulas,
# other roundings) half as much again
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# stats form: m and l are f32 sums of the same products in another order
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
# raw-stats form's f32 accumulator, relative to its largest entry: f32 the
# same products in another order; bf16 probabilities rounded to bf16 at
# each tile's running max (the plain version rounds them at the final max)
RAW_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LONG_S = 1024  # the long-kv case: B=8, Sq = Skv = 1024
# K4-bwd against its plain backward, relative to the largest entry: dx in
# f32 the same formulas in other summation orders, in bf16 and f16 rounded
# to their dtype (one ulp is 2^-8 and 2^-11 relative); dscale and dbias
# are f32 sums of the same f32 products in every dtype
LN_DX_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}
LN_PARAM_REL = 1e-5
# LayerNorm timings rotate over input sets that together hold at least
# this many bytes of what a call reads (L2 holds 50 MB), cut from a pool
# of LN_POOL [14592, 768] tensors each of x, residual and dy
ROTATE_BYTES = 150e6
LN_POOL = 7
SERVE_B = 32  # the serving phase's bucket
# the requests mmf_serve takes from a run's folder (one bucket): each is
# MBs of JSON, whose encoding and parsing dominate the phase's time
SERVED_REQUESTS = 8
TRAIN_B, TRAIN_STEPS = 64, 6
# training step through the kernels vs through the plain versions, same
# weights and batch, dropout 0, bf16 compute: both round activations to
# bf16 at the same places; the kernels also round p and ds to bf16
TRAIN_LOSS_RTOL = 2e-3
TRAIN_MIN_GRAD_COSINE = 0.99
# per parameter: a missing or doubled scale in a backward kernel moves it
# to ~1 or beyond
TRAIN_MAX_GRAD_REL = 0.05
TRAIN_MIN_UPDATE_COSINE = 0.9
# steps of the kernel-vs-plain comparison: warmup_cosine runs update 0 at
# lr 0, so the third loss is the first one after a real update
COMPARED_STEPS = 3
# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the peak rate of
# the unit that runs them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
# f32 at f32 accuracy on the tensor cores: split-TF32 runs each f32
# product as three TF32 products (hi hi, hi lo, lo hi) at the TF32 rate
TF32_FLOPS, SPLIT_TF32_PRODUCTS = 495e12, 3
# K5 (int8 GEMM) shapes (M, K, N) on the main paths, with their launches
# per forward: the MMBT trunk at batch 1 (131 tokens; Q, K, V, O, FFN in,
# FFN out in 12 layers), its pooler (M = 1) and VisualBERT at bucket 32
# (32 x 228 tokens)
K5_MMBT = {(131, 768, 768): 48, (131, 768, 3072): 12, (131, 3072, 768): 12,
           (1, 768, 768): 1}
K5_VB = (7296, 768, 3072)
K5_HEADLINE = (131, 768, 3072)  # the row reported in the kernels line
# MMBT-grid at batch 1: 3 modal tokens (start, one pooled ResNet cell,
# end) and 128 text tokens; per forward 12 attention calls, 26 LayerNorms
# (24 residual, the embedding LayerNorm on the modal and the text span)
# and under int8 73 K5 launches (72 trunk projections and the pooler)
MMBT_PER_FORWARD = {"flash_attention_fwd": 12, "layer_norm": 26}
MMBT_K5 = 73
# VisualBERT under int8: its visual projection, 72 trunk projections, the
# pooler and the head transform (the answer logits stay a plain Dense)
VB_K5 = 75
LATENCY_CALLS = 50
# masked-LM pretraining (VisualBERT-base, the masked_coco config) at
# TRAIN_B: timed steps, and steps of its kernel-vs-plain comparison
# (warmup_linear runs update 0 at lr 0: both at the initial weights)
VOCAB = 30522
PRETRAIN_STEPS, PRETRAIN_COMPARED = 4, 2
# a resumed step's loss against the uninterrupted one: the same weights,
# optimizer state, step (so the same dropout masks) and kernels
RESUME_LOSS_RTOL = 1e-6
MMBT_PRETRAIN_B = 8
MMBT_PRETRAIN_META = {"dataset_name": "hateful_memes", "dataset_type": "train"}
# served outputs against a CPU forward of the same weights (plain
# versions): max abs error of scores and pooled features (|f| <= 1, tanh),
# and the pooled features' cosine. bf16 vs f32: twelve layers of bf16
# activations and TF32 convolutions. int8 vs int8: the same quantisation;
# bf16 and TF32 roundings that differ between card and CPU may flip a
# rounding at a .5 boundary, moving an activation by one step (1/127 of
# its row's largest entry)
MMBT_ATOL = 0.1
MMBT_MIN_COSINE = 0.999
# ResNet-152 features under cuDNN's TF32 default against f32 on the CPU,
# relative to the largest feature: a 10-bit mantissa in each of 155
# convolutions
MMBT_TF32_REL = 0.05


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, repeats=5) -> float:
    """Best of ``repeats`` runs of ``iters`` launches, CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def host_us(fn, iters=50) -> float:
    """Host time per call in microseconds: the wrapper's checks, ctypes
    call and launch (the backward's TMA descriptors included), without
    waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return us


def device_ms(fn, iters=20, repeats=5) -> float:
    """Device time per call, without the host's cost of launching it:
    a spin kernel (torch.cuda._sleep) holds the stream while ``iters``
    calls are queued behind it, so the CUDA events around the calls see
    them back to back. The spin is lengthened until it outlasts the
    queueing. Best of ``repeats``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 6)
    end.record()
    end.synchronize()
    cycles_per_ms = 1e6 / start.elapsed_time(end)
    spin_ms, best, done = 1.0, float("inf"), 0
    for _ in range(repeats + 10):
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if queued_ms > 0.5 * spin_ms:  # the spin may have ended first
            spin_ms = 4.0 * queued_ms
            continue
        best = min(best, start.elapsed_time(end) / iters)
        done += 1
        if done == repeats:
            return best
    raise RuntimeError("device_ms: the spin never outlasted the queueing")


def check(ok, what):
    """A failed check ends the run (an assert would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_err(got, want, dtype) -> float:
    torch.testing.assert_close(got, want, **TOL[dtype])
    return float((got.float() - want.float()).abs().max())


KERNELS = {  # name in the report -> the wrapper that counts launches
    "flash_attention_fwd": A.flash_attention,
    "flash_attention_fwd_stats": A.flash_attention_with_stats,
    "flash_attention_fwd_raw": A.flash_attention_block,
    "flash_attention_bwd_dq": A.flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": A.flash_attention_bwd_dkv,
    "layer_norm": L.layer_norm_kernel,
    "layer_norm_bwd": L.layer_norm_backward_kernel,
    "int8_dequant_gemm": Q.dequant_gemm,
}
ZERO_COUNTS = {name: 0 for name in KERNELS}


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def _short_name(mangled):
    """A kernel's short name with its template arguments, e.g.
    ``flash_fwd_sm90_kernel<1,0,3>`` or ``int8_gemm_sm90_kernel<1,64,4,4,
    bf16,3>``."""
    short = re.search(r"\d((?:bwd_d|flash_fwd_|int8_|ln_bwd)\w*?_kernel)"
                      r"(?:(I.*?E)?Ev|E)", mangled)
    if short is None:
        return mangled[-40:]
    kinds = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    args = [kinds.get(t, n)
            for n, t in re.findall(r"Li(\d+)E|(13__nv_bfloat16|6__half|f)",
                                   short.group(2) or "")]
    return short.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(log):
    """[(kernel, registers, spill store bytes, static smem bytes)] from
    nvcc's -Xptxas -v output, kernels demangled to their short names."""
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            name = _short_name(m.group(1))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and name is not None:
            out.append((name, int(m.group(1)), spill, int(m.group(2) or 0)))
            name = None
    return out


# -- phase 1 ---------------------------------------------------------------
def _ln_build():
    x = torch.zeros(2, HIDDEN, device=DEV, dtype=torch.bfloat16)
    w = torch.ones(HIDDEN, device=DEV)
    for residual in (None, x):  # both specialisations of the kernel
        for dtype in (torch.bfloat16, torch.float32):
            L.layer_norm_kernel(x.to(dtype), w, w * 0,
                                None if residual is None
                                else residual.to(dtype))
    torch.cuda.synchronize()


def phase_build(card):
    """Every kernel's build, started together: one nvcc per CUDA source
    and Triton's JIT, each in its own thread."""
    from mmf_tpu_torch.utils.native import lmdb_shim
    from mmf_tpu_torch.utils.phoc import build_phoc

    jobs = {"flash_attention_fwd": A.build_flash_attention,
            "flash_attention_bwd": A.build_flash_attention_bwd,
            "int8_gemm": Q.build_int8_gemm,
            "layer_norm_bwd": L.build_layer_norm_bwd,
            "layer_norm": _ln_build,
            # the host libraries of TextVQA's loader (C++ and C)
            "lmdb_core": lmdb_shim.library, "phoc": build_phoc.library}
    done, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            done[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=item)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    parts, reports = [], {}
    for name in ("flash_attention_fwd", "flash_attention_bwd", "int8_gemm",
                 "layer_norm_bwd"):
        info, _ = done[name]
        kernels = ptxas_report(info["ptxas"])
        notes = re.findall(r"\((C75\d\d)\)", info["ptxas"])
        parts.append(f"{name} nvcc {info['build_s']:.1f}s ({len(kernels)} "
                     f"kernels, {sum(k[2] > 0 for k in kernels)} with "
                     "spills; ptxas notes " + (", ".join(
                         f"{c} x{notes.count(c)}" for c in sorted(set(
                             notes))) or "none") + ")")
        reports[name] = [k for k in kernels if any(
            tag in k[0] for tag in ("sm90", "tf32", "wide", "ln_bwd"))]
    fwd, bwd = A._fwd_lib()[0], A._bwd_lib()[0]
    smem = (bwd.mmf_flash_attention_bwd_smem_bytes(HEAD_DIM, 1, 0),
            bwd.mmf_flash_attention_bwd_smem_bytes(2 * HEAD_DIM, 1, 0),
            fwd.mmf_flash_attention_fwd_smem_bytes(HEAD_DIM, 0),
            fwd.mmf_flash_attention_fwd_smem_bytes(2 * HEAD_DIM, 0),
            bwd.mmf_flash_attention_bwd_smem_bytes(HEAD_DIM, 0, 1),
            bwd.mmf_flash_attention_bwd_smem_bytes(2 * HEAD_DIM, 0, 1),
            fwd.mmf_flash_attention_fwd_smem_bytes(4 * HEAD_DIM, 0),
            bwd.mmf_flash_attention_bwd_smem_bytes(4 * HEAD_DIM, 0, 1),
            bwd.mmf_flash_attention_bwd_smem_bytes(4 * HEAD_DIM, 0, 0))
    blocks = attention_blocks()
    parts.append(f"layer_norm triton jit {done['layer_norm'][1]:.1f}s")
    parts.append(f"the LMDB core c++ {done['lmdb_core'][1]:.1f}s, PHOC cc "
                 f"{done['phoc'][1]:.1f}s")
    print(f"phase build: ok card='{card}' torch={torch.__version__} "
          f"cuda={torch.version.cuda}; built in parallel in {wall:.1f}s: "
          + "; ".join(parts))
    print("  wgmma kernels, the f32 K1, K2 and K3 (split-TF32 on mma.sync; "
          "above D=128 the wide FMA kernels) and K4-bwd's (ptxas: registers, spill store bytes; C7510, C7515 "
          "and C7520 would mean serialised products; bf16 K3 takes "
          f"{smem[0]} B of dynamic smem a block at D={HEAD_DIM}, {smem[1]} "
          f"B at D={2 * HEAD_DIM}; f32 K1 {smem[2]} B, {smem[3]} B at "
          f"D={2 * HEAD_DIM}; f32 K2 and K3 {smem[4]} B, {smem[5]} B; "
          f"the f32 wide FMA kernels at D={4 * HEAD_DIM}: K1 {smem[6]} B, K2 "
          f"{smem[7]} B, K3 {smem[8]} B; "
          "template arguments of the bf16 K1: head-dim boxes, form, "
          "per-element bias, ring stages, blocks an SM by launch bounds; of "
          "K2: the same without the form; K4-bwd's: dtype, "
          "16-byte vectors a lane, warps a row):")
    for name, kernels in reports.items():
        print(f"    {name}: " + "; ".join(
            f"{n} {r} regs, {sp} B spills" for n, r, sp, _ in kernels))
    print("  the bf16 K1 and K2 blocks the launchers take (dynamic smem, "
          "blocks an SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor"
          ", a consumer warpgroup each): " + "; ".join(
              f"{kid} D={d} {form}{' per-element bias' if elem else ''} "
              f"{sm} B, {n} blocks" for kid, d, form, elem, sm, n in blocks))
    # with no bias or a padding-mask row (every bf16 main path): three
    # blocks an SM at D = 64, two at 128; a per-element bias may take one
    for kid, d, form, elem, sm, n in blocks:
        check(n >= (1 if elem else 2 if d > HEAD_DIM else 3),
              f"{kid} D={d} {form}: {n} blocks an SM")


def attention_blocks():
    """[(kernel, D, form, per-element bias, dynamic smem bytes, blocks an
    SM)] for every bf16 K1 and K2 block the C launchers take, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    fwd, bwd = A._fwd_lib()[0], A._bwd_lib()[0]
    rows = []
    for d in (HEAD_DIM, 2 * HEAD_DIM):
        for elem in (0, 1):
            for form, label in enumerate(("inference", "stats", "raw")):
                sm = ctypes.c_int(0)
                n = fwd.mmf_flash_attention_fwd_occupancy(
                    d, form, elem, ctypes.byref(sm))
                rows.append(("K1", d, label, elem, sm.value, n))
            sm = ctypes.c_int(0)
            n = bwd.mmf_flash_attention_bwd_dq_occupancy(d, elem,
                                                         ctypes.byref(sm))
            rows.append(("K2", d, "dq", elem, sm.value, n))
    return rows


# -- phase 2 ---------------------------------------------------------------
def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the least time for the work on the card."""
    mem_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    op_ms = 1e3 * flops / PEAK_FLOPS[dtype]
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def rel_err(got, want, rel, what):
    """Max abs error, checked against ``rel`` times the largest entry."""
    want = want.float()
    err = float((got.float() - want).abs().max())
    scale = max(float(want.abs().max()), 1e-6)
    check(not torch.isnan(got).any() and err <= rel * scale,
          f"{what}: max abs err {err} > {rel} * {scale}")
    return err


def _attention_inputs(b, sq, skv, dtype, g, heads=HEADS, head_dim=HEAD_DIM):
    # q/k/v/dO as the [B,S,H,D] -> [B,H,S,D] views the attention block
    # hands the kernels; a padding mask with masked columns in every row
    def proj(s):
        return torch.randn(b, s, heads, head_dim, device=DEV,
                           generator=g).to(dtype).transpose(1, 2)

    mask = (torch.rand(b, skv, device=DEV, generator=g) > 0.2).int()
    mask[:, 0] = 1
    return (proj(sq), proj(skv), proj(skv), A.make_attention_bias(mask, dtype),
            proj(sq))


def _sdpa_with_lse(q, k, v, bias):
    """A callable: the memory-efficient SDPA forward that also returns the
    rows' logsumexp (m + log l), as SDPA calls it when a backward will
    follow. The bias is padded to an aligned row and broadcast by
    stride, as SDPA's own dispatch does."""
    if bias is None:
        return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True)
    skv = bias.shape[-1]
    padded = F.pad(bias, (0, -skv % 16))[..., :skv]
    padded = padded.expand(q.shape[0], q.shape[1], q.shape[2], skv)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, padded, True)


def _sdpa_backward(q, k, v, bias, dout):
    """One SDPA forward, and a callable timing its backward alone."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def phase_kernels(card):
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity
    g = torch.Generator(device=DEV).manual_seed(0)
    names = ("flash_attention_fwd", "flash_attention_fwd_stats",
             "flash_attention_fwd_raw", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    results = {n: {"err": 0.0} for n in names}
    lines = []
    cases = [(b, S, S, dt) for b in (1, 64)
             for dt in (torch.bfloat16, torch.float32)]
    cases.append((8, 128, 100, torch.bfloat16))  # Sq != Skv
    # long kv: many ring tiles and many 64-row blocks per (b, h)
    cases.append((8, LONG_S, LONG_S, torch.bfloat16))
    for b, sq, skv, dt in cases:
        q, k, v, bias, dout = _attention_inputs(b, sq, skv, dt, g)
        out = A.flash_attention(q, k, v, bias)
        out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
        raw = A.flash_attention_block(q, k, v, bias)
        half = skv // 2
        halves = [A.flash_attention_block(q, k[:, :, sl], v[:, :, sl],
                                          bias[..., sl])
                  for sl in (slice(0, half), slice(half, skv))]
        dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l,
                                             dout)
        dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
        torch.cuda.synchronize()
        ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
        err = max_err(out, ref_out, dt)
        check(torch.equal(out, out_s), "stats form output != inference form")
        torch.testing.assert_close(m, ref_m, **STATS_TOL)
        torch.testing.assert_close(l, ref_l, **STATS_TOL)
        err_s = max(err, float((m - ref_m).abs().max()),
                    float((l - ref_l).abs().max()))
        # raw-stats form: against its plain version, and the merged states
        # of the two kv halves against K1 over the whole kv
        ref_raw = A.flash_attention_block_reference(q, k, v, bias)
        torch.testing.assert_close(raw[1], ref_raw[1], **STATS_TOL)
        torch.testing.assert_close(raw[2], ref_raw[2], **STATS_TOL)
        err_r = max(rel_err(raw[0], ref_raw[0], RAW_REL[dt],
                            f"raw acc B={b} {dt}"),
                    float((raw[1] - ref_raw[1]).abs().max()),
                    float((raw[2] - ref_raw[2]).abs().max()))
        macc, _, ml = A.merge_block_states(halves)
        merged = (macc / ml[..., None]).to(dt)
        err_merge = max_err(merged, out, dt)
        ref = A.flash_backward_reference(q, k, v, bias, out_s, m, l, dout)
        errs = [rel_err(got, want, GRAD_REL[dt], f"{name} B={b} {dt}")
                for name, got, want in zip(("dq", "dk", "dv"),
                                           (dq, dk, dv), ref)]
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(A.mha_reference(*leaves, bias),
                                   leaves, dout.float())
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), auto):
            rel_err(got, want, 1.5 * GRAD_REL[dt],
                    f"{name} vs autograd(mha_reference) B={b} {dt}")
        # no atomics: a second call gives the same bits
        dq2, delta2 = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l,
                                               dout)
        dk2, dv2 = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l,
                                             delta2)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in
                  ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2))),
              f"backward not bit-equal across calls B={b} {dt}")
        for name, e in zip(names[:5], (err, err_s, max(err_r, err_merge),
                                       errs[0], max(errs[1:]))):
            results[name]["err"] = max(results[name]["err"], e)

        def k2():
            return A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l, dout)

        def k3():
            return A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l,
                                             delta)

        def k1_raw():
            return A.flash_attention_block(q, k, v, bias)

        def k1():
            return A.flash_attention(q, k, v, bias)

        def k1_stats():
            return A.flash_attention_with_stats(q, k, v, bias)

        plain_fwd = lambda: A.mha_reference(q, k, v, bias)  # noqa: E731
        t = {  # CUDA events around back-to-back calls
            "flash_attention_fwd": time_ms(k1),
            "flash_attention_fwd_stats": time_ms(k1_stats),
            "flash_attention_bwd_dq": time_ms(k2),
            "flash_attention_bwd_dkv": time_ms(k3),
        }
        dev = {  # device time per call, calls queued behind a spin kernel
            "flash_attention_fwd": device_ms(k1),
            "flash_attention_fwd_stats": device_ms(k1_stats),
            "flash_attention_fwd_raw": device_ms(k1_raw),
            "flash_attention_bwd_dq": device_ms(k2),
            "flash_attention_bwd_dkv": device_ms(k3),
        }
        host = {n: host_us(fn) for n, fn in (
            ("K1", k1), ("K1-stats", k1_stats), ("K1-raw", k1_raw),
            ("K2", k2), ("K3", k3))}
        plain = {
            "flash_attention_fwd": time_ms(plain_fwd),
            "flash_attention_fwd_stats": time_ms(
                lambda: A.flash_forward_reference(q, k, v, bias)),
            "flash_attention_fwd_raw": time_ms(
                lambda: A.flash_attention_block_reference(q, k, v, bias)),
            # the plain backward computes dq, dk and dv together
            "flash_attention_bwd_dq": time_ms(
                lambda: A.flash_backward_reference(q, k, v, bias, out_s, m,
                                                   l, dout), iters=10),
        }
        plain["flash_attention_bwd_dkv"] = plain["flash_attention_bwd_dq"]
        def sdpa_fn():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

        sdpa_lse_fn = _sdpa_with_lse(q, k, v, bias)
        sdpa, sdpa_dev = time_ms(sdpa_fn), device_ms(sdpa_fn)
        sdpa_lse, sdpa_lse_dev = time_ms(sdpa_lse_fn), device_ms(sdpa_lse_fn)
        sdpa_bwd_fn = _sdpa_backward(q, k, v, bias, dout)
        sdpa_bwd = time_ms(sdpa_bwd_fn, iters=10)
        sdpa_bwd_dev = device_ms(sdpa_bwd_fn, iters=10)
        if (b, sq, dt) == (64, S, torch.bfloat16):
            qkvo = 4 * _nbytes(q)
            st = _nbytes(m)  # one f32 [B,H,Sq] row statistic
            pairs = b * HEADS * sq * skv * HEAD_DIM  # multiply-adds per
            work = {  # product; (bytes, FLOPs) each input read once,
                # each output written once
                "flash_attention_fwd": (qkvo + _nbytes(bias), 4 * pairs),
                "flash_attention_fwd_stats": (qkvo + _nbytes(bias) + 2 * st,
                                              4 * pairs),
                # q, k, v in, f32 acc, m and l out
                "flash_attention_fwd_raw": (3 * _nbytes(q) + _nbytes(bias)
                                            + _nbytes(raw[0]) + 2 * st,
                                            4 * pairs),
                "flash_attention_bwd_dq": (6 * _nbytes(q) + _nbytes(bias)
                                           + 3 * st, 6 * pairs),
                "flash_attention_bwd_dkv": (6 * _nbytes(q) + _nbytes(bias)
                                            + 3 * st, 8 * pairs),
            }
            for name, (nb, fl) in work.items():
                r = results[name]
                r["ms"] = dev.get(name, t.get(name))
                r["plain_ms"] = plain[name]
                r["bound_ms"], r["bound_by"] = bound(nb, fl, dt)
                if name in t and name in dev:
                    r["events_ms"] = t[name]
            for name, lib_dev, lib_ev, wrapper in (
                    ("flash_attention_fwd", sdpa_dev, sdpa, "K1"),
                    ("flash_attention_fwd_stats", sdpa_lse_dev, sdpa_lse,
                     "K1-stats")):
                results[name].update(library_ms=lib_dev,
                                     library_events_ms=lib_ev,
                                     host_us=host[wrapper])
            for name, wrapper in (("flash_attention_fwd_raw", "K1-raw"),
                                  ("flash_attention_bwd_dq", "K2"),
                                  ("flash_attention_bwd_dkv", "K3")):
                results[name]["host_us"] = host[wrapper]
            # no PyTorch call returns the unnormalized state
            results["flash_attention_fwd_raw"]["library_ms"] = None
            # the SDPA backward computes dq, dk and dv together: one
            # library time for K2 and K3 combined
            for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                results[name]["library_ms"] = sdpa_bwd_dev
                results[name]["library_events_ms"] = sdpa_bwd
        lines.append(
            f"  flash B={b} H={HEADS} Sq={sq} Skv={skv} D={HEAD_DIM} "
            f"{str(dt)[6:]}: max_abs_err fwd {err:.3g}, stats {err_s:.3g}, "
            f"raw {err_r:.3g}, merged halves vs K1 {err_merge:.3g}, "
            f"dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}; "
            "backward bit-equal across calls; device ms (spin-queued) K1 "
            f"{dev['flash_attention_fwd']:.4f}, K1-stats "
            f"{dev['flash_attention_fwd_stats']:.4f}, "
            f"K1-raw {dev['flash_attention_fwd_raw']:.4f}, K2 "
            f"{dev['flash_attention_bwd_dq']:.4f}, K3 "
            f"{dev['flash_attention_bwd_dkv']:.4f}, K2+K3 "
            f"{dev['flash_attention_bwd_dq'] + dev['flash_attention_bwd_dkv']:.4f}"
            f", sdpa fwd {sdpa_dev:.4f}, sdpa fwd+lse {sdpa_lse_dev:.4f}, "
            f"sdpa bwd {sdpa_bwd_dev:.4f}; events ms K1 "
            f"{t['flash_attention_fwd']:.4f}, K1-stats "
            f"{t['flash_attention_fwd_stats']:.4f}, K2 "
            f"{t['flash_attention_bwd_dq']:.4f}, K3 "
            f"{t['flash_attention_bwd_dkv']:.4f}, plain fwd "
            f"{plain['flash_attention_fwd']:.4f}, plain fwd+stats "
            f"{plain['flash_attention_fwd_stats']:.4f}, plain raw "
            f"{plain['flash_attention_fwd_raw']:.4f}, plain bwd "
            f"{plain['flash_attention_bwd_dq']:.4f}, sdpa fwd {sdpa:.4f}, "
            f"sdpa fwd+lse {sdpa_lse:.4f}, sdpa bwd {sdpa_bwd:.4f}; host us "
            "per wrapper call " + ", ".join(
                f"{n} {us:.1f}" for n, us in host.items()))
    results["layer_norm"], results["layer_norm_bwd"] = _layer_norm_cases(
        g, lines)
    results["int8_dequant_gemm"] = _k5_cases(g, lines)
    print(f"phase kernels: ok (card '{card}'; tolerances f32 "
          f"{TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}; stats "
          f"{STATS_TOL}; gradients relative {GRAD_REL[torch.float32]} / "
          f"{GRAD_REL[torch.bfloat16]} of the largest entry, 1.5x that "
          "against autograd through mha_reference; K4-bwd dx relative "
          f"{LN_DX_REL[torch.float32]} / {LN_DX_REL[torch.bfloat16]}, "
          f"dscale and dbias {LN_PARAM_REL}; "
          "K5 f32 within 2 ulp of its epilogue's operands, bf16 within 1 "
          "bf16 ulp)")
    print("\n".join(lines))
    return results


def rotating(fn, sets):
    """A callable that runs ``fn(*set)`` on the next of ``sets`` at each
    call, so that calls timed back to back read device memory, not L2."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def _ln_sets(pool, rows, per_call_bytes):
    """Input sets (x, residual, dy) of ``rows`` rows cut from ``pool``
    ([n, R, H] tensors, R a multiple of ``rows``): at least three, and at
    least ROTATE_BYTES of what one call reads in all."""
    n = max(3, math.ceil(ROTATE_BYTES / per_call_bytes))
    per = pool[0].shape[1] // rows
    check(n <= pool[0].shape[0] * per, f"{n} LayerNorm input sets at {rows} "
          "rows: the pool is too small")
    return [tuple(t[i // per, (i % per) * rows:(i % per + 1) * rows]
                  for t in pool) for i in range(n)]


def _ln_library_backward(x, residual, w, bb, dy):
    """One F.layer_norm forward after the residual add (weights in x's
    dtype), and a callable running its backward alone: dx, dweight and
    dbias (the add's backward launches nothing)."""
    h = (x if residual is None else x + residual).detach().requires_grad_()
    leaves = [h] + [t.detach().to(x.dtype, copy=True).requires_grad_()
                    for t in (w, bb)]
    y = F.layer_norm(h, h.shape[-1:], leaves[1], leaves[2], 1e-12)
    return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


def _ln_plain_vjp(x, residual, w, bb, dy):
    """The backward before K4-bwd (and JAX's): autograd's VJP of the plain
    forward, recomputed. A callable running it."""
    leaves = [t.detach().requires_grad_()
              for t in (x, residual, w, bb) if t is not None]
    xi, *rest = leaves
    ri = rest.pop(0) if residual is not None else None
    y = L._ln_reference(xi, ri, rest[0], rest[1], 1e-12)
    return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


def _layer_norm_cases(g, lines):
    """K4 in its four forms (bf16 and f32, with and without the residual)
    at the training step's [14592, 768] and bf16 at bucket 32's [7296,
    768], and K4-bwd in the four forms at [14592, 768]: each against its
    plain version, bit-equal across two calls (K4-bwd), and timed by
    device_ms over rotating input sets beside its plain version and
    F.layer_norm (forward, or backward), with the wrapper's host time.
    Returns the kernels line's rows of K4 and K4-bwd (bf16 with the
    residual), each with all forms under "forms"."""
    rows = TRAIN_B * S
    fwd = {"err": 0.0, "forms": {}}
    bwd = {"err": 0.0, "forms": {}}
    for dt in (torch.bfloat16, torch.float32):
        pool = [torch.randn(LN_POOL, rows, HIDDEN, device=DEV,
                            generator=g).to(dt) for _ in range(3)]
        w = 1.0 + 0.1 * torch.randn(HIDDEN, device=DEV, generator=g)
        bb = 0.1 * torch.randn(HIDDEN, device=DEV, generator=g)
        w_dt, bb_dt = w.to(dt), bb.to(dt)  # F.layer_norm's weights, cast once
        elt = pool[0].element_size()
        shapes = [rows] + ([SERVE_B * S] if dt == torch.bfloat16 else [])
        for n_rows, with_res in ((r, wr) for r in shapes
                                 for wr in (False, True)):
            form = (f"{str(dt)[6:]} [{n_rows}, {HIDDEN}] "
                    f"{'residual' if with_res else 'no residual'}")
            row_bytes = n_rows * HIDDEN * elt
            sets = _ln_sets(pool, n_rows, (2 if with_res else 1) * row_bytes)
            x, res, dy = sets[0]
            res = res if with_res else None
            out = L.layer_norm_kernel(x, w, bb, res)
            torch.cuda.synchronize()
            err = max_err(out, L._ln_reference(x, res, w, bb, 1e-12), dt)
            fwd["err"] = max(fwd["err"], err)

            def kern(x_, r_, _dy):
                return L.layer_norm_kernel(x_, w, bb, r_ if with_res else None)

            def stock(x_, r_, _dy):
                return F.layer_norm(x_ + r_ if with_res else x_, (HIDDEN,),
                                    w_dt, bb_dt, 1e-12)

            def plain(x_, r_, _dy):
                return L._ln_reference(x_, r_ if with_res else None, w, bb,
                                       1e-12)

            f = {"ms": device_ms(rotating(kern, sets)),
                 "library_ms": device_ms(rotating(stock, sets)),
                 "plain_ms": device_ms(rotating(plain, sets), iters=5),
                 "events_ms": time_ms(rotating(kern, sets)),
                 "host_us": host_us(lambda: L.layer_norm_kernel(x, w, bb,
                                                                res))}
            f["bound_ms"], f["bound_by"] = bound(
                _nbytes(x, res, w, bb, out), 8 * x.numel(), dt)
            f["bound_share"] = f["bound_ms"] / f["ms"]
            fwd["forms"][form] = f
            lines.append(
                f"  K4 {form}: max_abs_err {err:.3g}; device ms (rotating "
                f"{len(sets)} input sets): kernel {f['ms']:.4f}, "
                f"F.layer_norm{'(+add)' if with_res else ''} "
                f"{f['library_ms']:.4f}, plain {f['plain_ms']:.4f}; bound "
                f"{f['bound_ms']:.4f} by {f['bound_by']} (kernel at "
                f"{100 * f['bound_share']:.0f}% of it); events over "
                f"back-to-back calls {f['events_ms']:.4f}; host "
                f"{f['host_us']:.1f} us a call"
                + ("; UNDER THE BOUND: L2 was read" if f["ms"] < f["bound_ms"]
                   else ""))
            if n_rows != rows:
                continue
            # the backward: K4-bwd against the plain backward, two calls
            # bit-equal, timed beside the plain backward, the old plain
            # VJP and F.layer_norm's backward
            sets = _ln_sets(pool, n_rows, (3 if with_res else 2) * row_bytes)
            x, res, dy = sets[0]
            res = res if with_res else None
            got = L.layer_norm_backward_kernel(x, w, dy, res)
            again = L.layer_norm_backward_kernel(x, w, dy, res)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K4-bwd {form}: not bit-equal across calls")
            want = L._ln_backward_reference(x, res, w, bb, dy, 1e-12)
            errs = [rel_err(a, b, rel, f"K4-bwd {name} {form}")
                    for name, a, b, rel in zip(
                        ("dx", "dscale", "dbias"), got,
                        (want[0], want[2], want[3]),
                        (LN_DX_REL[dt], LN_PARAM_REL, LN_PARAM_REL))]
            bwd["err"] = max(bwd["err"], *errs)

            def kern_bwd(x_, r_, dy_):
                return L.layer_norm_backward_kernel(
                    x_, w, dy_, r_ if with_res else None)

            def plain_bwd(x_, r_, dy_):
                return L._ln_backward_reference(
                    x_, r_ if with_res else None, w, bb, dy_, 1e-12)

            lib = [_ln_library_backward(x_, r_ if with_res else None, w, bb,
                                        dy_) for x_, r_, dy_ in sets]
            vjp = [_ln_plain_vjp(x_, r_ if with_res else None, w, bb, dy_)
                   for x_, r_, dy_ in sets]
            b = {"ms": device_ms(rotating(kern_bwd, sets)),
                 "library_ms": device_ms(rotating(lambda f_: f_(),
                                                  [(f_,) for f_ in lib])),
                 "plain_ms": device_ms(rotating(plain_bwd, sets), iters=5),
                 "plain_vjp_ms": device_ms(rotating(
                     lambda f_: f_(), [(f_,) for f_ in vjp]), iters=5),
                 "events_ms": time_ms(rotating(kern_bwd, sets)),
                 "host_us": host_us(lambda: L.layer_norm_backward_kernel(
                     x, w, dy, res))}
            del lib, vjp
            b["bound_ms"], b["bound_by"] = bound(
                _nbytes(x, res, w, dy, got[0], got[1], got[2]),
                10 * x.numel(), dt)
            b["bound_share"] = b["bound_ms"] / b["ms"]
            bwd["forms"][form] = b
            lines.append(
                f"  K4-bwd {form}: max_abs_err dx {errs[0]:.3g}, dscale "
                f"{errs[1]:.3g}, dbias {errs[2]:.3g}; bit-equal across "
                f"calls; device ms (rotating {len(sets)} input sets): "
                f"kernel {b['ms']:.4f}, F.layer_norm backward "
                f"{b['library_ms']:.4f}, plain backward {b['plain_ms']:.4f},"
                f" plain VJP (the backward before K4-bwd) "
                f"{b['plain_vjp_ms']:.4f}; bound {b['bound_ms']:.4f} by "
                f"{b['bound_by']} (kernel at "
                f"{100 * b['bound_share']:.0f}% of it); events over "
                f"back-to-back calls {b['events_ms']:.4f}; host "
                f"{b['host_us']:.1f} us a call"
                + ("; UNDER THE BOUND: L2 was read" if b["ms"] < b["bound_ms"]
                   else ""))
        del pool
        torch.cuda.empty_cache()
    headline = f"bfloat16 [{rows}, {HIDDEN}] residual"
    for row in (fwd, bwd):
        row.update({k: v for k, v in row["forms"][headline].items()
                    if k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by", "host_us", "events_ms",
                             "plain_vjp_ms")})
    return fwd, bwd


def k5_error(got, x8, w8, xs, ws, bias, out_dtype, what):
    """Max abs error of K5 against its plain version, checked elementwise:
    f32 output within 2 ulp of the epilogue's operands (|y xs ws| + |b|),
    bf16 output within 1 bf16 ulp of the plain result."""
    ref = Q.dequant_gemm_reference(x8, w8, xs, ws, bias, out_dtype).float()
    err = (got.float() - ref).abs()
    if out_dtype == torch.float32:
        scaled = Q.dequant_gemm_reference(x8, w8, xs, ws, None,
                                          torch.float32).abs()
        allowed = 2.0 ** -22 * (scaled + (0 if bias is None else bias.abs()))
    else:
        _, exponent = torch.frexp(ref)  # |ref| in [2^(e-1), 2^e)
        allowed = torch.ldexp(torch.ones_like(ref), exponent - 8)
    bad = int((err > allowed).sum())
    check(not torch.isnan(got).any() and bad == 0,
          f"{what}: {bad} entries beyond the bound, max abs err "
          f"{float(err.max())}")
    return float(err.max())


def _k5_operands(m, k, n, g):
    """Quantised operands as the trunk makes them: activations ~N(0, 1),
    weights ~N(0, 0.02) as init_weights draws them, a small bias."""
    x = torch.randn(m, k, device=DEV, generator=g).to(torch.bfloat16)
    w = 0.02 * torch.randn(n, k, device=DEV, generator=g)
    bias = 0.1 * torch.randn(n, device=DEV, generator=g)
    x8, xs = Q.quantize_rows(x)
    w8, ws = Q.quantize_rows(w, eps=1e-11)
    return x8, w8, xs.reshape(-1), ws.reshape(-1), bias


def _k5_cases(g, lines):
    """K5 against its plain version at the main paths' shapes; returns its
    row of the kernels report (the headline shape's times)."""
    row = {"err": 0.0}
    cases = [(shape, torch.bfloat16) for shape in K5_MMBT]
    cases += [(K5_VB, torch.float32), (K5_VB, torch.bfloat16)]
    per_forward = 0.0
    for (m, k, n), dt in cases:
        x8, w8, xs, ws, bias = _k5_operands(m, k, n, g)
        out = Q.dequant_gemm(x8, w8, xs, ws, bias, dt)
        torch.cuda.synchronize()
        err = k5_error(out, x8, w8, xs, ws, bias, dt, f"K5 {m}x{k}x{n} {dt}")
        row["err"] = max(row["err"], err)
        # device time per call: at M = 131 back-to-back launches through
        # the Python wrapper measure the host's launch rate, not the
        # kernel (time_ms gives that rate, printed too)
        def kern_fn():
            return Q.dequant_gemm(x8, w8, xs, ws, bias, dt)

        kern = device_ms(kern_fn)
        wrapper_ms = time_ms(kern_fn)
        wrapper_us = host_us(kern_fn)
        plain = device_ms(lambda: Q.dequant_gemm_reference(
            x8, w8, xs, ws, bias, dt), iters=5)
        w8t = w8.t()  # [K, N], column-major: cuBLASLt's int8 layout
        # torch._int_mm takes M > 16 only
        lib = (device_ms(lambda: torch._int_mm(x8, w8t)) if m > 16
               else None)
        nbytes = _nbytes(x8, w8, xs, ws, bias, out)
        b_ms, b_by = bound(nbytes, 2 * m * n * k, torch.int8)
        if ((m, k, n), dt) == (K5_HEADLINE, torch.bfloat16):
            row.update(ms=kern, plain_ms=plain, library_ms=lib,
                       bound_ms=b_ms, bound_by=b_by, host_us=wrapper_us)
        if (m, k, n) in K5_MMBT:
            per_forward += K5_MMBT[(m, k, n)] * kern
        lines.append(
            f"  int8_gemm M={m} K={k} N={n} -> {str(dt)[6:]}: max_abs_err "
            f"{err:.3g}; device ms per call: kernel {kern:.4f} "
            f"({2e-9 * m * n * k / kern:.1f} TOP/s), plain {plain:.4f}, "
            f"torch._int_mm (int32 product alone) "
            f"{'n/a' if lib is None else f'{lib:.4f}'}; bound {b_ms:.4f} "
            f"by {b_by}; {Q.k5_tile(m, n)}-wide tiles; "
            f"back-to-back calls through the wrapper (CUDA events) "
            f"{wrapper_ms:.4f} ms each, host {wrapper_us:.1f} us a call")
    lines.append(f"  int8_gemm per MMBT forward at batch 1 (73 launches): "
                 f"{per_forward:.4f} ms of kernel device time")
    return row


def cpu_forward(model, sample):
    """One sample through ``model`` on the CPU (the plain versions)."""
    def batch_of_one(tree):
        if isinstance(tree, dict):
            return {k: batch_of_one(v) for k, v in tree.items()}
        if isinstance(tree, (np.ndarray, np.generic)):
            return torch.from_numpy(np.asarray(tree)[None])
        return tree  # meta strings

    model.eval().to_compute_dtype()
    batch = batch_of_one(sample)
    with torch.inference_mode():
        out = model(batch)
    return {k: v[0].float().numpy() for k, v in out.items()}


# -- phase 3 ---------------------------------------------------------------
def _request(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=body,
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, payload = r.status, json.loads(r.read())
    return status, payload, time.perf_counter() - t0


def _fields_body(sample):
    def conv(v):
        return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) \
            else np.asarray(v).tolist()
    return json.dumps({"fields": conv(sample)}).encode()


def phase_serving(card):
    model = flagship.visual_bert()
    cfg = model.config
    check((cfg["hidden_size"], cfg["num_hidden_layers"],
           cfg["num_attention_heads"], cfg["num_labels"],
           cfg["dtype"]) == (HIDDEN, 12, HEADS, 3129, "bfloat16"), cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())

    samples = flagship.split_samples(flagship.example_batch(
        N_REQUESTS, SEQ, REGIONS, VDIM, seed=0))
    samples[3]["image_info_0"]["max_features"] = np.int32(37)
    bodies = [_fields_body(s) for s in samples]

    engine = ServingEngine(model, device=DEV, max_batch_size=32)
    server = ServingServer(engine, host="127.0.0.1", port=0,
                           max_wait_ms=20.0).start()
    try:
        t0 = time.perf_counter()
        warmed = engine.warmup(samples[0])
        warm_s = time.perf_counter() - t0
        stats0 = server.stats()["batcher"]

        # the main path, counted from zero
        reset_counts()
        replies = [None] * N_REQUESTS

        def send(i):
            replies[i] = _request(server.port, bodies[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        launches = read_counts()
        stats1 = server.stats()["batcher"]
        check(not any(t.is_alive() for t in threads), "a request hung")
        for status, payload, _ in replies:
            check(status == 200, payload)
            scores = np.asarray(payload["scores"], np.float32)
            check(scores.shape == (3129,), f"scores shape {scores.shape}")
            check(np.isfinite(scores).all(), "non-finite scores")
        batches = stats1["batches"] - stats0["batches"]
        # per forward: 12 attention calls; 24 residual LayerNorms plus the
        # embedding and the classifier-head LayerNorm
        want = dict(ZERO_COUNTS, flash_attention_fwd=12 * batches,
                    layer_norm=26 * batches)
        check(batches >= 1 and launches == want,
              f"launches {launches}, want {want} for {batches} batch(es)")
        lat = sorted(r[2] for r in replies)
        p50_ms = 1000 * lat[len(lat) // 2]

        # one request's served scores vs the f32 CPU forward (plain
        # versions) on the same weights
        ref_model = flagship.visual_bert({"dtype": "float32"})
        ref_model.load_state_dict(cpu_state, strict=True)
        probe = 3  # the request with max_features = 37
        ref = cpu_forward(ref_model, samples[probe])["scores"]
        got = np.asarray(replies[probe][1]["scores"], np.float32)
        err = float(np.abs(got - ref).max())
        cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
        check(err <= SERVE_ATOL and cos >= SERVE_MIN_COSINE,
              f"served vs f32 CPU: max_abs_err {err}, cosine {cos}")

        # engine throughput at bucket 32 (stack, pad, one H2D copy,
        # forward, D2H), after the counted run
        batch32 = [samples[i % N_REQUESTS] for i in range(32)]
        engine.predict_many(batch32)
        iters = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.predict_many(batch32)
        sps = 32 * iters / (time.perf_counter() - t0)
        # device forward alone at bucket 32
        arrays, _ = engine_lib._split_static(
            engine_lib._stack_samples(batch32))
        dev_batch = engine_lib._to_device(arrays, DEV)
        def forward():
            with torch.inference_mode():
                engine.model(dev_batch)

        fwd_ms = time_ms(forward, iters=5, repeats=3)
        dev_ms, by_category = _device_ms(forward, 3)
    finally:
        server.shutdown()
    print(f"phase serving: ok VisualBERT-base {n_params / 1e6:.1f}M params "
          f"bf16; warmup buckets {list(warmed)} in {warm_s:.1f}s; "
          f"{N_REQUESTS} concurrent requests all 200, scores [3129] finite, "
          f"{batches} batch(es); launches {launches}; served-vs-f32-CPU "
          f"max_abs_err={err:.4g} (bound {SERVE_ATOL}) cosine={cos:.6f}")
    print(f"  serving on '{card}': {sps:.1f} samples/s at bucket 32 "
          f"(engine predict_many, host stacking and copies included); "
          f"forward alone {fwd_ms:.2f} ms at bucket 32; concurrent request "
          f"p50 {p50_ms:.1f} ms (client side, {N_REQUESTS} requests, "
          f"JSON of ~{len(bodies[0]) / 1e6:.1f} MB each); batcher p50 "
          f"{stats1['latency_ms']['p50']:.1f} ms")
    print(f"  bf16 forward at bucket 32: device time {dev_ms:.3f} ms "
          "(torch.profiler, 3 forwards): " + "; ".join(
              f"{cat} {ms:.3f} x{cnt:.0f}" for cat, (ms, cnt) in
              sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    return launches, {"state": cpu_state, "batch32": batch32,
                      "fwd_ms": fwd_ms, "probe": probe, "ref_f32": ref}


# -- phase 4 ---------------------------------------------------------------
@contextlib.contextmanager
def plain_versions():
    """The trunk's attention and LayerNorm swapped for their plain
    versions on the card, for the kernel-vs-plain step comparison only."""
    attn, ln = T.dot_product_attention, T.layer_norm
    T.dot_product_attention = (
        lambda q, k, v, bias=None, scale=None, dropout_rate=0.0,
        generator=None: A.mha_reference(q, k, v, bias, scale, dropout_rate,
                                        generator))
    T.layer_norm = (lambda x, scale, bias, residual=None, eps=1e-12:
                    L._ln_reference(x, residual, scale, bias, eps))
    try:
        yield
    finally:
        T.dot_product_attention, T.layer_norm = attn, ln


def _cosine(a, b):
    # on the card: in float64 on the host's cores a model's gradients take
    # seconds
    a = a.to(DEV, torch.float64).flatten()
    b = b.to(DEV, torch.float64).flatten()
    den = float(a.norm() * b.norm())
    return 1.0 if den == 0.0 else float(a @ b) / den


def _norm_rel(got, want):
    """||got - want|| / ||want||: unlike the cosine, it sees scale."""
    got, want = got.to(DEV, torch.float64), want.to(DEV, torch.float64)
    den = float(want.norm())
    return float((got - want).norm()) / den if den else float(got.norm())


DEVICE_CATEGORIES = (  # kernel-name fragment -> category, first match
    (("flash_fwd", "bwd_dq_", "bwd_dkv_"), "attention K1/K2/K3"),
    (("_ln_fwd_kernel",), "LayerNorm K4"),
    (("ln_bwd_",), "LayerNorm backward K4-bwd"),
    (("int8_gemm",), "int8 GEMM K5"),
    # before the convolutions: cuDNN's BatchNorm kernels are cudnn::bn_*
    (("bn_fw", "bn_bw", "batch_norm"), "BatchNorm"),
    (("fprop", "conv", "winograd", "implicit_gemm", "cudnn"),
     "convolutions (cuDNN)"),
    (("nvjet", "gemm", "cutlass", "sm90_", "xmma"), "GEMMs"),
    (("multi_tensor_apply",), "optimizer"),
    # the masked-LM loss's f32 log_softmax over the vocabulary (attention's
    # softmax runs inside K1)
    (("SoftMax",), "log_softmax (MLM loss, f32)"),
)


def _category(name):
    for fragments, category in DEVICE_CATEGORIES:
        if any(f in name for f in fragments):
            return category
    return "elementwise, reductions, copies"


def _op_device_ms(prof, n, dim):
    """(ms per step, calls per step) of the GEMM operators that have an
    operand dimension ``dim``, from their recorded input shapes."""
    ms = calls = 0.0
    for e in prof.events():
        if e.key in ("aten::mm", "aten::addmm") and any(
                dim in (shape or []) for shape in e.input_shapes):
            total = getattr(e, "device_time_total", None)
            ms += (e.cuda_time_total if total is None else total) / 1e3 / n
            calls += e.count / n
    return ms, calls


# steps (or forwards) a device-time breakdown profiles: the device time of
# a step varies by 2% between steps, and summing a capture's events
# takes seconds of the host's time
PROFILED_STEPS = 1


def _device_ms(step_fn, n, gemm_dim=None):
    """Device time per step from torch.profiler over ``n`` steps: the sum
    of the kernels' self time, and that sum by category of kernel. With
    ``gemm_dim`` the GEMMs whose operands have that dimension (the MLM
    decoder's vocabulary) are a category of their own, taken out of
    "GEMMs" through the operators' recorded shapes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=gemm_dim is not None) as prof:
        for _ in range(n):
            step_fn()
        torch.cuda.synchronize()
    return _by_category(prof, n, gemm_dim)


def _device_event(key, is_user_annotation):
    """Whether a device event of that name counts in a step's device
    time: kernels, copies and sets, not user annotations (the optimizer's
    record_function range) that span kernels and would count them
    twice."""
    return not is_user_annotation and not key.startswith(
        ("Optimizer.", "ProfilerStep"))


def _averaged_kernel_times(prof):
    """{name: (device us, launches)} of a finished capture's device
    events through key_averages()."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not \
                _device_event(e.key, getattr(e, "is_user_annotation", False)):
            continue
        us = (getattr(e, "self_device_time_total", None)
              or e.self_cuda_time_total)
        total, count = out.get(e.key, (0.0, 0))
        out[e.key] = (total + us, count + e.count)
    return out


def _raw_kernel_times(prof):
    """The same sums from the capture's raw kineto events, named and
    filtered as torch.profiler names and filters them when it parses a
    capture into FunctionEvents, without that parse."""
    from torch.autograd import profiler_util

    cuda = torch.autograd.DeviceType.CUDA
    names, out = {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        raw = ev.name()
        if profiler_util._filter_name(raw) or getattr(
                ev, "is_hidden_event", lambda: False)():
            continue
        key = names.get(raw)
        if key is None:
            key = names[raw] = profiler_util._rewrite_name(
                raw, with_wildcard=True)
        if not _device_event(key, ev.is_user_annotation()):
            continue
        is_async = ev.is_async() or (ev.start_thread_id()
                                     != ev.end_thread_id())
        us = 0.0 if is_async else (ev.end_ns() - ev.start_ns()) / 1e3
        total, count = out.get(key, (0.0, 0))
        out[key] = (total + us, count + 1)
    return out


# whether the raw events sum as key_averages() does on this torch: None
# until the first capture checks it
_RAW_EVENTS_AGREE = None


def _kernel_times(prof):
    """{name: (device us, launches)} of a finished capture's device
    events, as key_averages() sums them. torch.profiler parses a capture
    into FunctionEvents on the host before key_averages() folds them, and
    that takes seconds a capture. So the raw events' sums are used, once
    the first capture found them equal to key_averages()' (each name's
    launches, its time within 1e-6; both timed there); where they differ,
    or this torch lacks an accessor, key_averages() is used
    throughout."""
    global _RAW_EVENTS_AGREE
    if _RAW_EVENTS_AGREE is False:
        return _averaged_kernel_times(prof)
    t0 = time.perf_counter()
    try:
        raw = _raw_kernel_times(prof)
    except (AttributeError, TypeError) as exc:
        print(f"  (raw profiler events unreadable: {exc!r}; key_averages() "
              "from here on)")
        _RAW_EVENTS_AGREE = False
        return _averaged_kernel_times(prof)
    if _RAW_EVENTS_AGREE is None:
        t1 = time.perf_counter()
        ref = _averaged_kernel_times(prof)
        t2 = time.perf_counter()
        _RAW_EVENTS_AGREE = set(raw) == set(ref) and all(
            raw[k][1] == ref[k][1]
            and abs(raw[k][0] - ref[k][0]) <= 1e-6 * max(1.0, ref[k][0])
            for k in ref)
        print(f"  (raw profiler events against key_averages() on "
              f"{len(ref)} kernel names: "
              f"{'equal' if _RAW_EVENTS_AGREE else 'different'}, "
              f"{t1 - t0:.3f} s against {t2 - t1:.3f} s of the host's time "
              "(the parse into FunctionEvents included); "
              f"{'raw events' if _RAW_EVENTS_AGREE else 'key_averages()'}"
              " from here on)")
        return ref
    return raw


def _by_category(prof, n, gemm_dim=None):
    """(device ms per step, {category: (ms, launches) per step}) of a
    finished torch.profiler capture of ``n`` steps (``_device_ms``)."""
    # the parse into FunctionEvents that _kernel_times skips allocated
    # enough to set off the collector here, and the phases' peaks on the
    # card left room only for that: what sits in reference cycles goes
    gc.collect()
    by_category = {}
    for key, (us, launches) in _kernel_times(prof).items():
        cat = _category(key)
        total, count = by_category.get(cat, (0.0, 0.0))
        by_category[cat] = (total + us / 1e3 / n, count + launches / n)
    if gemm_dim is not None:
        ms, calls = _op_device_ms(prof, n, gemm_dim)
        total, count = by_category.get("GEMMs", (0.0, 0.0))
        by_category["GEMMs"] = (total - ms, count - calls)
        by_category[f"MLM decoder GEMMs (x {gemm_dim})"] = (ms, calls)
    return sum(v[0] for v in by_category.values()), by_category


def _compared_steps(cfg, state_dict, batch, steps=COMPARED_STEPS,
                    trainer=flagship.vqa2_trainer,
                    build=flagship.vqa2_visual_bert,
                    no_dropout=(("hidden_dropout_prob", 0.0),),
                    stats_out=None, device_out=None):
    """``steps`` steps at dropout 0 from ``state_dict``: (losses,
    gradients of the first step, None for a parameter that got none,
    parameter updates after all, launch counts). The schedule's update 0
    runs at lr 0, so the first two losses are taken at the initial
    weights and the third after an update at lr > 0. ``stats_out``, a
    dict, receives the BatchNorms' running statistics after the steps;
    ``device_out``, a list, the steps' device time per step and its split
    by kind (``_by_category``; torch.profiler around the steps)."""
    from torch.profiler import ProfilerActivity, profile

    # the other side's model, optimizer state and gradients may be held
    # by reference cycles until a collection: freed before this side
    # allocates (ViLT's plain side ran out of the card's memory without)
    gc.collect()
    model = build(cfg, dict(no_dropout))
    model.load_state_dict(state_dict, strict=True)
    state, step = trainer(model, cfg, seed=1)
    losses, grads = [], None
    reset_counts()
    with (contextlib.nullcontext() if device_out is None else profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])) as prof:
        for _ in range(steps):
            state, rep = step(state, batch)
            losses.append(float(rep["total_loss"]))
            if grads is None:
                grads = {n: None if p.grad is None else
                         p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()}
        torch.cuda.synchronize()
    if device_out is not None:
        device_out.append(_by_category(prof, steps))
    launches = read_counts()
    updates = {n: p.detach().cpu() - state_dict[n]
               for n, p in model.named_parameters()}
    if stats_out is not None:
        stats_out.update({n: b.detach().cpu() for n, b in
                          model.named_buffers() if "running_" in n})
    return losses, grads, updates, launches


def _check_losses(k_losses, p_losses):
    """The largest relative difference of the kernels' losses from the
    plain versions', checked against TRAIN_LOSS_RTOL."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"kernel vs plain losses {k_losses} / {p_losses}")
    return loss_rel


def _compared_names(k_grads, p_grads):
    """The parameters whose gradients the two sides compare. Both must
    hold the same parameters, and leave the same ones without a gradient
    (a head the dataset does not call): those are printed and left out,
    a gradient missing on one side only fails. The attention key biases'
    true gradient is 0 (softmax is shift-invariant along keys): both
    sides hold rounding noise there, so they are left out too (``key``,
    ``key1``, ``key2`` in the BERT trunks, ``k_proj`` in mmf_bert's
    multi-head attention)."""
    check(set(k_grads) == set(p_grads), "kernel vs plain parameters: "
          f"{sorted(set(k_grads) ^ set(p_grads))}")
    k_none = sorted(n for n, g in k_grads.items() if g is None)
    p_none = sorted(n for n, g in p_grads.items() if g is None)
    check(k_none == p_none, f"no gradient through the kernels {k_none}, "
          f"through the plain versions {p_none}")
    if k_none:
        print(f"  no gradient on either side (left out): {k_none}")
    return [n for n in k_grads if k_grads[n] is not None
            and not re.search(r"(key\d?|k_proj)\.bias$", n)]


def _check_gradients(k_grads, p_grads, resolved=None):
    """Per-parameter cosine and norm-relative error of the kernels'
    gradients against the plain versions', checked against their bounds:
    (names compared, cosines, errors, worst cosine's name, worst error's
    name), over ``_compared_names``. With ``resolved``, the norm-relative
    bound holds on those names only (the cosine's on all)."""
    compared = _compared_names(k_grads, p_grads)
    g_cos = {n: _cosine(k_grads[n], p_grads[n]) for n in compared}
    g_rel = {n: _norm_rel(k_grads[n], p_grads[n]) for n in compared}
    worst_g = min(g_cos, key=g_cos.get)
    worst_r = max((n for n in compared if resolved is None or n in resolved),
                  key=g_rel.get)
    check(g_cos[worst_g] >= TRAIN_MIN_GRAD_COSINE,
          f"gradient cosine {g_cos[worst_g]} at {worst_g}")
    check(g_rel[worst_r] <= TRAIN_MAX_GRAD_REL,
          f"gradient norm-relative error {g_rel[worst_r]} at {worst_r}")
    return compared, g_cos, g_rel, worst_g, worst_r


def phase_training(card):
    cfg = flagship.vqa2_config([
        # the flash kernel has no probabilities to drop (as in JAX)
        "model_config.visual_bert.attention_probs_dropout_prob=0.0",
        # so that the lr is above 0 within the run
        "scheduler.params.num_warmup_steps=2",
    ])
    model = flagship.vqa2_visual_bert(cfg)
    mc = model.config
    check((mc["hidden_size"], mc["num_hidden_layers"],
           mc["num_attention_heads"], mc["num_labels"], mc["dtype"],
           mc["hidden_dropout_prob"], mc["attention_probs_dropout_prob"])
          == (HIDDEN, 12, HEADS, 3129, "bfloat16", 0.1, 0.0), dict(mc))
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    model = model.to(DEV)
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "master parameters must stay f32")
    state, step = flagship.vqa2_trainer(model, cfg, seed=0)
    groups = [(g["weight_decay"], len(g["params"]))
              for g in state.optimizer.param_groups]
    batch = train_state._to_device(flagship.vqa2_train_batch(
        TRAIN_B, SEQ, REGIONS, VDIM, seed=0), DEV)

    t0 = time.perf_counter()
    state, rep = step(state, batch)  # warm-up
    warm_loss = float(rep["total_loss"])
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    # the main path, counted from zero
    reset_counts()
    losses, step_ms, lrs = [], [], []
    for _ in range(TRAIN_STEPS):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        t0 = time.perf_counter()
        state, rep = step(state, batch)
        losses.append(float(rep["total_loss"]))  # synchronises
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in [warm_loss] + losses)
          and not bool(rep["nan_flag"]), f"losses {losses}")
    check(lrs[0] > 0.0, f"lr {lrs}")
    # per step: 12 attention calls (stats form forward, K2 and K3 in the
    # backward, no inference form); 26 LayerNorms (embedding, 24 residual,
    # classifier head), each a K4 forward and a K4-bwd backward
    want = dict(ZERO_COUNTS, flash_attention_fwd_stats=12 * TRAIN_STEPS,
                flash_attention_bwd_dq=12 * TRAIN_STEPS,
                flash_attention_bwd_dkv=12 * TRAIN_STEPS,
                layer_norm=26 * TRAIN_STEPS,
                layer_norm_bwd=26 * TRAIN_STEPS)
    check(launches == want, f"training launches {launches}, want {want}")

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    dev_ms, by_category = _device_ms(one_step, PROFILED_STEPS)
    best_ms = min(step_ms)
    trained = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    del state, step, model, rep
    torch.cuda.empty_cache()

    # kernels vs plain versions: same weights, same batch, dropout 0
    k_losses, k_grads, k_upd, k_launches = _compared_steps(cfg, init, batch)
    with plain_versions():
        p_losses, p_grads, p_upd, p_launches = _compared_steps(cfg, init,
                                                               batch)
    want_k = {name: count * COMPARED_STEPS // TRAIN_STEPS
              for name, count in want.items()}
    check(k_launches == want_k, f"kernel side launches {k_launches}")
    check(p_launches == ZERO_COUNTS, f"plain side launches {p_launches}")
    check(k_losses[1] == k_losses[0] and k_losses[2] != k_losses[1],
          f"update 0 at lr 0 and update 1 above it: losses {k_losses}")
    loss_rel = _check_losses(k_losses, p_losses)
    compared, g_cos, g_rel, worst_g, worst_r = _check_gradients(k_grads,
                                                                p_grads)
    u_cos = {n: _cosine(k_upd[n], p_upd[n]) for n in compared}
    worst_u = min(u_cos, key=u_cos.get)
    check(u_cos[worst_u] >= TRAIN_MIN_UPDATE_COSINE,
          f"update cosine {u_cos[worst_u]} at {worst_u}")

    print(f"phase training: ok VisualBERT-base {n_params / 1e6:.1f}M f32 "
          f"params, bf16 compute, B={TRAIN_B}; warm-up step {warm_s:.1f}s "
          f"loss {warm_loss:.4f}; {TRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]} all finite, lr {lrs[0]:.3g} -> "
          f"{lrs[-1]:.3g}; optimizer groups (weight decay, params) "
          f"{groups}; launches {launches} (exact per step)")
    print(f"  training on '{card}': ms per step "
          f"{[round(x, 2) for x in step_ms]} (best {best_ms:.2f}), "
          f"{TRAIN_B * 1e3 / best_ms:.1f} samples/s at best, "
          f"{TRAIN_B * 1e3 * TRAIN_STEPS / sum(step_ms):.1f} mean; device "
          f"time {dev_ms:.2f} ms per step (torch.profiler, 1 step) against "
          f"{best_ms:.2f} ms wall; max_memory_allocated {peak_gb:.2f} GB")
    print("  device time per step by kind of kernel (ms, launches): "
          + "; ".join(f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                      sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    print(f"  kernels vs plain versions, {COMPARED_STEPS} steps at dropout "
          f"0 (launches {k_launches} vs {p_launches}): losses {k_losses} vs "
          f"{p_losses} (max rel {loss_rel:.3g}, bound {TRAIN_LOSS_RTOL}); "
          f"first-step gradients: cosine min {g_cos[worst_g]:.6f} at "
          f"{worst_g} (bound {TRAIN_MIN_GRAD_COSINE}), |g_k - g_p| / |g_p| "
          f"max {g_rel[worst_r]:.3g} at {worst_r} (bound "
          f"{TRAIN_MAX_GRAD_REL}); update cosine after {COMPARED_STEPS} "
          f"steps min {u_cos[worst_u]:.6f} at {worst_u} (bound "
          f"{TRAIN_MIN_UPDATE_COSINE}); {len(compared)} of {len(k_grads)} "
          "parameters compared (attention key biases left out)")
    return launches, {"config": cfg, "state": trained,
                      "samples_per_s": TRAIN_B * 1e3 * TRAIN_STEPS
                      / sum(step_ms)}


# -- phase 5 ---------------------------------------------------------------
def _mmbt(state=None, **overrides):
    """MMBT-grid with fused_feature_only (the pooled features come back
    beside the scores): seeded weights, or ``state``."""
    model = flagship.mmbt_grid(dict({"fused_feature_only": True},
                                    **overrides))
    if state is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state, strict=True)
    return model


def _compare(got, want, what, atol=MMBT_ATOL, min_cos=MMBT_MIN_COSINE,
             enforce=True):
    """(max abs error over scores and pooled features, the features'
    cosine), checked against the bounds when ``enforce``."""
    err = max(float(np.abs(np.asarray(got[k], np.float32) - want[k]).max())
              for k in ("scores", "fused_feature"))
    a, b = np.asarray(got["fused_feature"], np.float64), want[
        "fused_feature"].astype(np.float64)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    if enforce:
        check(err <= atol and cos >= min_cos,
              f"{what}: max_abs_err {err} (bound {atol}), cosine {cos} "
              f"(bound {min_cos})")
    return err, cos


def _serve_batch1(model, sample, k5_per_forward):
    """Serve ``sample`` at batch 1 LATENCY_CALLS times, counted from zero:
    (launches, latencies in ms, last output, device ms per forward and
    its breakdown)."""
    engine = ServingEngine(model, device=DEV, max_batch_size=1)
    engine.warmup(sample)
    engine.predict(sample)
    torch.cuda.synchronize()
    reset_counts()  # the main path, counted from zero
    lat = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        out = engine.predict(sample)  # outputs copied back to the host
        lat.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    launches = read_counts()
    want = dict(ZERO_COUNTS, int8_dequant_gemm=k5_per_forward * LATENCY_CALLS,
                **{k: v * LATENCY_CALLS for k, v in MMBT_PER_FORWARD.items()})
    check(launches == want, f"MMBT launches {launches}, want {want}")
    check(np.asarray(out["scores"]).shape == (2,)
          and np.asarray(out["fused_feature"]).shape == (HIDDEN,)
          and all(np.isfinite(np.asarray(v)).all() for v in out.values()),
          f"MMBT output {out}")
    arrays, _ = engine_lib._split_static(engine_lib._stack_samples([sample]))
    dev_batch = engine_lib._to_device(arrays, DEV)

    def forward():
        with torch.inference_mode():
            engine.model(dev_batch)

    dev_ms, by_category = _device_ms(forward, 5)
    return launches, lat, out, dev_ms, by_category


def phase_mmbt(card):
    model = _mmbt()
    mc = model.config
    text = mc["text_encoder"]["params"]
    check((text["hidden_size"], text["num_hidden_layers"],
           text["num_attention_heads"], mc["num_labels"], mc["dtype"],
           model.encoder_name) == (HIDDEN, 12, HEADS, 2, "bfloat16",
                                   "ResNet152ImageEncoder_0"), dict(mc))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    sample = flagship.split_samples(flagship.hateful_memes_example_batch(
        1, seed=0))[0]
    os.environ["MMF_TPU_QUANT"] = "int8"  # the route mmf_serve takes
    try:
        env_model = _mmbt(state)
    finally:
        del os.environ["MMF_TPU_QUANT"]
    for m, k5 in ((model, 0), (env_model, MMBT_K5)):
        check(sum(isinstance(x, Q.QuantDense) for x in m.modules()) == k5,
              f"QuantDense modules, want {k5}")

    # the ResNet features under cuDNN's default (TF32 on) and with TF32
    # off, against the f32 CPU forward
    tf32 = torch.backends.cudnn.allow_tf32
    image = torch.from_numpy(sample["image"][None])
    ref_model = _mmbt(state, dtype="float32")
    encoder = getattr(ref_model, ref_model.encoder_name).eval()
    with torch.inference_mode():
        feat_cpu = encoder(image).numpy()
        encoder.to(DEV)
        feat_tf32 = encoder(image.to(DEV)).cpu().numpy()
        torch.backends.cudnn.allow_tf32 = False
        feat_f32 = encoder(image.to(DEV)).cpu().numpy()
        torch.backends.cudnn.allow_tf32 = tf32
    encoder.cpu()
    scale = float(np.abs(feat_cpu).max())
    tf32_rel = float(np.abs(feat_tf32 - feat_cpu).max()) / scale
    f32_rel = float(np.abs(feat_f32 - feat_cpu).max()) / scale
    check(tf32_rel <= MMBT_TF32_REL, f"ResNet TF32 features rel err "
          f"{tf32_rel} (bound {MMBT_TF32_REL})")
    ref_f32 = cpu_forward(ref_model, sample)
    ref_int8 = cpu_forward(_mmbt(state, quant="int8"), sample)

    runs, launches = {}, dict(ZERO_COUNTS)
    for name, m, k5 in (("bf16", model, 0),
                        ("int8 (config)", _mmbt(state, quant="int8"),
                         MMBT_K5),
                        ("int8 (MMF_TPU_QUANT)", env_model, MMBT_K5)):
        counts, lat, out, dev_ms, by_category = _serve_batch1(m, sample, k5)
        runs[name] = (lat, out, dev_ms, by_category)
        launches = {k: launches[k] + counts[k] for k in launches}
        m.cpu()
        torch.cuda.empty_cache()
    bf16_err = _compare(runs["bf16"][1], ref_f32, "MMBT bf16 vs f32 CPU")
    int8_err = _compare(runs["int8 (config)"][1], ref_int8,
                        "MMBT int8 vs int8 CPU (plain versions)")
    env_err = _compare(runs["int8 (MMF_TPU_QUANT)"][1], ref_int8,
                       "MMBT int8 (MMF_TPU_QUANT) vs int8 CPU")
    info_err = _compare(runs["int8 (config)"][1], ref_f32, "", enforce=False)

    print(f"phase mmbt: ok MMBT-grid {n_params / 1e6:.1f}M params "
          f"(ResNet-152 at 224 px, 12 x {HIDDEN}, 2 labels, bf16 compute) "
          f"at batch 1; launches per forward {MMBT_PER_FORWARD} plus K5 0 "
          f"(bf16) and {MMBT_K5} (int8, by config and by MMF_TPU_QUANT), "
          f"exact over {LATENCY_CALLS} calls each; max_abs_err / pooled "
          f"cosine: bf16 vs f32 CPU {bf16_err[0]:.4g} / {bf16_err[1]:.6f}, "
          f"int8 vs int8 CPU {int8_err[0]:.4g} / {int8_err[1]:.6f}, "
          f"MMF_TPU_QUANT int8 vs int8 CPU {env_err[0]:.4g} / "
          f"{env_err[1]:.6f} (bounds {MMBT_ATOL} / {MMBT_MIN_COSINE}); "
          f"int8 vs f32 CPU (information) {info_err[0]:.4g} / "
          f"{info_err[1]:.6f}")
    print(f"  ResNet-152 convolutions under cudnn.allow_tf32={tf32} "
          f"(cuDNN's default): features max abs err {tf32_rel:.3g} of the "
          f"largest |feature| against f32 on the CPU (bound "
          f"{MMBT_TF32_REL}); {f32_rel:.3g} with TF32 off")
    for name, (lat, _, dev_ms, by_category) in runs.items():
        print(f"  MMBT {name} on '{card}': batch-1 latency p50 "
              f"{np.percentile(lat, 50):.3f} ms, p95 "
              f"{np.percentile(lat, 95):.3f} ms over {LATENCY_CALLS} calls "
              f"(host clock, ServingEngine.predict, outputs on the host); "
              f"device time {dev_ms:.3f} ms per forward (torch.profiler, 5 "
              "forwards): " + "; ".join(
                  f"{cat} {ms:.3f} x{cnt:.0f}" for cat, (ms, cnt) in
                  sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    return launches


# -- phase 6 ---------------------------------------------------------------
def phase_vb_int8(card, serving):
    model = flagship.visual_bert({"quant": "int8"})
    model.load_state_dict(serving["state"], strict=True)
    check(sum(isinstance(m, Q.QuantDense) for m in model.modules())
          == VB_K5, "QuantDense modules")
    engine = ServingEngine(model, device=DEV, max_batch_size=32)
    batch32 = serving["batch32"]
    with _k5_shapes() as shapes:  # K5's shapes, from the warm-up forward
        engine.predict_many(batch32)
    torch.cuda.synchronize()
    reset_counts()  # the main path, counted from zero
    outs = engine.predict_many(batch32)
    torch.cuda.synchronize()
    launches = read_counts()
    want = dict(ZERO_COUNTS, flash_attention_fwd=12, layer_norm=26,
                int8_dequant_gemm=VB_K5)
    check(launches == want, f"VisualBERT int8 launches {launches}, want "
          f"{want}")
    arrays, _ = engine_lib._split_static(engine_lib._stack_samples(batch32))
    dev_batch = engine_lib._to_device(arrays, DEV)
    def forward():
        with torch.inference_mode():
            engine.model(dev_batch)

    fwd_ms = time_ms(forward, iters=5, repeats=3)
    dev_ms, by_category = _device_ms(forward, 3)
    probe = serving["probe"]
    ref_model = flagship.visual_bert({"quant": "int8"})
    ref_model.load_state_dict(serving["state"], strict=True)
    ref = cpu_forward(ref_model, batch32[probe])["scores"]
    got = np.asarray(outs[probe]["scores"], np.float32)
    err = float(np.abs(got - ref).max())
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    check(err <= SERVE_ATOL and cos >= SERVE_MIN_COSINE,
          f"VisualBERT int8 vs int8 CPU: max_abs_err {err}, cosine {cos}")
    info = float(np.abs(got - serving["ref_f32"]).max())
    model.cpu()
    torch.cuda.empty_cache()
    check(sum(shapes.values()) == VB_K5, f"K5 shapes {shapes}")
    k5_lines, k5_total = _k5_per_shape(shapes)
    print(f"phase vb-int8: ok VisualBERT-base quant: int8 at bucket 32; "
          f"launches {launches} (exact per forward); one request's scores "
          f"vs the int8 CPU forward (plain versions) max_abs_err "
          f"{err:.4g} cosine {cos:.6f} (bounds {SERVE_ATOL} / "
          f"{SERVE_MIN_COSINE}); vs the f32 CPU forward (information) "
          f"{info:.4g}")
    print(f"  VisualBERT forward alone at bucket 32 on '{card}': int8 "
          f"{fwd_ms:.2f} ms, bf16 {serving['fwd_ms']:.2f} ms (CUDA "
          f"events); int8 device time {dev_ms:.3f} ms (torch.profiler, 3 "
          "forwards): " + "; ".join(
              f"{cat} {ms:.3f} x{cnt:.0f}" for cat, (ms, cnt) in
              sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    print(f"  K5 at the shapes of one VisualBERT int8 forward at bucket 32 "
          f"(device_ms, each against its plain version): {k5_total:.4f} ms "
          "per forward (launches x ms)")
    print("\n".join(k5_lines))
    return launches, k5_total


@contextlib.contextmanager
def _k5_shapes():
    """Records K5's calls by (M, K, N, output dtype) while active."""
    shapes, kernel = {}, Q.dequant_gemm

    def recording(x8, w8, xs, ws, bias, out_dtype=torch.float32):
        key = (x8.shape[0], x8.shape[1], w8.shape[0], out_dtype)
        shapes[key] = shapes.get(key, 0) + 1
        Q.dequant_gemm = kernel  # the wrapper counts on its own name
        try:
            return kernel(x8, w8, xs, ws, bias, out_dtype)
        finally:
            Q.dequant_gemm = recording

    Q.dequant_gemm = recording
    try:
        yield shapes
    finally:
        Q.dequant_gemm = kernel


def _k5_per_shape(shapes):
    """K5 at each recorded shape: checked against its plain version, timed
    by device_ms beside torch._int_mm; (report lines, ms per forward)."""
    g = torch.Generator(device=DEV).manual_seed(5)
    lines, total = [], 0.0
    for (m, k, n, dt), count in sorted(shapes.items(), key=lambda kv: (
            -kv[1], kv[0][:3])):
        x8, w8, xs, ws, bias = _k5_operands(m, k, n, g)
        out = Q.dequant_gemm(x8, w8, xs, ws, bias, dt)
        torch.cuda.synchronize()
        err = k5_error(out, x8, w8, xs, ws, bias, dt, f"K5 {m}x{k}x{n} {dt}")
        kern = device_ms(lambda: Q.dequant_gemm(x8, w8, xs, ws, bias, dt))
        w8t = w8.t()
        lib = (device_ms(lambda: torch._int_mm(x8, w8t)) if m > 16
               else None)
        b_ms, b_by = bound(_nbytes(x8, w8, xs, ws, bias, out),
                           2 * m * n * k, torch.int8)
        total += count * kern
        lines.append(
            f"    M={m} K={k} N={n} -> {str(dt)[6:]} x{count}: max_abs_err "
            f"{err:.3g}; kernel {kern:.4f} ms "
            f"({2e-9 * m * n * k / kern:.1f} TOP/s), torch._int_mm "
            f"{'n/a' if lib is None else f'{lib:.4f}'}, bound {b_ms:.4f} by "
            f"{b_by}; {Q.k5_tile(m, n)}-wide tiles")
    return lines, total


# -- phase 7 ---------------------------------------------------------------
def _pretrain_config(*opts):
    return flagship.masked_coco_config([
        # the flash kernel has no probabilities to drop (as in JAX)
        "model_config.visual_bert.attention_probs_dropout_prob=0.0",
        # so that the lr is above 0 within the run
        "scheduler.params.num_warmup_steps=2", *opts])


def _pretrainer(cfg, state_dict, seed=0):
    """A StepTrainer for VisualBERT-base pretraining on the card, from
    ``state_dict`` (or fresh seeded weights when None)."""
    model = flagship.vqa2_visual_bert(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    state, step = flagship.masked_coco_trainer(model, cfg, seed=0)
    return StepTrainer(cfg, state, step)


def _training_state(trainer):
    """The parameters, the optimizer state and the step, on the CPU."""
    opt = trainer.optimizer.state_dict()["state"]
    return ({k: v.detach().cpu().clone()
             for k, v in trainer.model.state_dict().items()},
            {i: {k: v.detach().cpu().clone() for k, v in st.items()}
             for i, st in opt.items()},
            trainer.train_state.step)


def _without_dropout(model):
    """MMBT's config names no dropout rate (its trunk takes the
    TransformerConfig default of 0.1, as in JAX, and attention-probability
    dropout routes attention to the plain version): both rates to 0 on
    the built modules, as the VisualBERT phases set them by config."""
    for m in model.modules():
        if isinstance(getattr(m, "config", None), T.TransformerConfig):
            m.config = dataclasses.replace(
                m.config, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
        if isinstance(m, T.Dropout):
            m.rate = 0.0
    return model


def _mmbt_pretrain_step(cfg, state_dict, batch):
    """One MMBT-grid pretraining step from ``state_dict`` at dropout 0:
    (loss, gradients, launch counts)."""
    model = _without_dropout(flagship.mmbt_grid(
        {"training_head_type": "pretraining"}))
    model.load_state_dict(state_dict, strict=True)
    state, step = flagship.vqa2_trainer(model, cfg, seed=1,
                                        meta=MMBT_PRETRAIN_META)
    reset_counts()
    state, rep = step(state, batch)
    loss = float(rep["total_loss"])
    launches = read_counts()
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    del state, step, model
    torch.cuda.empty_cache()
    return loss, grads, launches


def phase_pretrain(card):
    cfg = _pretrain_config()
    mc = cfg["model_config"]["visual_bert"]
    check((mc["training_head_type"], mc["hidden_size"],
           mc["num_hidden_layers"], mc["num_attention_heads"],
           mc["vocab_size"], mc["dtype"], mc["hidden_dropout_prob"],
           mc["attention_probs_dropout_prob"], cfg["optimizer"]["type"],
           cfg["scheduler"]["type"]) == (
        "pretraining", HIDDEN, 12, HEADS, VOCAB, "bfloat16", 0.1, 0.0,
        "adam_w", "warmup_linear"), dict(mc))
    trainer = _pretrainer(cfg, None)
    init = {k: v.detach().cpu().clone()
            for k, v in trainer.model.state_dict().items()}
    n_params = sum(p.numel() for p in trainer.model.parameters())
    host_batch = flagship.masked_coco_train_batch(TRAIN_B, SEQ, REGIONS,
                                                  VDIM, VOCAB, seed=0)
    labelled = int((host_batch["lm_label_ids"] != -1).sum())
    batch = train_state._to_device(host_batch, DEV)

    t0 = time.perf_counter()
    warm_loss = float(trainer.train(batch)["total_loss"])  # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    # the main path, counted from zero
    reset_counts()
    losses, step_ms = [], []
    for _ in range(PRETRAIN_STEPS):
        t0 = time.perf_counter()
        rep = trainer.train(batch)
        losses.append(float(rep["total_loss"]))  # synchronises
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in [warm_loss] + losses)
          and not bool(rep["nan_flag"]), f"pretraining losses {losses}")
    check(list(rep["losses"]) == ["train/masked_coco/masked_lm_loss"],
          f"loss keys {list(rep['losses'])}")
    # per step: 12 attention calls (stats form, K2 and K3, no inference
    # form); 26 LayerNorms (embedding, 24 residual, the MLM head's
    # transform), each a K4 forward and a K4-bwd backward
    per_step = dict(ZERO_COUNTS, flash_attention_fwd_stats=12,
                    flash_attention_bwd_dq=12, flash_attention_bwd_dkv=12,
                    layer_norm=26, layer_norm_bwd=26)
    want = {k: v * PRETRAIN_STEPS for k, v in per_step.items()}
    check(launches == want, f"pretraining launches {launches}, want {want}")

    def one_step():
        trainer.train(batch)

    dev_ms, by_category = _device_ms(one_step, PROFILED_STEPS, gemm_dim=VOCAB)
    best_ms = min(step_ms)
    del trainer, rep
    torch.cuda.empty_cache()

    # kernels vs plain versions: same weights, same batch, dropout 0
    k_losses, k_grads, _, k_launches = _compared_steps(
        cfg, init, batch, PRETRAIN_COMPARED, flagship.masked_coco_trainer)
    with plain_versions():
        p_losses, p_grads, _, p_launches = _compared_steps(
            cfg, init, batch, PRETRAIN_COMPARED,
            flagship.masked_coco_trainer)
    want_k = {k: v * PRETRAIN_COMPARED for k, v in per_step.items()}
    check(k_launches == want_k, f"kernel side launches {k_launches}")
    check(p_launches == ZERO_COUNTS, f"plain side launches {p_launches}")
    loss_rel = _check_losses(k_losses, p_losses)
    compared, g_cos, g_rel, worst_g, worst_r = _check_gradients(k_grads,
                                                                p_grads)
    del k_grads, p_grads
    torch.cuda.empty_cache()

    # checkpoint round trip: save at update 2, a third step; a fresh
    # model, optimizer and schedule resumed from current.ckpt take the
    # same third step
    with tempfile.TemporaryDirectory() as save_dir:
        cfg_a = _pretrain_config(f"env.save_dir={save_dir}")
        trainer = _pretrainer(cfg_a, init)
        for _ in range(2):
            trainer.train(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Checkpoint(trainer).save(2)
        save_s = time.perf_counter() - t0
        saved = _training_state(trainer)
        ckpt_bytes = os.path.getsize(os.path.join(save_dir, "current.ckpt"))
        loss3 = float(trainer.train(batch)["total_loss"])
        del trainer
        torch.cuda.empty_cache()

        cfg_b = _pretrain_config(f"env.save_dir={save_dir}",
                                 "checkpoint.resume=true")
        resumed = _pretrainer(cfg_b, None, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Checkpoint(resumed).load_state_dict()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = _training_state(resumed)
        check(got[2] == saved[2] == 2 and resumed.num_updates == 2,
              f"resumed step {got[2]}, num_updates {resumed.num_updates}")
        for k, v in saved[0].items():
            check(torch.equal(got[0][k], v), f"resumed parameter {k}")
        check(saved[1].keys() == got[1].keys(), "resumed optimizer state")
        for i, st in saved[1].items():
            for k, v in st.items():
                check(torch.equal(got[1][i][k], v),
                      f"resumed optimizer state {i}/{k}")
        resumed_loss3 = float(resumed.train(batch)["total_loss"])
        del resumed
        torch.cuda.empty_cache()
    resume_rel = abs(resumed_loss3 - loss3) / abs(loss3)
    check(resume_rel <= RESUME_LOSS_RTOL,
          f"resumed third loss {resumed_loss3} vs {loss3}")

    # MMBT-grid pretraining, one step through the kernels and one through
    # the plain versions from the same weights
    mmbt = flagship.mmbt_grid({"training_head_type": "pretraining"})
    mmbt.init_weights(torch.Generator().manual_seed(0))
    mmbt_state = {k: v.clone() for k, v in mmbt.state_dict().items()}
    del mmbt
    hm = flagship.hateful_memes_example_batch(MMBT_PRETRAIN_B, seed=0)
    rng = np.random.RandomState(1)
    hm["lm_label_ids"] = np.where(rng.rand(*hm["input_ids"].shape) < 0.15,
                                  hm["input_ids"], -1).astype(np.int32)
    hm_batch = train_state._to_device(hm, DEV)
    mk_loss, mk_grads, mk_launches = _mmbt_pretrain_step(cfg, mmbt_state,
                                                         hm_batch)
    with plain_versions():
        mp_loss, mp_grads, mp_launches = _mmbt_pretrain_step(
            cfg, mmbt_state, hm_batch)
    # per step: the trunk's 12 attention calls; 27 LayerNorms (the
    # embedding LayerNorm on the modal and the text span, 24 residual,
    # the MLM head's transform)
    want_m = dict(per_step, layer_norm=27, layer_norm_bwd=27)
    check(mk_launches == want_m, f"MMBT pretraining launches {mk_launches}, "
          f"want {want_m}")
    check(mp_launches == ZERO_COUNTS, f"MMBT plain launches {mp_launches}")
    mmbt_rel = _check_losses([mk_loss], [mp_loss])
    # the loss is the forward's: the gradients hold K2, K3 and K4-bwd at
    # MMBT's shapes against the plain versions
    m_compared, m_cos, m_rel, m_worst_g, m_worst_r = _check_gradients(
        mk_grads, mp_grads)
    del mk_grads, mp_grads
    launches = {k: launches[k] + mk_launches[k] for k in launches}

    print(f"phase pretrain: ok VisualBERT-base masked LM {n_params / 1e6:.1f}M "
          f"f32 params, bf16 compute, B={TRAIN_B} ({labelled} labelled text "
          f"positions), masked_coco config (AdamW, warmup_linear cut to 2 "
          f"updates); warm-up step {warm_s:.1f}s loss {warm_loss:.4f}; "
          f"{PRETRAIN_STEPS} steps, losses {[round(x, 4) for x in losses]} "
          f"all finite; launches {launches} (exact per step, MMBT's step "
          "included)")
    print(f"  pretraining on '{card}': ms per step "
          f"{[round(x, 2) for x in step_ms]} (best {best_ms:.2f}), "
          f"{TRAIN_B * 1e3 / best_ms:.1f} samples/s at best, "
          f"{TRAIN_B * 1e3 * PRETRAIN_STEPS / sum(step_ms):.1f} mean; device "
          f"time {dev_ms:.2f} ms per step (torch.profiler, 1 step) against "
          f"{best_ms:.2f} ms wall; max_memory_allocated {peak_gb:.2f} GB")
    print("  device time per pretraining step by kind of kernel (ms, "
          "launches; the decoder GEMMs' count is of operators): "
          + "; ".join(f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                      sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    print(f"  kernels vs plain versions, {PRETRAIN_COMPARED} steps at dropout "
          f"0 (launches {k_launches} vs {p_launches}): losses {k_losses} vs "
          f"{p_losses} (max rel {loss_rel:.3g}, bound {TRAIN_LOSS_RTOL}); "
          f"first-step gradients: cosine min {g_cos[worst_g]:.6f} at "
          f"{worst_g} (bound {TRAIN_MIN_GRAD_COSINE}), |g_k - g_p| / |g_p| "
          f"max {g_rel[worst_r]:.3g} at {worst_r} (bound "
          f"{TRAIN_MAX_GRAD_REL}); {len(compared)} parameters compared")
    print(f"  checkpoint round trip: current.ckpt {ckpt_bytes / 1e6:.1f} MB "
          f"(model, AdamW state, schedule, counts, step, config); "
          f"Checkpoint.save {save_s:.2f}s, Checkpoint.load_state_dict into "
          f"a fresh model on the card {load_s:.2f}s (host clock); "
          "parameters, optimizer state and step bit-equal; third-step loss "
          f"{loss3!r} uninterrupted vs {resumed_loss3!r} resumed (rel "
          f"{resume_rel:.3g}, bound {RESUME_LOSS_RTOL}; bit-equal: "
          f"{resumed_loss3 == loss3})")
    print(f"  MMBT-grid pretraining step at B={MMBT_PRETRAIN_B} (ResNet-152 "
          f"at 224 px, 12 x {HIDDEN}, dropout 0): loss {mk_loss!r} through "
          f"the kernels vs {mp_loss!r} through the plain versions (rel "
          f"{mmbt_rel:.3g}, bound {TRAIN_LOSS_RTOL}); gradients: cosine min "
          f"{m_cos[m_worst_g]:.6f} at {m_worst_g} (bound "
          f"{TRAIN_MIN_GRAD_COSINE}), |g_k - g_p| / |g_p| max "
          f"{m_rel[m_worst_r]:.3g} at {m_worst_r} (bound {TRAIN_MAX_GRAD_REL}); "
          f"{len(m_compared)} parameters compared; launches {mk_launches}")
    return launches


# -- phase 8 ---------------------------------------------------------------
def phase_serve_ckpt(card, trained):
    from mmf_tpu_torch.cli import serve as serve_cli

    cfg = trained["config"]
    samples = flagship.split_samples(flagship.example_batch(
        SERVE_B, SEQ, REGIONS, VDIM, seed=3))
    probe = 5
    samples[probe]["image_info_0"]["max_features"] = np.int32(37)
    bodies = [_fields_body(s) for s in samples]
    opts = ["port=0", f"max_batch_size={SERVE_B}"]
    with tempfile.TemporaryDirectory() as save_dir:
        cfg["env"]["save_dir"] = save_dir
        model = flagship.vqa2_visual_bert(cfg)
        model.load_state_dict(trained["state"], strict=True)
        t0 = time.perf_counter()
        Checkpoint(types.SimpleNamespace(config=cfg, model=model)).finalize()
        final_s = time.perf_counter() - t0
        files = sorted(os.listdir(save_dir))
        check(files == ["config.yaml", "models", "visual_bert_final.pth"],
              f"checkpoint folder {files}")
        final_bytes = os.path.getsize(os.path.join(save_dir, files[-1]))
        # the same weights served from memory
        ref_engine = ServingEngine(model, device=DEV, max_batch_size=SERVE_B)
        ref = ref_engine.predict_many(samples)

        reset_counts()  # the main path, counted from zero
        t0 = time.perf_counter()
        server = serve_cli.build_server(serve_cli.parse_opts(
            [f"checkpoint={save_dir}", *opts])).start()
        try:
            replies, done_at = [None] * SERVE_B, [None] * SERVE_B

            def send(i):
                replies[i] = _request(server.port, bodies[i])
                done_at[i] = time.perf_counter()

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(SERVE_B)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            torch.cuda.synchronize()
            launches = read_counts()
            check(not any(t.is_alive() for t in threads), "a request hung")
            first_s = min(done_at) - t0
            batches = server.stats()["batcher"]["batches"]
            # the same bucket as the engine in memory
            same_bucket = server.engine.predict_many(samples)
        finally:
            server.shutdown()
        want = dict(ZERO_COUNTS, flash_attention_fwd=12 * batches,
                    layer_norm=26 * batches)
        check(batches >= 1 and launches == want,
              f"served-checkpoint launches {launches}, want {want} for "
              f"{batches} batch(es)")
        errs, coss, ulps = [], [], []
        for (status, payload, _), r in zip(replies, ref):
            check(status == 200, payload)
            got = np.asarray(payload["scores"], np.float32)
            check(got.shape == (3129,) and np.isfinite(got).all(),
                  f"scores shape {got.shape}")
            want_s = np.asarray(r["scores"], np.float32)
            errs.append(float(np.abs(got - want_s).max()))
            # bf16 keeps 8 significant bits
            ulp = 2.0 ** (math.floor(math.log2(np.abs(want_s).max())) - 7)
            ulps.append(errs[-1] / ulp)
            coss.append(float(got @ want_s / (np.linalg.norm(got)
                                              * np.linalg.norm(want_s))))
        check(max(ulps) <= SERVE_BATCH_ULPS
              and min(coss) >= SERVE_BATCH_MIN_COSINE,
              f"served checkpoint vs in-memory engine: max_abs_err "
              f"{max(errs)} ({max(ulps)} bf16 ulps of the largest score), "
              f"cosine {min(coss)}")
        http_equal = max(errs) == 0.0
        # the same samples in the same order at the same bucket: the
        # weights loaded from the file are the ones in memory, bit for bit
        bucket_equal = all(np.array_equal(a["scores"], b["scores"])
                           for a, b in zip(same_bucket, ref))
        check(bucket_equal, "the served engine at bucket 32 is not "
              "bit-equal to the in-memory engine on the same samples")
        del server, ref_engine, model, same_bucket
        torch.cuda.empty_cache()

        # the same checkpoint under quant=int8 (mmf_serve sets
        # MMF_TPU_QUANT before the model is built)
        prior = os.environ.get("MMF_TPU_QUANT")
        try:
            server = serve_cli.build_server(serve_cli.parse_opts(
                [f"checkpoint={save_dir}", "quant=int8", *opts])).start()
            try:
                check(sum(isinstance(m, Q.QuantDense)
                          for m in server.engine.model.modules()) == VB_K5,
                      "QuantDense modules")
                server.engine.predict_many(samples)  # warm-up
                torch.cuda.synchronize()
                reset_counts()
                outs8 = server.engine.predict_many(samples)
                torch.cuda.synchronize()
                launches8 = read_counts()
            finally:
                server.shutdown()
        finally:
            if prior is None:
                os.environ.pop("MMF_TPU_QUANT", None)
            else:
                os.environ["MMF_TPU_QUANT"] = prior
    want8 = dict(ZERO_COUNTS, flash_attention_fwd=12, layer_norm=26,
                 int8_dequant_gemm=VB_K5)
    check(launches8 == want8, f"int8 served-checkpoint launches "
          f"{launches8}, want {want8}")
    ref_model = flagship.vqa2_visual_bert(cfg, {"quant": "int8"})
    ref_model.load_state_dict(trained["state"], strict=True)
    ref8 = cpu_forward(ref_model, samples[probe])["scores"]
    got8 = np.asarray(outs8[probe]["scores"], np.float32)
    err8 = float(np.abs(got8 - ref8).max())
    cos8 = float(got8 @ ref8 / (np.linalg.norm(got8) * np.linalg.norm(ref8)))
    check(err8 <= SERVE_ATOL and cos8 >= SERVE_MIN_COSINE,
          f"int8 served checkpoint vs int8 CPU: max_abs_err {err8}, "
          f"cosine {cos8}")
    del server, outs8
    torch.cuda.empty_cache()
    print(f"phase serve-ckpt: ok the training phase's VisualBERT-base "
          f"through Checkpoint.finalize ({final_bytes / 1e6:.1f} MB "
          f"visual_bert_final.pth and config.yaml, {final_s:.2f}s) and "
          f"mmf_serve (cli/serve.py build_server, port 0, max_batch_size "
          f"{SERVE_B}); {SERVE_B} concurrent requests all 200, scores "
          f"[3129] finite, {batches} batch(es); launches {launches} (exact "
          f"per forward); vs a ServingEngine on the same weights in memory: "
          f"max_abs_err {max(errs):.4g} ({max(ulps):g} bf16 ulps of the "
          f"largest score), cosine min {min(coss):.6f} (bounds "
          f"{SERVE_BATCH_ULPS} ulps / {SERVE_BATCH_MIN_COSINE}; HTTP answers "
          f"bit-equal: {http_equal}; bit-equal at the same bucket 32: "
          f"{bucket_equal})")
    print(f"  mmf_serve on '{card}': build_server to the first answer "
          f"{first_s:.2f}s (host clock: config and weights loaded, model "
          "moved and cast, first forward); quant=int8: launches at bucket "
          f"32 {launches8} (exact); one answer vs the int8 CPU forward "
          f"max_abs_err {err8:.4g} cosine {cos8:.6f} (bounds {SERVE_ATOL} / "
          f"{SERVE_MIN_COSINE})")
    return {k: launches[k] + launches8[k] for k in launches}


# -- phase 9 ---------------------------------------------------------------
RUN_B = 64
RUN_UPDATES = 8
RUN_EVAL_INTERVAL = 4
RUN_SPLITS = {"train": 640, "val": 128, "test": 64}
RUN_IMAGES = 160
RUN_ANSWERS = 3129
RUN_WORKERS = 4
# the loader in the main process, for runs whose loader no number reads:
# starting and stopping 4 workers for each of a run's three loaders, and
# passing 200-420 MB batches of regions through their shared memory and
# the pinning thread, costs more than the few batches they load
LOADER_IN_PROCESS = ("training.num_workers=0", "training.pin_memory=false")
# the CLI's update is the train step's: bit-equal losses expected
RUN_LOSS_RTOL = 1e-6
RUN_LOSS_KEY = "train/vqa2/logit_bce"


RUN_POINTS = ("Batch load time", "Batch prepare time", "Step dispatch time",
              "Finished update")  # the profiling mixin's, in loop order


class _RunProbe(Callback):
    """A user callback of the ``mmf-run`` phase (registered as
    ``chip_smoke_probe``): the initial weights, when each update's loss
    reached the host, the profiling mixin's latest timing points at each
    update, the validations' meters, and a torch.profiler capture of
    updates 2 and 3. It moves itself to the head of the callbacks, so
    that it hears ``on_update_end`` before the checkpoint callback
    writes."""

    def __init__(self, config, trainer):
        super().__init__(config, trainer)
        self.loss_read = {}
        self.points = {}
        self.val_meters = []
        self.initial = None
        self.prof = None
        self.prof_window = None

    def on_init_end(self, **kwargs):
        self.initial = {k: v.detach().to("cpu", copy=True)
                        for k, v in self.trainer.model.state_dict().items()}
        self.trainer.callbacks.remove(self)
        self.trainer.callbacks.insert(0, self)

    def on_update_end(self, **kwargs):
        n = self.trainer.num_updates
        meters = self.trainer.profile_meter.meters
        self.points[n] = {k: meters[k].get_latest() for k in RUN_POINTS
                          if meters[k].averaged_value_deque}
        if n == 1:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.prof_window = [time.perf_counter()]
        elif n == 3:
            torch.cuda.synchronize()
            self.prof_window.append(time.perf_counter())
            self.prof.__exit__(None, None, None)
        # log_interval 1: the loss was read, so the device is done
        self.loss_read[n] = time.perf_counter()

    def on_validation_end(self, **kwargs):
        self.val_meters.append(kwargs["meter"])


def _run_opts(root, save_dir):
    from tests.torch_vqa2_layout import layout_opts

    return [
        "config=projects/visual_bert/configs/vqa2/defaults.yaml",
        "model=visual_bert", "dataset=vqa2",
        f"env.save_dir={save_dir}", f"training.batch_size={RUN_B}",
        f"training.max_updates={RUN_UPDATES}",
        f"training.evaluation_interval={RUN_EVAL_INTERVAL}",
        f"training.checkpoint_interval={RUN_EVAL_INTERVAL}",
        "training.log_interval=1", f"training.num_workers={RUN_WORKERS}",
        "training.pin_memory=true", "training.seed=1",
        "scheduler.params.num_warmup_steps=2",
        # the flash kernel has no probabilities to drop (as in JAX)
        "model_config.visual_bert.attention_probs_dropout_prob=0.0",
        "run_type=train_val_inference", "evaluation.predict=true",
        "training.callbacks=[{type: chip_smoke_probe}]",
    ] + layout_opts(root)


def phase_mmf_run(card, training):
    """``mmf_run`` (``cli.run.run``, in the process) trains, evaluates and
    predicts VisualBERT-base on the synthetic VQA2 layout."""
    import shutil

    from mmf_tpu_torch.cli.run import run
    from mmf_tpu_torch.common.registry import registry
    from tests.torch_vqa2_layout import write_layout

    registry.register_callback("chip_smoke_probe")(_RunProbe)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mmf_run_")
    trainer = None
    try:
        t0 = time.perf_counter()
        write_layout(tmp, n_train=RUN_SPLITS["train"],
                     n_val=RUN_SPLITS["val"], n_test=RUN_SPLITS["test"],
                     n_images=RUN_IMAGES, regions=REGIONS, feature_dim=VDIM,
                     num_answers=RUN_ANSWERS, vocab_size=VOCAB, seed=0)
        layout_s = time.perf_counter() - t0
        save_dir = os.path.join(tmp, "save")

        # the main path, counted from zero
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer = run(_run_opts(tmp, save_dir))
        run_s = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        probe = next(cb for cb in trainer.callbacks
                     if isinstance(cb, _RunProbe))
        return _mmf_run_checks(card, training, trainer, probe, launches,
                               t0, run_s, layout_s, peak_gb, save_dir)
    finally:
        # the phase iterated the loaders again after the run
        if trainer is not None:
            trainer.teardown()
        shutil.rmtree(tmp, ignore_errors=True)


def _mmf_run_checks(card, training, trainer, probe, launches, t0, run_s,
                    layout_s, peak_gb, save_dir):
    import glob

    from tests.torch_vqa2_layout import SPLITS

    # updates 6 and 7 run clear of the profiler, the validations and the
    # checkpoint writes; a point of update n is the latest at its end,
    # but "Finished update" is recorded after it, so it is read at n + 1
    split = {k: 1e3 * float(np.mean([
        probe.points[n + (k == "Finished update")][k] for n in (6, 7)]))
        for k in RUN_POINTS}
    mc = trainer.config["model_config"]["visual_bert"]
    check((mc["hidden_size"], mc["num_hidden_layers"],
           mc["num_attention_heads"], mc["num_labels"], mc["dtype"])
          == (HIDDEN, 12, HEADS, RUN_ANSWERS, "bfloat16"), dict(mc))
    losses = list(trainer.meter.meters[RUN_LOSS_KEY].averaged_value_deque)
    check(sorted(probe.loss_read) == list(range(1, RUN_UPDATES + 1))
          and len(losses) == RUN_UPDATES
          and all(math.isfinite(x) for x in losses),
          f"updates {sorted(probe.loss_read)}, losses {losses}")

    # per update 12 K1-lse, 12 K2, 12 K3, 26 K4, 26 K4-bwd; per eval
    # forward 12 K1 and 26 K4: two validations and the val prediction
    # report over 128 questions (2 batches each) and the test one over 64
    val_batches = -(-RUN_SPLITS["val"] // RUN_B)
    forwards = (2 * val_batches + val_batches
                + -(-RUN_SPLITS["test"] // RUN_B))
    want = dict(ZERO_COUNTS, flash_attention_fwd=12 * forwards,
                flash_attention_fwd_stats=12 * RUN_UPDATES,
                flash_attention_bwd_dq=12 * RUN_UPDATES,
                flash_attention_bwd_dkv=12 * RUN_UPDATES,
                layer_norm=26 * (RUN_UPDATES + forwards),
                layer_norm_bwd=26 * RUN_UPDATES)
    check(launches == want, f"mmf-run launches {launches}, want {want}")

    # the run folder and the reports
    files = {os.path.relpath(f, save_dir) for f in glob.glob(
        os.path.join(save_dir, "**"), recursive=True)}
    for name in ("config.yaml", "current.ckpt", "best.ckpt",
                 "models/model_4.ckpt", "models/model_8.ckpt",
                 "visual_bert_final.pth"):
        check(name in files, f"{name} missing from the run folder {files}")
    check(any(f.startswith("logs/train_") for f in files), f"logs {files}")
    reports = {split: json.load(open(f)) for split in ("val", "test")
               for f in glob.glob(os.path.join(save_dir, "reports",
                                               f"vqa2_*_{split}_*.json"))}
    test_ids = [int(r["question_id"]) for r in np.load(os.path.join(
        save_dir, "..", "datasets", "vqa2", "defaults", "annotations",
        SPLITS["test"]), allow_pickle=True)[1:]]
    check(sorted(int(r["question_id"]) for r in reports["test"])
          == sorted(test_ids), f"test report {len(reports['test'])} rows")
    check(len(reports["val"]) == RUN_SPLITS["val"],
          f"val report {len(reports['val'])} rows")
    accuracy = [m.meters["val/vqa2/vqa_accuracy"].global_avg
                for m in probe.val_meters]
    check(len(accuracy) == RUN_UPDATES // RUN_EVAL_INTERVAL
          and all(0.0 <= a <= 1.0 for a in accuracy), f"accuracy {accuracy}")

    # the loader alone: epoch 1's first batches, the ones the run took,
    # once its workers run again (the run stopped them at its end; a
    # restarted epoch keeps them); then one batch's work in this process:
    # its samples (the region features' reads apart) and their collation
    loader = trainer.train_loader
    t1 = time.perf_counter()
    next(iter(loader))
    restart_s = time.perf_counter() - t1
    loader.seed_sampler(1)
    t1 = time.perf_counter()
    batches = [b for _, b in zip(range(RUN_UPDATES), loader)]
    loader_bps = RUN_UPDATES / (time.perf_counter() - t1)
    dataset = trainer.dataset_loader.datamodules["vqa2"].train_dataset
    t1 = time.perf_counter()
    samples = [dataset[i] for i in range(RUN_B)]
    t2 = time.perf_counter()
    SampleList(samples)
    t3 = time.perf_counter()
    for i in range(RUN_B, 2 * RUN_B):
        dataset.features_db[i]
    t4 = time.perf_counter()
    batch_ms = {"samples": 1e3 * (t2 - t1), "collate": 1e3 * (t3 - t2),
                "features alone": 1e3 * (t4 - t3)}

    # the CLI's evaluation loop alone, on the trained model, its loader's
    # workers running
    next(iter(trainer.val_loader))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    report, _ = trainer.evaluation_loop("val")
    eval_sps = report.batch_size / (time.perf_counter() - t1)
    check(report.batch_size == RUN_SPLITS["val"]
          and report["scores"].shape == (RUN_SPLITS["val"], RUN_ANSWERS),
          f"val scored {report.batch_size} samples")

    # the trainer adds nothing: the train step alone on the same weights
    # and batches gives the same losses
    cfg = trainer.config
    seed = int(cfg["training"]["seed"])
    model = flagship.vqa2_visual_bert(cfg)
    model.load_state_dict(probe.initial, strict=True)
    state, step = flagship.vqa2_trainer(model, cfg, seed=seed, device=DEV)
    step_losses = []
    for batch in batches:
        state, rep = step(state, batch.pytree())
        step_losses.append(float(rep["losses"][RUN_LOSS_KEY]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, step_losses))
    check(loss_rel <= RUN_LOSS_RTOL,
          f"mmf_run losses {losses} vs the train step's {step_losses}")
    del state, step, model, rep, batches
    torch.cuda.empty_cache()

    # update n's time: from update n-1's loss on the host to update n's
    # (batch load, H2D, dispatch, device, loss read); updates 2 and 3 are
    # profiled, and update 5's interval holds update 4's checkpoint
    # writes and validation, so the rate is over updates 4, 6, 7 and 8
    t = probe.loss_read
    interval = {n: t[n] - t[n - 1] for n in range(2, RUN_UPDATES + 1)}
    steady = [n for n in range(4, RUN_UPDATES + 1)
              if (n - 1) % RUN_EVAL_INTERVAL]
    cli_sps = RUN_B * len(steady) / sum(interval[n] for n in steady)
    update_ms = 1e3 * sum(interval[n] for n in steady) / len(steady)
    # the device time of updates 2 and 3 (profiled: the profiler's own
    # host cost slows their wall time, so the idle share is taken
    # against the unprofiled updates' mean time)
    dev_ms, by_category = _by_category(probe.prof, 2)
    profiled_ms = 1e3 * (probe.prof_window[1] - probe.prof_window[0]) / 2

    print(f"phase mmf-run: ok python -m mmf_tpu_torch.cli.run's run(opts) "
          f"in the process, VisualBERT-base (12 x 768, 12 heads, 3129 "
          f"answers, bf16 compute), B={RUN_B}, {RUN_WORKERS} loader workers, "
          f"pinned; synthetic VQA2 layout ({RUN_SPLITS} questions over "
          f"{RUN_IMAGES} images, [{REGIONS}, {VDIM}] f32 features a "
          f"region file, written in {layout_s:.1f}s); {RUN_UPDATES} updates, "
          f"losses {[round(x, 4) for x in losses]} all finite; launches "
          f"{launches} (exact: 12/12/12/26/26 an update, 12 K1 + 26 K4 in "
          f"each of {forwards} eval forwards); val vqa_accuracy "
          f"{[round(a, 4) for a in accuracy]}; reports {len(reports['val'])} "
          f"val and {len(reports['test'])} test rows; run folder complete; "
          f"the train step alone on the CLI's weights and batches: losses "
          f"{step_losses} (max rel {loss_rel:.3g}, bound {RUN_LOSS_RTOL})")
    print(f"  mmf-run on '{card}': train {cli_sps:.1f} samples/s over "
          f"updates {steady} (their intervals "
          f"{[round(1e3 * interval[n], 1) for n in steady]} ms; update 5's "
          f"{1e3 * interval[5]:.0f} ms holds update 4's checkpoint writes "
          f"and validation) beside the training phase's "
          f"{training['samples_per_s']:.1f} samples/s (its mean, this run); "
          f"train loader alone {loader_bps:.1f} batches/s "
          f"({RUN_B * loader_bps:.0f} samples/s; {RUN_WORKERS} workers "
          f"forked anew and their first batch {restart_s:.2f}s; one batch "
          f"in this process, "
          f"ms: " + ", ".join(f"{k} {v:.1f}" for k, v in batch_ms.items())
          + f"); host split of an update "
          f"(ms, mean of updates 6 and 7, TrainerProfilingMixin): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f"; device time {dev_ms:.2f} ms an update (torch.profiler, "
          f"updates 2-3, whose wall time under the profiler was "
          f"{profiled_ms:.2f} ms) in the unprofiled updates' "
          f"{update_ms:.2f} ms: idle {100 * (1 - dev_ms / update_ms):.1f}%; "
          f"eval {eval_sps:.1f} "
          f"samples/s (the evaluation loop over {RUN_SPLITS['val']} val "
          f"questions); first "
          f"update's loss on the host {probe.loss_read[1] - t0:.1f}s after "
          f"run() began (cold: config, datasets, model build and init, "
          f"workers, first step); whole run {run_s:.1f}s; "
          f"max_memory_allocated {peak_gb:.2f} GB")
    print("  device time per update by kind of kernel (ms, launches): "
          + "; ".join(f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                      sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    return launches


# -- phases 10-13: ViLBERT-base ---------------------------------------------
VB_HEADS, VB_HEAD_DIM = 8, 128  # ViLBERT's image stream and co-attention
# ViLBERT's attention shapes at D = 128 (B, Sq, Skv): image self-attention
# over the regions, text queries over the regions, region queries over
# the text
VILBERT_SHAPES = {"image self 100x100": (TRAIN_B, REGIONS, REGIONS),
                  "text queries 128x100": (TRAIN_B, SEQ, REGIONS),
                  "region queries 100x128": (TRAIN_B, REGIONS, SEQ),
                  # a served bucket of 8: 128 items, fewer than the 132 SMs
                  "text queries 128x100 bucket 8": (8, SEQ, REGIONS)}
# per forward: 12 text and 6 image self-attention calls, 2 cross calls in
# each of 6 co-attention layers; 60 residual LayerNorms (2 a text or image
# layer, 4 a co-attention layer) and 3 without (the text and image
# embeddings, the classifier transform; the pretraining head has the MLM
# transform's and the image head's in place of the last)
VILBERT_ATTENTION = 12 + 6 + 2 * 6
VILBERT_LN = 2 * 12 + 2 * 6 + 4 * 6 + 3
VILBERT_PRETRAIN_LN = VILBERT_LN + 1
VILBERT_STEPS = 4
VILBERT_NO_DROPOUT = (("hidden_dropout_prob", 0.0),
                      ("v_hidden_dropout_prob", 0.0))
# the three attention-probability rates (text, image, co-attention) to 0:
# the kernels have no probabilities to drop (as in JAX)
VILBERT_CUTS = [f"model_config.vilbert.{k}=0.0" for k in (
    "attention_probs_dropout_prob", "v_attention_probs_dropout_prob")]
# kernels-vs-f32 gradient over plain-vs-f32 where the plain bf16 gradient
# is itself beyond TRAIN_MAX_GRAD_REL of the f32 one (both are rounding
# noise there): the kernels may add error independent of the plain path's
# up to sqrt(1.5^2 - 1) = 1.1 times its size
VILBERT_NOISY_RATIO = 1.5
VILBERT_RUN_UPDATES = 4
VILBERT_PRETRAIN_UPDATES = 3


def _attention_case(name, q, k, v, bias, dout, iters=20, plain_iters=20,
                    repeats=5):
    """K1, K1-stats, K2 and K3 on (q, k, v, bias, dO): errors against the
    plain versions, K2 and K3 bit-equal across two calls, device times
    (``iters`` calls, half for SDPA's backward, best of ``repeats``)
    beside SDPA's and the plain versions' (``plain_iters``), host time a
    call, and the bound."""
    dt = q.dtype
    b, heads, sq, head_dim = q.shape
    skv = k.shape[2]
    out = A.flash_attention(q, k, v, bias)
    out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
    dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l, dout)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
    torch.cuda.synchronize()
    ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
    err = max_err(out, ref_out, dt)
    check(torch.equal(out, out_s), f"{name}: stats form != inference form")
    torch.testing.assert_close(m, ref_m, **STATS_TOL)
    torch.testing.assert_close(l, ref_l, **STATS_TOL)
    err_s = max(err, float((m - ref_m).abs().max()),
                float((l - ref_l).abs().max()))
    ref = A.flash_backward_reference(q, k, v, bias, out_s, m, l, dout)
    errs = [rel_err(got, want, GRAD_REL[dt], f"{n} {name}")
            for n, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)]
    del ref, ref_out
    # no atomics: a second call gives the same bits
    dq2, delta2 = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l, dout)
    again = (dq2, delta2) + A.flash_attention_bwd_dkv(q, k, v, bias, dout, m,
                                                      l, delta2)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip((dq, delta, dk, dv), again)),
          f"{name}: backward not bit-equal across calls")
    del dq2, delta2, again
    calls = {
        "K1": lambda: A.flash_attention(q, k, v, bias),
        "K1-stats": lambda: A.flash_attention_with_stats(q, k, v, bias),
        "K2": lambda: A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l,
                                               dout),
        "K3": lambda: A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l,
                                                delta),
        "sdpa fwd": lambda: F.scaled_dot_product_attention(q, k, v,
                                                           attn_mask=bias),
        "sdpa fwd+lse": _sdpa_with_lse(q, k, v, bias),
        "sdpa bwd": _sdpa_backward(q, k, v, bias, dout),
    }
    dev = {n: device_ms(fn, iters=max(iters // 2, 1) if n == "sdpa bwd"
                        else iters, repeats=repeats)
           for n, fn in calls.items()}
    host = {n: host_us(calls[n], iters=10)
            for n in ("K1", "K1-stats", "K2", "K3")}
    plain = {"K1": time_ms(lambda: A.mha_reference(q, k, v, bias),
                           iters=plain_iters, repeats=repeats),
             "K1-stats": time_ms(
                 lambda: A.flash_forward_reference(q, k, v, bias),
                 iters=plain_iters, repeats=repeats),
             "K2+K3": time_ms(lambda: A.flash_backward_reference(
                 q, k, v, bias, out_s, m, l, dout),
                 iters=max(plain_iters // 2, 1), repeats=repeats)}
    # each input read once, each output written once; FLOPs of the
    # products (2 per multiply-add): QK^T and PV forward, QK^T, dO V^T and
    # dS K for dq, QK^T, dO V^T, P^T dO and dS^T Q for dk and dv. f32 is
    # held to the least time at f32 accuracy: its products as split-TF32
    # on the tensor cores (plain TF32 would round the inputs); the bound
    # of the same work on the FP32 FMA units beside it
    sq_b, kv_b, st = _nbytes(q), _nbytes(k), _nbytes(m)
    pairs = b * heads * sq * skv * head_dim
    work = {"K1": (2 * sq_b + 2 * kv_b + _nbytes(bias), 4 * pairs),
            "K1-stats": (2 * sq_b + 2 * kv_b + _nbytes(bias) + 2 * st,
                         4 * pairs),
            "K2": (4 * sq_b + 2 * kv_b + _nbytes(bias) + 3 * st, 6 * pairs),
            "K3": (2 * sq_b + 4 * kv_b + _nbytes(bias) + 3 * st, 8 * pairs)}
    if dt == torch.float32:
        bounds = {n: max((1e3 * nb / HBM_BYTES_PER_S, "bytes"), (
            1e3 * SPLIT_TF32_PRODUCTS * fl / TF32_FLOPS, "operations"))
            for n, (nb, fl) in work.items()}
        fma = {n: bound(nb, fl, dt)[0] for n, (nb, fl) in work.items()}
    else:
        bounds = {n: bound(nb, fl, dt) for n, (nb, fl) in work.items()}
        fma = None
    return {"shape": [b, heads, sq, skv, head_dim],
            "max_abs_err": {"K1": err, "K1-stats": err_s, "K2": errs[0],
                            "K3": max(errs[1:])},
            "ms": {n: dev[n] for n in ("K1", "K1-stats", "K2", "K3")},
            "host_us": host,
            "library_ms": {"K1": dev["sdpa fwd"],
                           "K1-stats": dev["sdpa fwd+lse"],
                           "K2+K3": dev["sdpa bwd"]},
            "plain_ms": plain,
            "bound_ms": {n: v[0] for n, v in bounds.items()},
            "bound_by": {n: v[1] for n, v in bounds.items()},
            "fma_bound_ms": fma}


def phase_vilbert_kernels(card):
    g = torch.Generator(device=DEV).manual_seed(5)
    rows = {name: _attention_case(name, *_attention_inputs(
                b, sq, skv, torch.bfloat16, g, VB_HEADS, VB_HEAD_DIM))
            for name, (b, sq, skv) in VILBERT_SHAPES.items()}
    print(f"phase vilbert-kernels: ok K1, K1-stats, K2 and K3 at ViLBERT's "
          f"shapes (bf16, B={TRAIN_B} and a bucket of 8, H={VB_HEADS}, "
          f"D={VB_HEAD_DIM}, a "
          "padding mask over the keys, Skv = 100 ragged against the 64-row "
          "tiles) against their plain versions within the kernels phase's "
          "bounds; device ms (spin-queued) beside SDPA's, the plain "
          f"versions' (CUDA events) and the bound, on '{card}':")
    for name, r in rows.items():
        ms, lib = r["ms"], r["library_ms"]
        print(f"  {name} {r['shape']}: max_abs_err " + ", ".join(
            f"{n} {e:.3g}" for n, e in r["max_abs_err"].items())
            + "; K1 " + f"{ms['K1']:.4f} (sdpa {lib['K1']:.4f}, plain "
            f"{r['plain_ms']['K1']:.4f}, bound {r['bound_ms']['K1']:.4f} "
            f"{r['bound_by']['K1']}), K1-stats {ms['K1-stats']:.4f} (sdpa "
            f"fwd+lse {lib['K1-stats']:.4f}, plain "
            f"{r['plain_ms']['K1-stats']:.4f}, bound "
            f"{r['bound_ms']['K1-stats']:.4f}), K2 {ms['K2']:.4f} (bound "
            f"{r['bound_ms']['K2']:.4f}), K3 {ms['K3']:.4f} (bound "
            f"{r['bound_ms']['K3']:.4f}), K2+K3 {ms['K2'] + ms['K3']:.4f} "
            f"(sdpa bwd {lib['K2+K3']:.4f}, plain {r['plain_ms']['K2+K3']:.4f})"
            "; host us " + ", ".join(f"{n} {u:.1f}"
                                     for n, u in r["host_us"].items()))
    return rows


def _vilbert_config(*opts):
    return flagship.vqa2_vilbert_config([*VILBERT_CUTS, *opts])


def _check_vilbert_config(mc, head="classification"):
    check((mc["training_head_type"], mc["hidden_size"],
           mc["num_hidden_layers"], mc["num_attention_heads"],
           mc["v_hidden_size"], mc["v_num_hidden_layers"],
           mc["v_num_attention_heads"], mc["v_intermediate_size"],
           mc["bi_hidden_size"], mc["bi_num_attention_heads"],
           len(mc["v_biattention_id"]), mc["dtype"]) == (
        head, HIDDEN, 12, HEADS, 1024, 6, VB_HEADS, 1024, 1024, VB_HEADS, 6,
        "bfloat16"), dict(mc))


def phase_vilbert_serving(card):
    """ViLBERT-base from the VQA2 config behind ServingEngine: every
    bucket 1-32 once, counted; one sample against the f32 CPU forward."""
    cfg = _vilbert_config()
    model = flagship.vqa2_vilbert(cfg)
    _check_vilbert_config(model.config)
    check(model.config["num_labels"] == 3129, "num_labels")
    model.init_weights(torch.Generator().manual_seed(0))
    cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    samples = flagship.split_samples(flagship.vilbert_example_batch(
        SERVE_B, SEQ, REGIONS, VDIM, seed=7))
    engine = ServingEngine(model, device=DEV, max_batch_size=SERVE_B)
    t0 = time.perf_counter()
    warmed = engine.warmup(samples[0])
    warm_s = time.perf_counter() - t0

    reset_counts()  # the main path, counted from zero
    outs = {b: engine.predict_many(samples[:b]) for b in engine.buckets}
    torch.cuda.synchronize()
    launches = read_counts()
    n = len(engine.buckets)
    want = dict(ZERO_COUNTS, flash_attention_fwd=VILBERT_ATTENTION * n,
                layer_norm=VILBERT_LN * n)
    check(launches == want, f"vilbert serving launches {launches}, want "
          f"{want} for buckets {engine.buckets}")
    for b, rows in outs.items():
        check(all(r["scores"].shape == (3129,) and np.isfinite(
            r["scores"]).all() for r in rows), f"bucket {b} scores")

    ref_model = flagship.vqa2_vilbert(cfg, {"dtype": "float32"})
    ref_model.load_state_dict(cpu_state, strict=True)
    probe = 3
    ref = cpu_forward(ref_model, samples[probe])["scores"]
    errs, coss = [], []
    for b in (4, SERVE_B):  # the probe in two buckets
        got = np.asarray(outs[b][probe]["scores"], np.float32)
        errs.append(float(np.abs(got - ref).max()))
        coss.append(float(got @ ref / (np.linalg.norm(got)
                                       * np.linalg.norm(ref))))
    check(max(errs) <= SERVE_ATOL and min(coss) >= SERVE_MIN_COSINE,
          f"vilbert served vs f32 CPU: max_abs_err {errs}, cosine {coss}")
    del ref_model

    arrays, _ = engine_lib._split_static(engine_lib._stack_samples(samples))
    dev_batch = engine_lib._to_device(arrays, DEV)

    def forward():
        with torch.inference_mode():
            engine.model(dev_batch)

    fwd_ms = time_ms(forward, iters=5, repeats=3)
    dev_ms, by_category = _device_ms(forward, 3)
    del engine, model
    torch.cuda.empty_cache()
    print(f"phase vilbert-serving: ok ViLBERT-base {n_params / 1e6:.1f}M "
          f"params (12 x {HIDDEN} text, 6 x 1024 image with {VB_HEADS} heads "
          f"of {VB_HEAD_DIM}, 6 co-attention layers at 1024, 3129 answers), "
          f"bf16, built from {flagship.VILBERT_VQA2_CONFIG} with "
          "flagship.VILBERT_VQA2_OVERRIDES; warmup buckets "
          f"{list(warmed)} in {warm_s:.1f}s; each bucket once: launches "
          f"{launches} (exact: {VILBERT_ATTENTION} K1 and {VILBERT_LN} K4 a "
          f"forward); sample {probe} at buckets 4 and 32 vs the f32 CPU "
          f"forward: max_abs_err {max(errs):.4g} (bound {SERVE_ATOL}), cosine "
          f"min {min(coss):.6f} (bound {SERVE_MIN_COSINE})")
    print(f"  on '{card}': bf16 forward at bucket 32 {fwd_ms:.2f} ms (CUDA "
          f"events), device time {dev_ms:.3f} ms (torch.profiler, 3 "
          "forwards): " + "; ".join(
              f"{cat} {ms:.3f} x{cnt:.0f}" for cat, (ms, cnt) in
              sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    return launches


def phase_vilbert_training(card):
    cfg = _vilbert_config()
    mc = cfg["model_config"]["vilbert"]
    _check_vilbert_config(mc)
    check((mc["hidden_dropout_prob"], mc["v_hidden_dropout_prob"],
           mc["attention_probs_dropout_prob"],
           mc["v_attention_probs_dropout_prob"]) == (0.1, 0.1, 0.0, 0.0),
          dict(mc))
    host_batch = flagship.vilbert_train_batch(TRAIN_B, SEQ, REGIONS, VDIM,
                                              seed=0)
    model = flagship.vqa2_vilbert(cfg, example=host_batch)
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state, step = flagship.vqa2_trainer(model, cfg, seed=0)
    batch = train_state._to_device(host_batch, DEV)

    t0 = time.perf_counter()
    state, rep = step(state, batch)  # warm-up
    warm_loss, warm_s = float(rep["total_loss"]), time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path, counted from zero
    losses, step_ms = [], []
    for _ in range(VILBERT_STEPS):
        t0 = time.perf_counter()
        state, rep = step(state, batch)
        losses.append(float(rep["total_loss"]))  # synchronises
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in [warm_loss] + losses)
          and not bool(rep["nan_flag"]), f"vilbert losses {losses}")
    per_step = dict(ZERO_COUNTS,
                    flash_attention_fwd_stats=VILBERT_ATTENTION,
                    flash_attention_bwd_dq=VILBERT_ATTENTION,
                    flash_attention_bwd_dkv=VILBERT_ATTENTION,
                    layer_norm=VILBERT_LN, layer_norm_bwd=VILBERT_LN)
    want = {k: v * VILBERT_STEPS for k, v in per_step.items()}
    check(launches == want, f"vilbert training launches {launches}, want "
          f"{want}")

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    dev_ms, by_category = _device_ms(one_step, PROFILED_STEPS)
    best_ms = min(step_ms)
    del state, step, model, rep
    torch.cuda.empty_cache()

    def build(cfg, overrides):
        return flagship.vqa2_vilbert(cfg, overrides, example=host_batch)

    k_losses, k_grads, k_upd, k_launches = _compared_steps(
        cfg, init, batch, build=build, no_dropout=VILBERT_NO_DROPOUT)
    with plain_versions():
        p_losses, p_grads, p_upd, p_launches = _compared_steps(
            cfg, init, batch, build=build, no_dropout=VILBERT_NO_DROPOUT)
    check(k_launches == {k: v * COMPARED_STEPS for k, v in per_step.items()},
          f"vilbert kernel side launches {k_launches}")
    check(p_launches == ZERO_COUNTS, f"vilbert plain launches {p_launches}")
    # the config has no schedule: every update at lr 4e-5 moves the loss
    check(len(set(k_losses)) == COMPARED_STEPS,
          f"every update moves the loss: losses {k_losses}")
    loss_rel = _check_losses(k_losses, p_losses)
    # the same first step in f32 through the plain versions, TF32 off: the
    # gradient bf16 aims at. Where the plain versions' bf16 gradient is
    # itself further from it than the bound, rounding noise dominates the
    # parameter's gradient (at this init, the lowest layers' of both
    # streams: a change of LayerNorm implementation alone moves them by
    # 9%), and the norm-relative bound is held on the others; on those
    # the kernels' gradient is held to the f32 one instead: at most
    # VILBERT_NOISY_RATIO times as far from it as the plain versions'
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with plain_versions():
            _, f_grads, _, _ = _compared_steps(
                cfg, init, batch, steps=1,
                build=lambda c, o: build(c, dict(o, dtype="float32")),
                no_dropout=VILBERT_NO_DROPOUT)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    floor = {n: _norm_rel(p_grads[n], f_grads[n])
             for n in _compared_names(k_grads, p_grads)}
    resolved = {n for n, e in floor.items() if e <= TRAIN_MAX_GRAD_REL}
    compared, g_cos, g_rel, worst_g, worst_r = _check_gradients(
        k_grads, p_grads, resolved)
    noisy = sorted((n for n in compared if n not in resolved), key=floor.get)
    k_floor = {n: _norm_rel(k_grads[n], f_grads[n]) for n in noisy}
    ratio = {n: k_floor[n] / floor[n] for n in noisy}
    worst_n = max(ratio, key=ratio.get, default=None)
    check(worst_n is None or ratio[worst_n] <= VILBERT_NOISY_RATIO,
          f"vilbert kernels' gradient at {worst_n}: {k_floor.get(worst_n)} "
          f"from the f32 one, the plain versions' {floor.get(worst_n)}")
    u_cos = {n: _cosine(k_upd[n], p_upd[n]) for n in compared}
    worst_u = min(u_cos, key=u_cos.get)
    check(u_cos[worst_u] >= TRAIN_MIN_UPDATE_COSINE,
          f"vilbert update cosine {u_cos[worst_u]} at {worst_u}")
    del k_grads, p_grads, f_grads, k_upd, p_upd
    torch.cuda.empty_cache()
    print(f"phase vilbert-training: ok ViLBERT-base f32 params, bf16 "
          f"compute, B={TRAIN_B} (the config's 256 cut), VQA2 config (AdamW "
          "lr 4e-5 with no schedule, logit_bce, the BERT no-decay groups), "
          "hidden dropout "
          "0.1, attention-probability dropout 0; warm-up step "
          f"{warm_s:.1f}s loss {warm_loss:.4f}; {VILBERT_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]} all finite; launches {launches} "
          f"(exact per step: {VILBERT_ATTENTION} K1-stats, K2 and K3, "
          f"{VILBERT_LN} K4 and K4-bwd, 0 inference-form K1)")
    print(f"  on '{card}': ms per step {[round(x, 2) for x in step_ms]} "
          f"(best {best_ms:.2f}), {TRAIN_B * 1e3 / best_ms:.1f} samples/s at "
          f"best; device time {dev_ms:.2f} ms per step (torch.profiler, 1 "
          f"step) against {best_ms:.2f} ms wall: idle "
          f"{100 * (1 - dev_ms / best_ms):.1f}%; max_memory_allocated "
          f"{peak_gb:.2f} GB")
    print("  device time per step by kind of kernel (ms, launches): "
          + "; ".join(f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                      sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    print(f"  kernels vs plain versions, {COMPARED_STEPS} steps at dropout 0 "
          f"(launches {k_launches} vs {p_launches}): losses {k_losses} vs "
          f"{p_losses} (max rel {loss_rel:.3g}, bound {TRAIN_LOSS_RTOL}); "
          f"first-step gradients: cosine min {g_cos[worst_g]:.6f} at "
          f"{worst_g} (bound {TRAIN_MIN_GRAD_COSINE}), |g_k - g_p| / |g_p| "
          f"max {g_rel[worst_r]:.3g} at {worst_r} (bound "
          f"{TRAIN_MAX_GRAD_REL}, on the {len(compared) - len(noisy)} "
          f"parameters whose "
          f"plain bf16 gradient is within it of the f32 one); update cosine "
          f"min {u_cos[worst_u]:.6f} at {worst_u} (bound "
          f"{TRAIN_MIN_UPDATE_COSINE}); {len(compared)} parameters compared "
          "(the attention key biases left out)")
    print(f"  {len(noisy)} parameters whose plain bf16 gradient is further "
          f"than {TRAIN_MAX_GRAD_REL} from the f32 one (cosine bound held; "
          f"kernels-f32 <= {VILBERT_NOISY_RATIO} x plain-f32, worst "
          f"{ratio[worst_n] if noisy else 0.0:.3f}x at {worst_n}): "
          + "; ".join(f"{n} plain-f32 {floor[n]:.4f}, kernels-f32 "
                      f"{k_floor[n]:.4f}, kernels-plain {g_rel[n]:.4f}"
                      for n in noisy))
    return launches


class _StepRecorder(Callback):
    """A user callback of the ViLBERT ``mmf_run`` phases (registered as
    ``chip_smoke_recorder``): the initial weights, and the batches the
    train step took (it wraps the trainer's step), so that the step alone
    can run them again; when each update's loss reached the host; the
    validations' meters."""

    def __init__(self, config, trainer):
        super().__init__(config, trainer)
        self.batches, self.loss_read, self.val_meters = [], {}, []
        self.initial = None

    def on_init_end(self, **kwargs):
        self.initial = {k: v.detach().to("cpu", copy=True)
                        for k, v in self.trainer.model.state_dict().items()}
        # first to hear on_update_end: before the checkpoint writes
        self.trainer.callbacks.remove(self)
        self.trainer.callbacks.insert(0, self)
        step = self.trainer._get_train_step()

        def recorded(state, batch):
            self.batches.append(batch)
            return step(state, batch)

        self.trainer._train_step = recorded

    def on_update_end(self, **kwargs):
        self.loss_read[self.trainer.num_updates] = time.perf_counter()

    def on_validation_end(self, **kwargs):
        self.val_meters.append(kwargs["meter"])


def _steps_again(trainer, recorder, build, make_trainer, keys):
    """The train step alone from the run's initial weights on the batches
    it took: the largest relative difference of its losses from the
    run's, checked against RUN_LOSS_RTOL."""
    cfg = trainer.config
    model = build(cfg)
    model.load_state_dict(recorder.initial, strict=True)
    state, step = make_trainer(model, cfg, seed=int(cfg["training"]["seed"]),
                               device=DEV)
    got = {k: [] for k in keys}
    for batch in recorder.batches:
        state, rep = step(state, batch)
        for k in keys:
            got[k].append(float(rep["total_loss"] if k == "train/total_loss"
                                else rep["losses"][k]))
    rel = 0.0
    for k in keys:
        run_losses = list(trainer.meter.meters[k].averaged_value_deque)
        check(len(run_losses) == len(got[k]) and all(
            math.isfinite(x) for x in run_losses), f"{k}: {run_losses}")
        # a loss of 0 (UNITER's itm over unpaired captions) must be 0
        rel = max([rel] + [abs(a - b) / abs(b) if b else
                           (0.0 if a == b else math.inf)
                           for a, b in zip(run_losses, got[k])])
        check(rel <= RUN_LOSS_RTOL,
              f"mmf_run {k} {run_losses} vs the train step's {got[k]}")
    del state, step, model
    torch.cuda.empty_cache()
    return rel, got


def _served_folder(card, save_dir, model, samples, per_forward, meta,
                   label, ref_device=DEV):
    """mmf_serve (cli/serve.py build_server, port 0) on a run's folder:
    one concurrent request a sample (its fields) against an in-memory
    engine on the run's weights with the same meta fields, which predicts
    them as one batch, the server's bucket; the batcher waits up to
    SERVE_WAIT_MS for the requests, so that they meet the model as one
    batch too (another bucket takes other GEMM shapes, and bf16 the
    roundings those give).
    ``per_forward`` the exact launches of one forward. ``ref_device``
    "cpu" puts the in-memory engine on the CPU (the plain versions)."""
    from mmf_tpu_torch.cli import serve as serve_cli

    bodies = [_fields_body(s) for s in samples]
    bucket = len(samples)
    ref = ServingEngine(model, device=ref_device, max_batch_size=bucket,
                        meta=meta).predict_many(samples)
    bf16 = str(model.config.get("dtype", "float32")) in ("bfloat16", "bf16")
    del model
    reset_counts()  # the main path, counted from zero
    t0 = time.perf_counter()
    server = serve_cli.build_server(serve_cli.parse_opts(
        [f"checkpoint={save_dir}", "port=0", f"max_batch_size={bucket}",
         f"max_wait_ms={SERVE_WAIT_MS}"])).start()
    try:
        replies, done_at = [None] * len(samples), [None] * len(samples)

        def send(i):
            replies[i] = _request(server.port, bodies[i])
            done_at[i] = time.perf_counter()

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(samples))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        launches = read_counts()
        check(not any(t.is_alive() for t in threads), "a request hung")
        first_s = min(done_at) - t0
        batches = server.stats()["batcher"]["batches"]
    finally:
        server.shutdown()
    want = {k: v * batches for k, v in per_forward.items()}
    check(batches >= 1 and launches == want, f"{label} served launches "
          f"{launches}, want {want} for {batches} batch(es)")
    errs, coss = [], []
    for (status, payload, _), r in zip(replies, ref):
        check(status == 200, payload)
        got = np.asarray(payload["scores"], np.float32)
        want_s = np.asarray(r["scores"], np.float32)
        check(got.shape == want_s.shape and np.isfinite(got).all(),
              f"{label} scores shape {got.shape}")
        top = float(np.abs(want_s).max())
        # bf16: ulps at the largest score's binade; f32: relative
        unit = 2.0 ** (math.floor(math.log2(top)) - 7) if bf16 else top
        errs.append(float(np.abs(got - want_s).max()) / unit)
        coss.append(float(got @ want_s / (np.linalg.norm(got)
                                          * np.linalg.norm(want_s))))
    bound_err = SERVE_BATCH_ULPS if bf16 else SERVE_F32_REL
    check(max(errs) <= bound_err and min(coss) >= SERVE_BATCH_MIN_COSINE,
          f"{label} served checkpoint vs in-memory engine: error {max(errs)}"
          f", cosine {min(coss)}")
    torch.cuda.empty_cache()
    unit = "bf16 ulps of the largest score" if bf16 else \
        "of the largest score"
    return launches, (
        f"  mmf_serve on the run's folder (cli/serve.py build_server, port "
        f"0): {len(samples)} concurrent requests all 200, {batches} "
        f"batch(es), launches {launches} (exact per forward); vs an "
        f"in-memory engine on the run's weights ({ref_device}): max error "
        f"{max(errs):.3g} "
        f"{unit} (bound {bound_err}), cosine min {min(coss):.7f} (bound "
        f"{SERVE_BATCH_MIN_COSINE}); build_server to the first answer "
        f"{first_s:.2f}s (a batch goes when full or after "
        f"{SERVE_WAIT_MS} ms) on '{card}'")


def _cli_run(save_dir, config, model, dataset, updates, opts,
             attention_cut=False, batch_size=RUN_B):
    """``mmf_run`` (``cli.run.run``) of ``model`` with the step recorder
    (and, with ``attention_cut``, ``_AttentionCut``): (trainer, recorder,
    launches, seconds). The processors an earlier run left in the
    registry's state under ``dataset``'s name go first: a dataset takes
    the ones registered under its name, as in JAX, and configs differ."""
    from mmf_tpu_torch.cli.run import run
    from mmf_tpu_torch.common.registry import registry

    state = registry.mapping["state"]
    for key in [k for k in state if k.startswith(f"{dataset}_")]:
        del state[key]
    callbacks = "{type: chip_smoke_recorder}" + (
        ", {type: chip_smoke_attention_cut}" if attention_cut else "")
    run_opts = [
        f"config={config}", f"model={model}", f"dataset={dataset}",
        f"env.save_dir={save_dir}", f"training.batch_size={batch_size}",
        f"training.max_updates={updates}", "training.log_interval=1",
        f"training.num_workers={RUN_WORKERS}", "training.pin_memory=true",
        "training.seed=1", "scheduler.params.num_warmup_steps=2",
        f"training.callbacks=[{callbacks}]", *opts]
    reset_counts()  # the main path, counted from zero
    t0 = time.perf_counter()
    trainer = run(run_opts)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    recorder = next(cb for cb in trainer.callbacks
                    if isinstance(cb, _StepRecorder))
    return trainer, recorder, launches, seconds


def _evaluated(updates):
    """The options of a run that evaluates and checkpoints once, at its
    end, and writes the val and test prediction reports. The
    validation's early stopping writes the checkpoint (models/model_N,
    current and best: a validation's first finite value is its best); an
    interval checkpoint at the same update would write it again, 1.3-2.4
    GB with the optimizer state."""
    return [f"training.evaluation_interval={updates}",
            "training.checkpoint_interval=1000",
            "run_type=train_val_inference", "evaluation.predict=true"]


def _run_checks(trainer, recorder, launches, updates, attention, ln,
                build, key, label, test_file):
    """A VQA2 run of ``_evaluated(updates)``: its exact launches, its
    folder, a report row per test question (of ``test_file``, the test
    imdb), val vqa_accuracy, and its losses against the train step alone
    on the same batches: (rel, losses, val accuracy, train samples/s over
    updates 3-N)."""
    import glob

    val_batches = -(-RUN_SPLITS["val"] // RUN_B)
    forwards = 2 * val_batches + -(-RUN_SPLITS["test"] // RUN_B)
    want = dict(ZERO_COUNTS, flash_attention_fwd=attention * forwards,
                flash_attention_fwd_stats=attention * updates,
                flash_attention_bwd_dq=attention * updates,
                flash_attention_bwd_dkv=attention * updates,
                layer_norm=ln * (updates + forwards),
                layer_norm_bwd=ln * updates)
    check(launches == want, f"{label} mmf-run launches {launches}, want "
          f"{want}")
    save_dir = trainer.config["env"]["save_dir"]
    files = {os.path.relpath(f, save_dir) for f in glob.glob(
        os.path.join(save_dir, "**"), recursive=True)}
    model = trainer.config["model"]
    for name in ("config.yaml", "current.ckpt", "best.ckpt",
                 f"models/model_{updates}.ckpt", f"{model}_final.pth"):
        check(name in files, f"{label}: {name} missing from {sorted(files)}")
    reports = {split: json.load(open(f)) for split in ("val", "test")
               for f in glob.glob(os.path.join(
                   save_dir, "reports", f"vqa2_*_{split}_*.json"))}
    test_ids = [int(r["question_id"]) for r in np.load(
        test_file, allow_pickle=True)[1:]]
    check(len(reports["val"]) == RUN_SPLITS["val"] and sorted(
        int(r["question_id"]) for r in reports["test"]) == sorted(test_ids),
        f"{label} reports {len(reports['val'])} / {len(reports['test'])}")
    report, meter = trainer.evaluation_loop("val")
    acc = meter.meters["val/vqa2/vqa_accuracy"].global_avg
    check(report.batch_size == RUN_SPLITS["val"] and 0.0 <= acc <= 1.0,
          f"{label} val scored {report.batch_size}, vqa_accuracy {acc}")
    rel, got = _steps_again(trainer, recorder, build, flagship.vqa2_trainer,
                            [key])
    t = recorder.loss_read
    sps = RUN_B * (updates - 2) / (t[updates] - t[2])
    return rel, got[key], acc, sps


def phase_vilbert_runs(card):
    """mmf_run finetunes ViLBERT-base on VQA2 (train, one evaluation, one
    checkpoint, the prediction reports) and pretrains it on masked VQA2,
    on a synthetic layout with full boxes and class probabilities; then
    mmf_serve serves the finetuned run's folder."""
    import shutil

    from mmf_tpu_torch.common.registry import registry
    from tests.torch_vqa2_layout import SPLITS, layout_opts, write_layout

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vilbert_")
    trainers = []
    try:
        t0 = time.perf_counter()
        write_layout(tmp, n_train=RUN_SPLITS["train"],
                     n_val=RUN_SPLITS["val"], n_test=RUN_SPLITS["test"],
                     n_images=RUN_IMAGES, regions=REGIONS, feature_dim=VDIM,
                     num_answers=RUN_ANSWERS, vocab_size=VOCAB, seed=0,
                     full_boxes=True, cls_prob_width=flagship.V_TARGET_SIZE)
        layout_s = time.perf_counter() - t0

        # VQA2 finetuning: train, evaluate and checkpoint once, predict
        u = VILBERT_RUN_UPDATES
        trainer, recorder, launches, run_s = _cli_run(
            os.path.join(tmp, "save_vqa2"), flagship.VILBERT_VQA2_CONFIG,
            "vilbert", "vqa2", u, [
                *flagship.VILBERT_VQA2_OVERRIDES, *VILBERT_CUTS,
                *_evaluated(u), *layout_opts(tmp)])
        trainers.append(trainer)
        _check_vilbert_config(trainer.config["model_config"]["vilbert"])
        key = "train/vqa2/logit_bce"
        rel, step_losses, acc, sps = _run_checks(
            trainer, recorder, launches, u, VILBERT_ATTENTION, VILBERT_LN,
            lambda c: flagship.vqa2_vilbert(c), key, "vilbert",
            os.path.join(tmp, "datasets", "vqa2", "defaults", "annotations",
                         SPLITS["test"]))
        trainer.teardown()
        vqa2_line = (
            f"phase vilbert-mmf-run: ok mmf_run (cli/run.py's run(opts)) "
            f"finetunes ViLBERT-base on VQA2 with "
            f"{flagship.VILBERT_VQA2_CONFIG} and "
            f"flagship.VILBERT_VQA2_OVERRIDES, B={RUN_B}, "
            f"{RUN_WORKERS} loader workers, on the synthetic layout "
            f"({RUN_SPLITS} questions over {RUN_IMAGES} images, {REGIONS} "
            f"boxes of {VDIM} an image, cls_prob [{REGIONS}, "
            f"{flagship.V_TARGET_SIZE}], written in {layout_s:.1f}s): {u} "
            f"updates, losses {step_losses} equal to the train step's "
            f"on the same batches (max rel {rel:.3g}, bound {RUN_LOSS_RTOL}); "
            f"one evaluation and checkpoint; val vqa_accuracy {acc:.4f} over "
            f"{RUN_SPLITS['val']} questions; a report row per val and test "
            f"question; launches {launches} (exact); run {run_s:.1f}s, train "
            f"{sps:.1f} samples/s over updates 3-{u} on '{card}'")
        model = flagship.vqa2_vilbert(trainer.config)
        model.load_state_dict({k: v.cpu() for k, v in
                               trainer.model.state_dict().items()},
                              strict=True)
        served_launches, served = _served_folder(
            card, trainer.config["env"]["save_dir"], model,
            flagship.split_samples(flagship.vilbert_example_batch(
                SERVED_REQUESTS, SEQ, REGIONS, VDIM, seed=9)),
            dict(ZERO_COUNTS, flash_attention_fwd=VILBERT_ATTENTION,
                 layer_norm=VILBERT_LN), None, "vilbert")
        del trainer, recorder
        torch.cuda.empty_cache()

        # masked-VQA2 pretraining
        u = VILBERT_PRETRAIN_UPDATES
        trainer, recorder, p_launches, p_run_s = _cli_run(
            os.path.join(tmp, "save_masked"),
            flagship.VILBERT_MASKED_VQA2_CONFIG, "vilbert", "masked_vqa2", u,
            [*flagship.VILBERT_MASKED_VQA2_OVERRIDES, *VILBERT_CUTS,
             "run_type=train",
             *layout_opts(tmp, "masked_vqa2", "masked_token_processor")])
        trainers.append(trainer)
        _check_vilbert_config(trainer.config["model_config"]["vilbert"],
                              "pretraining")
        want = dict(ZERO_COUNTS,
                    flash_attention_fwd_stats=VILBERT_ATTENTION * u,
                    flash_attention_bwd_dq=VILBERT_ATTENTION * u,
                    flash_attention_bwd_dkv=VILBERT_ATTENTION * u,
                    layer_norm=VILBERT_PRETRAIN_LN * u,
                    layer_norm_bwd=VILBERT_PRETRAIN_LN * u)
        check(p_launches == want, f"vilbert pretraining launches "
              f"{p_launches}, want {want}")
        keys = ["train/masked_vqa2/masked_lm_loss",
                "train/masked_vqa2/masked_img_loss"]
        labels = [int((b["image_labels"] == 1).sum()) for b in
                  recorder.batches]
        p_rel, p_losses = _steps_again(
            trainer, recorder, lambda c: flagship.vqa2_vilbert(c),
            flagship.masked_vqa2_trainer, keys)
        trainer.teardown()
        print(vqa2_line)
        print(f"  masked-VQA2 pretraining: mmf_run with "
              f"{flagship.VILBERT_MASKED_VQA2_CONFIG} and "
              "flagship.VILBERT_MASKED_VQA2_OVERRIDES (the pretraining head, "
              f"AdamW lr 1e-4, warmup_linear cut to 2 updates), B={RUN_B}: "
              f"{u} updates, masked_lm_loss {p_losses[keys[0]]} and "
              f"masked_img_loss {p_losses[keys[1]]} (KLD against cls_prob; "
              f"{labels} masked regions a batch) equal to the train step's "
              f"on the same batches (max rel {p_rel:.3g}, bound "
              f"{RUN_LOSS_RTOL}); launches {p_launches} (exact: "
              f"{VILBERT_PRETRAIN_LN} LayerNorms an update with the two "
              f"heads'); run {p_run_s:.1f}s")
        print(served)
    finally:
        for trainer in trainers:
            trainer.teardown()
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: launches[k] + p_launches[k] + served_launches[k]
            for k in launches}


# -- phases 14-18: ViLT-base and the MMF Transformer --------------------------
VILT_PATCHES = (flagship.VILT_IMAGE // 16) ** 2  # 576 patches of 16 px
VILT_S = flagship.VILT_SEQ + VILT_PATCHES + 1  # 617: text, [CLS], patches
VILT_ROWS = TRAIN_B * VILT_S  # the encoder's LayerNorm rows at B=64
# per ViLT forward: 12 attention calls (one a pre-LN layer); 27 LayerNorms:
# the text embeddings', two a layer, the encoder's last, the VQA2 MLP
# head's. Pretraining encodes twice (the masked pass) and its heads add
# the MLM transform's: 24 and 2 + 2 * 25 + 1
VILT_ATTENTION, VILT_LN = 12, 1 + 2 * 12 + 1 + 1
VILT_PRETRAIN_ATTENTION, VILT_PRETRAIN_LN = 24, 2 + 2 * 25 + 1
VILT_STEPS = 4
# the MLM + ITM step at the config's B=64 was reckoned at ~71 GB (two f32
# encoder passes of ~25 GB of saved activations, the MLM logits, their
# log_softmax and their gradients, [B * 617, 30522] f32 each): cut to 32
VILT_PRETRAIN_B, VILT_PRETRAIN_STEPS, VILT_PRETRAIN_COMPARED = 32, 3, 2
# its kernels-vs-plain steps take the batch's first 16 rows: the plain
# attention keeps each call's [B, 12, 617, 617] f32 scores and
# probabilities for the backward, 24 calls a step (at 32 rows, 76.8 GB)
VILT_PRETRAIN_COMPARED_B = 16
VILT_META = {"dataset_name": "vqa2", "dataset_type": "test"}
# served f32 scores vs the f32 CPU forward on the same weights: the patch
# convolution runs on cuDNN with TF32 (torch's default; 8.6e-4 relative
# in ResNet's), every GEMM in f32; random-init scores have |s| ~ 1-3
VILT_SERVE_ATOL = 1e-2
VILT_SERVE_MIN_COSINE = 0.99999
# served f32 scores vs the same kernels and weights in another batch:
# other GEMM summation orders, relative to the largest score
SERVE_F32_REL = 1e-4
VILT_RUN_UPDATES = 4
# the served folders' batching window: long enough for the 32 requests
# (MB of JSON each) to fill one bucket-32 batch, as the in-memory engine
# predicts them; a full batch goes at once
SERVE_WAIT_MS = 10000
MMFT_S = flagship.MMFT_SEQ + REGIONS  # 114
# per MMFT forward: 12 attention calls; 28 LayerNorms: each modality's
# embedding LayerNorm, the features' projection LayerNorm, two a layer,
# the MLP head's
MMFT_ATTENTION, MMFT_LN = 12, 2 + 1 + 2 * 12 + 1
MMFT_RUN_UPDATES = 4


def _no_attention_dropout(model):
    """Attention-probability dropout to 0 on the built modules: ViLT's and
    MMFT's trunks take TransformerConfig's 0.1 (no config key reaches it,
    in JAX too), and the flash kernels have no probabilities to drop. The
    other dropouts stay."""
    for m in model.modules():
        if isinstance(getattr(m, "config", None), T.TransformerConfig):
            m.config = dataclasses.replace(m.config,
                                           attention_probs_dropout_prob=0.0)
    return model


class _AttentionCut(Callback):
    """``_no_attention_dropout`` on an ``mmf_run``'s model, before its
    first update (registered as ``chip_smoke_attention_cut``)."""

    def on_init_end(self, **kwargs):
        _no_attention_dropout(self.trainer.model)


def _vilt_attention_inputs(b, g):
    """q, k, v, dO f32 [b, 12, 617, 64] as the views the attention block
    hands over, and ViLT's mask as a bias: questions of 6-40 tokens, every
    patch valid."""
    def proj():
        return torch.randn(b, VILT_S, HEADS, HEAD_DIM, device=DEV,
                           generator=g).transpose(1, 2)

    lengths = torch.randint(6, flagship.VILT_SEQ + 1, (b,), device=DEV,
                            generator=g)
    mask = torch.ones(b, VILT_S, dtype=torch.int32, device=DEV)
    mask[:, :flagship.VILT_SEQ] = (torch.arange(
        flagship.VILT_SEQ, device=DEV)[None] < lengths[:, None]).int()
    return (proj(), proj(), proj(),
            A.make_attention_bias(mask, torch.float32), proj())


def _mmft_attention_inputs(b, g):
    """q, k, v, dO bf16 [b, 12, 114, 64] as the views the attention block
    hands over, and MMFT's mask on VQA2 as a bias: every token valid (the
    vocab processor gives no input_mask and the region features no
    image_mask, so the model masks nothing; 114 = 64 + 50 rows)."""
    def proj():
        return torch.randn(b, MMFT_S, HEADS, HEAD_DIM, device=DEV,
                           generator=g).to(torch.bfloat16).transpose(1, 2)

    mask = torch.ones(b, MMFT_S, dtype=torch.int32, device=DEV)
    return (proj(), proj(), proj(),
            A.make_attention_bias(mask, torch.bfloat16), proj())


def _vilt_layer_norm_case(g):
    """K4 and K4-bwd in f32 without the residual at ViLT's [39488, 768]
    (its pre-LN encoder's LayerNorms at B=64): against their plain
    versions, by device_ms over rotating inputs beside F.layer_norm's
    forward and backward, with host time and the bound."""
    dt, rows = torch.float32, VILT_ROWS
    xs = torch.randn(3, rows, HIDDEN, device=DEV, generator=g)
    dys = torch.randn(3, rows, HIDDEN, device=DEV, generator=g)
    w = 1.0 + 0.1 * torch.randn(HIDDEN, device=DEV, generator=g)
    bb = 0.1 * torch.randn(HIDDEN, device=DEV, generator=g)
    sets = [(xs[i], dys[i]) for i in range(3)]  # 3 x 121 MB read a call
    x, dy = sets[0]
    out = L.layer_norm_kernel(x, w, bb)
    got = L.layer_norm_backward_kernel(x, w, dy)
    torch.cuda.synchronize()
    f_err = max_err(out, L._ln_reference(x, None, w, bb, 1e-12), dt)
    want = L._ln_backward_reference(x, None, w, bb, dy, 1e-12)
    b_err = max(rel_err(a, b_, rel, f"K4-bwd vilt {n}") for n, a, b_, rel in
                zip(("dx", "dscale", "dbias"), got,
                    (want[0], want[2], want[3]),
                    (LN_DX_REL[dt], LN_PARAM_REL, LN_PARAM_REL)))
    lib = [_ln_library_backward(x_, None, w, bb, dy_) for x_, dy_ in sets]
    fwd = {"ms": device_ms(rotating(
        lambda x_, _: L.layer_norm_kernel(x_, w, bb), sets)),
        "library_ms": device_ms(rotating(
            lambda x_, _: F.layer_norm(x_, (HIDDEN,), w, bb, 1e-12), sets)),
        "plain_ms": device_ms(rotating(
            lambda x_, _: L._ln_reference(x_, None, w, bb, 1e-12), sets),
            iters=5),
        "host_us": host_us(lambda: L.layer_norm_kernel(x, w, bb)),
        "max_abs_err": f_err}
    fwd["bound_ms"], fwd["bound_by"] = bound(_nbytes(x, w, bb, out),
                                             8 * x.numel(), dt)
    bwd = {"ms": device_ms(rotating(
        lambda x_, dy_: L.layer_norm_backward_kernel(x_, w, dy_), sets)),
        "library_ms": device_ms(rotating(lambda f_: f_(),
                                         [(f_,) for f_ in lib])),
        "plain_ms": device_ms(rotating(
            lambda x_, dy_: L._ln_backward_reference(x_, None, w, bb, dy_,
                                                     1e-12), sets), iters=5),
        "host_us": host_us(lambda: L.layer_norm_backward_kernel(x, w, dy)),
        "max_abs_err": b_err}
    bwd["bound_ms"], bwd["bound_by"] = bound(
        _nbytes(x, w, dy, got[0], got[1], got[2]), 10 * x.numel(), dt)
    del lib, xs, dys
    torch.cuda.empty_cache()
    return fwd, bwd


def _raw_case(q, k, v, bias, label="vilt", iters=3, plain_iters=2):
    """K1's raw-stats form against its plain version, timed beside it
    with host time and the bound (no PyTorch call returns the
    unnormalized state); and K1 in its three forms bit-equal across two
    calls."""
    dt = q.dtype
    first = (A.flash_attention(q, k, v, bias),) + \
        A.flash_attention_with_stats(q, k, v, bias) + \
        A.flash_attention_block(q, k, v, bias)
    second = (A.flash_attention(q, k, v, bias),) + \
        A.flash_attention_with_stats(q, k, v, bias) + \
        A.flash_attention_block(q, k, v, bias)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(first, second)),
          f"{label}: K1 forms not bit-equal across calls")
    acc, m, l = first[4:]
    del first, second
    ref = A.flash_attention_block_reference(q, k, v, bias)
    torch.testing.assert_close(m, ref[1], **STATS_TOL)
    torch.testing.assert_close(l, ref[2], **STATS_TOL)
    err = max(rel_err(acc, ref[0], RAW_REL[dt], f"raw acc {label}"),
              float((m - ref[1]).abs().max()),
              float((l - ref[2]).abs().max()))
    del ref
    b, heads, sq, head_dim = q.shape
    pairs = b * heads * sq * k.shape[2] * head_dim
    nbytes = _nbytes(q, k, v, bias, acc, m, l)
    if dt == torch.float32:
        bound_ms, bound_by = max((1e3 * nbytes / HBM_BYTES_PER_S, "bytes"), (
            1e3 * SPLIT_TF32_PRODUCTS * 4 * pairs / TF32_FLOPS,
            "operations"))
    else:
        bound_ms, bound_by = bound(nbytes, 4 * pairs, dt)

    def call():
        return A.flash_attention_block(q, k, v, bias)

    return {"max_abs_err": err,
            "ms": device_ms(call, iters=iters, repeats=3),
            "host_us": host_us(call, iters=10),
            "plain_ms": time_ms(
                lambda: A.flash_attention_block_reference(q, k, v, bias),
                iters=plain_iters, repeats=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "fma_bound_ms": (bound(nbytes, 4 * pairs, dt)[0]
                             if dt == torch.float32 else None),
            "library_ms": None}


def phase_vilt_kernels(card):
    g = torch.Generator(device=DEV).manual_seed(6)
    q, k, v, bias, dout = _vilt_attention_inputs(TRAIN_B, g)
    # f32 at ViLT's size: a plain backward call takes ~13 ms
    att = _attention_case("vilt", q, k, v, bias, dout, iters=3, plain_iters=2,
                          repeats=3)
    raw = _raw_case(q, k, v, bias)
    del q, k, v, bias, dout
    ln_fwd, ln_bwd = _vilt_layer_norm_case(g)
    torch.cuda.empty_cache()
    ms, lib, pl, bd, fma = (att["ms"], att["library_ms"], att["plain_ms"],
                            att["bound_ms"], att["fma_bound_ms"])
    print(f"phase vilt-kernels: ok K1, K1-stats, K1-raw, K2 and K3 in f32 "
          f"at ViLT's {att['shape']} (questions of 6-40 tokens masked, 577 "
          "image tokens; 617 = 9 x 64 + 41 rows; K1's three forms bit-equal "
          "across two calls), and K4, K4-bwd f32 without the "
          f"residual at [{VILT_ROWS}, {HIDDEN}], against their plain "
          "versions within the kernels phase's bounds; device ms "
          "(spin-queued; LayerNorms over rotating input sets), the plain "
          "versions' (CUDA events), SDPA's / F.layer_norm's, host us a call "
          "and two bounds: at f32 accuracy (split-TF32, three TF32 products "
          f"over {TF32_FLOPS / 1e12:.0f} TFLOP/s; the attention kernels run "
          "so), and the same work in f32 on the FP32 FMA units (67 TFLOP/s) "
          f"on '{card}':")
    print("  max_abs_err " + ", ".join(
        f"{n} {e:.3g}" for n, e in att["max_abs_err"].items())
        + f", K1-raw {raw['max_abs_err']:.3g}"
        + f"; K1 {ms['K1']:.4f} (sdpa {lib['K1']:.4f}, plain "
        f"{pl['K1']:.4f}, bound {bd['K1']:.4f} {att['bound_by']['K1']}, FMA "
        f"{fma['K1']:.4f}), K1-stats {ms['K1-stats']:.4f} (sdpa fwd+lse "
        f"{lib['K1-stats']:.4f}, plain {pl['K1-stats']:.4f}, bound "
        f"{bd['K1-stats']:.4f}, FMA {fma['K1-stats']:.4f}), K1-raw "
        f"{raw['ms']:.4f} (plain {raw['plain_ms']:.4f}, bound "
        f"{raw['bound_ms']:.4f}, FMA {raw['fma_bound_ms']:.4f}), K2 "
        f"{ms['K2']:.4f} (bound {bd['K2']:.4f}, FMA {fma['K2']:.4f}), K3 "
        f"{ms['K3']:.4f} (bound {bd['K3']:.4f}, FMA {fma['K3']:.4f}), K2+K3 "
        f"{ms['K2'] + ms['K3']:.4f} (sdpa bwd {lib['K2+K3']:.4f}, plain "
        f"{pl['K2+K3']:.4f}); host us " + ", ".join(
            f"{n} {u:.1f}" for n, u in att["host_us"].items())
        + f", K1-raw {raw['host_us']:.1f}")
    for name, r in (("K4", ln_fwd), ("K4-bwd", ln_bwd)):
        print(f"  {name} f32 [{VILT_ROWS}, {HIDDEN}] no residual: "
              f"max_abs_err {r['max_abs_err']:.3g}; kernel {r['ms']:.4f}, "
              f"F.layer_norm{' backward' if name == 'K4-bwd' else ''} "
              f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}; bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']} (kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.0f}%); host "
              f"{r['host_us']:.1f} us a call")
    return att, raw, ln_fwd, ln_bwd


def _check_vilt_config(mc, heads="vqa2"):
    check((mc["hidden_size"], mc["num_hidden_layers"],
           mc["num_attention_heads"], mc["image_encoder"]["params"][
               "patch_size"], list(mc["image_encoder"]["params"][
                   "image_size"]), mc["image_encoder"]["params"]["mlp_dim"],
           heads in mc["heads"]) == (
        HIDDEN, 12, HEADS, 16, [flagship.VILT_IMAGE] * 2, 3072, True),
        dict(mc))


def phase_vilt_serving(card):
    """ViLT-base from the VQA2 config behind ServingEngine: every bucket
    1-32 once, counted; one sample against the f32 CPU forward."""
    cfg = flagship.vilt_vqa2_config()
    model = flagship.vilt(cfg)
    _check_vilt_config(model.config)
    model.init_weights(torch.Generator().manual_seed(0))
    cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    samples = flagship.split_samples(flagship.vilt_example_batch(SERVE_B,
                                                                 seed=7))
    engine = ServingEngine(model, device=DEV, max_batch_size=SERVE_B,
                           meta=VILT_META)
    t0 = time.perf_counter()
    warmed = engine.warmup(samples[0])
    warm_s = time.perf_counter() - t0
    reset_counts()  # the main path, counted from zero
    outs = {b: engine.predict_many(samples[:b]) for b in engine.buckets}
    torch.cuda.synchronize()
    launches = read_counts()
    n = len(engine.buckets)
    want = dict(ZERO_COUNTS, flash_attention_fwd=VILT_ATTENTION * n,
                layer_norm=VILT_LN * n)
    check(launches == want, f"vilt serving launches {launches}, want "
          f"{want} for buckets {engine.buckets}")
    for b, rows in outs.items():
        check(all(r["scores"].shape == (3129,) and np.isfinite(
            r["scores"]).all() for r in rows), f"vilt bucket {b} scores")
    ref_model = flagship.vilt(cfg)
    ref_model.load_state_dict(cpu_state, strict=True)
    probe = 3
    ref = cpu_forward(ref_model, dict(samples[probe], **VILT_META))["scores"]
    errs, coss = [], []
    for b in (4, SERVE_B):
        got = np.asarray(outs[b][probe]["scores"], np.float32)
        errs.append(float(np.abs(got - ref).max()))
        coss.append(float(got @ ref / (np.linalg.norm(got)
                                       * np.linalg.norm(ref))))
    check(max(errs) <= VILT_SERVE_ATOL and min(coss) >= VILT_SERVE_MIN_COSINE,
          f"vilt served vs f32 CPU: max_abs_err {errs}, cosine {coss}")
    del ref_model
    arrays, statics = engine_lib._split_static(engine_lib._stack_samples(
        samples))
    dev_batch = dict(engine_lib._to_device(arrays, DEV), **VILT_META)

    def forward():
        with torch.inference_mode():
            engine.model(dev_batch)

    fwd_ms = time_ms(forward, iters=3, repeats=3)
    dev_ms, by_category = _device_ms(forward, 3)
    del engine, model
    torch.cuda.empty_cache()
    print(f"phase vilt-serving: ok ViLT-base {n_params / 1e6:.1f}M params "
          f"(12 x {HIDDEN} pre-LN ViT, {VILT_S} tokens: {flagship.VILT_SEQ} "
          f"text, [CLS] and {VILT_PATCHES} patches of 16 px at "
          f"{flagship.VILT_IMAGE} px; the VQA2 MLP head at 1536 over 3129 "
          "answers, and the model defaults' test head, unused), f32, built "
          f"from {flagship.VILT_VQA2_CONFIG}; warmup buckets {list(warmed)} "
          f"in {warm_s:.1f}s; each bucket once: launches {launches} (exact: "
          f"{VILT_ATTENTION} K1 and {VILT_LN} K4 a forward); sample {probe} "
          f"at buckets 4 and 32 vs the f32 CPU forward: max_abs_err "
          f"{max(errs):.4g} (bound {VILT_SERVE_ATOL}), cosine min "
          f"{min(coss):.7f} (bound {VILT_SERVE_MIN_COSINE}); cuBLAS TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32} (the patch convolution)")
    print(f"  on '{card}': f32 forward at bucket 32 {fwd_ms:.2f} ms (CUDA "
          f"events), device time {dev_ms:.3f} ms (torch.profiler, 3 "
          "forwards): " + "; ".join(
              f"{cat} {ms:.3f} x{cnt:.0f}" for cat, (ms, cnt) in
              sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    return launches


def _vilt_build(cfg, overrides):
    """ViLT for the compared steps: dropout 0 everywhere."""
    return _without_dropout(flagship.vilt(cfg, overrides))


def _kernels_vs_plain(cfg, init, batch, build, trainer, steps, label,
                      stats=None, update_held=None, device_out=None):
    """``steps`` steps through the kernels and through the plain versions
    from ``init``: (losses, worst gradient cosine, worst norm-relative
    error, worst update cosine, launches), each bound checked. ``stats``,
    a list, receives the two sides' BatchNorm statistics after the
    steps. ``update_held(name)``: the parameters the update cosine's
    bound holds on (all by default); the others' worst is printed.
    ``device_out``, a list, receives the kernels' steps' device time
    (``_compared_steps``)."""
    k_stats, p_stats = {}, {}
    k_losses, k_grads, k_upd, k_launches = _compared_steps(
        cfg, init, batch, steps=steps, trainer=trainer, build=build,
        no_dropout=(), stats_out=k_stats, device_out=device_out)
    with plain_versions():
        p_losses, p_grads, p_upd, p_launches = _compared_steps(
            cfg, init, batch, steps=steps, trainer=trainer, build=build,
            no_dropout=(), stats_out=p_stats)
    if stats is not None:
        stats.extend([k_stats, p_stats])
    check(p_launches == ZERO_COUNTS, f"{label} plain launches {p_launches}")
    loss_rel = _check_losses(k_losses, p_losses)
    compared, g_cos, g_rel, worst_g, worst_r = _check_gradients(k_grads,
                                                                p_grads)
    u_cos = {n: _cosine(k_upd[n], p_upd[n]) for n in compared
             if float(p_upd[n].abs().max()) > 0}
    held = [n for n in u_cos if update_held is None or update_held(n)]
    worst_u = min(held, key=u_cos.get)
    check(u_cos[worst_u] >= TRAIN_MIN_UPDATE_COSINE,
          f"{label} update cosine {u_cos[worst_u]} at {worst_u}")
    others = ""
    if len(held) < len(u_cos):
        worst_o = min((n for n in u_cos if n not in held), key=u_cos.get)
        others = (f"; not held ({len(u_cos) - len(held)} parameters): min "
                  f"{u_cos[worst_o]:.6f} at {worst_o}")
    del k_grads, p_grads, k_upd, p_upd
    torch.cuda.empty_cache()
    return (f"{steps} steps at dropout 0 (launches {k_launches} vs "
            f"{p_launches}): losses {k_losses} vs {p_losses} (max rel "
            f"{loss_rel:.3g}, bound {TRAIN_LOSS_RTOL}); first-step "
            f"gradients: cosine min {g_cos[worst_g]:.7f} at {worst_g} "
            f"(bound {TRAIN_MIN_GRAD_COSINE}), |g_k - g_p| / |g_p| max "
            f"{g_rel[worst_r]:.3g} at {worst_r} (bound "
            f"{TRAIN_MAX_GRAD_REL}); update cosine min {u_cos[worst_u]:.6f} "
            f"at {worst_u} (bound {TRAIN_MIN_UPDATE_COSINE}; "
            f"{len(held)} parameters that moved{others}); {len(compared)} "
            "parameters compared (the attention key biases left out)"), \
        k_launches


def _timed_steps(step, state, batch, n):
    """1 warm-up and ``n`` counted steps: (state, losses, ms per step,
    launches, peak GB, warm-up s)."""
    t0 = time.perf_counter()
    state, rep = step(state, batch)
    float(rep["total_loss"])
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path, counted from zero
    losses, step_ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, rep = step(state, batch)
        losses.append(float(rep["total_loss"]))  # synchronises
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    check(all(math.isfinite(x) for x in losses) and not bool(
        rep["nan_flag"]), f"losses {losses}")
    return (state, losses, step_ms, launches,
            torch.cuda.max_memory_allocated() / 1e9, warm_s)


def phase_vilt_training(card):
    """ViLT-base's VQA2 finetuning step at B=64, then its MLM + ITM
    pretraining step (the second, masked encoder pass) at B=32."""
    cfg = flagship.vilt_vqa2_config()
    _check_vilt_config(cfg["model_config"]["vilt"])
    host_batch = flagship.vilt_train_batch(TRAIN_B, seed=0)
    model = _no_attention_dropout(flagship.vilt(cfg))
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state, step = flagship.vqa2_trainer(model, cfg, seed=0)
    batch = train_state._to_device(host_batch, DEV)
    state, losses, step_ms, launches, peak_gb, warm_s = _timed_steps(
        step, state, batch, VILT_STEPS)
    per_step = dict(ZERO_COUNTS, flash_attention_fwd_stats=VILT_ATTENTION,
                    flash_attention_bwd_dq=VILT_ATTENTION,
                    flash_attention_bwd_dkv=VILT_ATTENTION,
                    layer_norm=VILT_LN, layer_norm_bwd=VILT_LN)
    check(launches == {k: v * VILT_STEPS for k, v in per_step.items()},
          f"vilt training launches {launches}")

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    dev_ms, by_category = _device_ms(one_step, PROFILED_STEPS)
    best_ms = min(step_ms)
    del state, step, model
    torch.cuda.empty_cache()
    line, k_launches = _kernels_vs_plain(
        cfg, init, batch, _vilt_build, flagship.vqa2_trainer,
        COMPARED_STEPS, "vilt")
    check(k_launches == {k: v * COMPARED_STEPS for k, v in
                         per_step.items()}, f"vilt kernel side {k_launches}")
    print(f"phase vilt-training: ok ViLT-base f32 from end to end, B="
          f"{TRAIN_B}, VQA2 config (AdamW lr 1e-4, warmup_linear, the "
          "vqa2_mlp logit_bce inside the model, the BERT no-decay groups, "
          "no lr multipliers, as in JAX), text-embedding and head dropout "
          "0.1, attention-probability dropout 0 (cut: TransformerConfig's "
          f"0.1 would take the plain path); warm-up step {warm_s:.1f}s; "
          f"{VILT_STEPS} steps, losses {[round(x, 4) for x in losses]}; "
          f"launches {launches} (exact per step: {VILT_ATTENTION} "
          f"K1-stats, K2 and K3, {VILT_LN} K4 and K4-bwd); cuBLAS TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32} on both sides below")
    print(f"  on '{card}': ms per step {[round(x, 2) for x in step_ms]} "
          f"(best {best_ms:.2f}), {TRAIN_B * 1e3 / best_ms:.1f} samples/s "
          f"at best; device time {dev_ms:.2f} ms per step (torch.profiler, "
          f"1 step) against {best_ms:.2f} ms wall: idle "
          f"{100 * (1 - dev_ms / best_ms):.1f}%; max_memory_allocated "
          f"{peak_gb:.2f} GB")
    print("  device time per step by kind of kernel (ms, launches): "
          + "; ".join(f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                      sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    print("  kernels vs plain versions, " + line)
    pretrain = _vilt_pretraining(card)
    return {k: launches[k] + k_launches[k] + pretrain[k] for k in launches}


def _vilt_pretraining(card):
    cfg = flagship.vilt_pretrain_config()
    mc = cfg["model_config"]["vilt"]
    _check_vilt_config(mc, "masked_coco")
    check([h["type"] for h in mc["heads"]["masked_coco"]] ==
          ["mlm_multi", "itm"], f"pretraining heads {mc['heads']}")
    host_batch = flagship.vilt_pretrain_batch(VILT_PRETRAIN_B, seed=0)
    model = _no_attention_dropout(flagship.vilt(cfg))
    model.init_weights(torch.Generator().manual_seed(1))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state, step = flagship.masked_coco_trainer(model, cfg, seed=0)
    batch = train_state._to_device(host_batch, DEV)
    state, losses, step_ms, launches, peak_gb, warm_s = _timed_steps(
        step, state, batch, VILT_PRETRAIN_STEPS)
    _, rep = step(state, batch)
    keys = sorted(rep["losses"])
    check(keys == ["train/masked_coco/itm_loss",
                   "train/masked_coco/masked_lm_loss"], f"losses {keys}")
    per_step = dict(ZERO_COUNTS,
                    flash_attention_fwd_stats=VILT_PRETRAIN_ATTENTION,
                    flash_attention_bwd_dq=VILT_PRETRAIN_ATTENTION,
                    flash_attention_bwd_dkv=VILT_PRETRAIN_ATTENTION,
                    layer_norm=VILT_PRETRAIN_LN,
                    layer_norm_bwd=VILT_PRETRAIN_LN)
    check(launches == {k: v * VILT_PRETRAIN_STEPS for k, v in
                       per_step.items()}, f"vilt pretraining {launches}")
    launches = {k: v + per_step[k] for k, v in launches.items()}

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    dev_ms, by_category = _device_ms(one_step, PROFILED_STEPS, gemm_dim=VOCAB)
    best_ms = min(step_ms)
    del state, step, model, rep
    torch.cuda.empty_cache()
    small = {k: v[:VILT_PRETRAIN_COMPARED_B] if isinstance(
        v, torch.Tensor) else v for k, v in batch.items()}
    line, k_launches = _kernels_vs_plain(
        cfg, init, small, _vilt_build, flagship.masked_coco_trainer,
        VILT_PRETRAIN_COMPARED, "vilt pretraining")
    check(k_launches == {k: v * VILT_PRETRAIN_COMPARED for k, v in
                         per_step.items()}, f"vilt pretraining kernel side "
          f"{k_launches}")
    labels = int((host_batch["lm_label_ids"] >= 0).sum())
    print(f"  MLM + ITM pretraining ({flagship.VILT_PRETRAIN_CONFIG}: the "
          "mlm_multi head over a second encoder pass of the masked ids, "
          f"itm), B={VILT_PRETRAIN_B} (the config's 64 cut: reckoned ~71 "
          f"GB), {labels} masked tokens; warm-up {warm_s:.1f}s; "
          f"{VILT_PRETRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]}; launches exact per step "
          f"({VILT_PRETRAIN_ATTENTION} K1-stats, K2 and K3, "
          f"{VILT_PRETRAIN_LN} K4 and K4-bwd); ms per step "
          f"{[round(x, 2) for x in step_ms]}, device {dev_ms:.2f} ms "
          f"(idle {100 * (1 - dev_ms / min(step_ms)):.1f}%), "
          f"max_memory_allocated {peak_gb:.2f} GB on '{card}'")
    print("    device time per step by kind (ms, launches): " + "; ".join(
        f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
        sorted(by_category.items(), key=lambda kv: -kv[1][0])))
    print(f"    kernels vs plain versions, B={VILT_PRETRAIN_COMPARED_B} "
          "(the batch's first rows: the plain attention's saved scores "
          "would not fit at 32), " + line)
    return {k: launches[k] + k_launches[k] for k in launches}


def _loader_alone(trainer, n, dataset_name="vqa2", batch_size=RUN_B):
    """The train loader alone: ``n`` batches of a restarted epoch
    (workers started again first), batches/s; then one batch's samples
    read and processed in this process, seconds."""
    loader = trainer.train_loader
    next(iter(loader))
    loader.seed_sampler(1)
    t1 = time.perf_counter()
    for _, _b in zip(range(n), loader):
        pass
    bps = n / (time.perf_counter() - t1)
    dataset = trainer.dataset_loader.datamodules[dataset_name].train_dataset
    t1 = time.perf_counter()
    for i in range(batch_size):
        dataset[i]
    return bps, time.perf_counter() - t1


def phase_vilt_run(card):
    """mmf_run finetunes ViLT-base on VQA2 over raw images (the synthetic
    raw-image layout: PNG content under the .jpg names, decoded and
    resized to 384 px by the loader's workers), evaluates and predicts;
    then mmf_serve serves the run's folder."""
    import shutil

    from mmf_tpu_torch.common.registry import registry
    from tests.torch_vqa2_layout import (
        IMAGE_SPLITS,
        image_layout_opts,
        write_image_layout,
    )

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    registry.register_callback("chip_smoke_attention_cut")(_AttentionCut)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vilt_")
    trainer = None
    try:
        t0 = time.perf_counter()
        write_image_layout(tmp, n_train=RUN_SPLITS["train"],
                           n_val=RUN_SPLITS["val"],
                           n_test=RUN_SPLITS["test"], n_images=RUN_IMAGES,
                           min_side=200, max_side=480,
                           num_answers=RUN_ANSWERS, vocab_size=VOCAB, seed=0)
        layout_s = time.perf_counter() - t0
        u = VILT_RUN_UPDATES
        trainer, recorder, launches, run_s = _cli_run(
            os.path.join(tmp, "save"), flagship.VILT_VQA2_CONFIG, "vilt",
            "vqa2", u, [*_evaluated(u), *image_layout_opts(tmp)],
            attention_cut=True)
        _check_vilt_config(trainer.config["model_config"]["vilt"])
        image = recorder.batches[0]["image"]
        check(tuple(image.shape) == (RUN_B, 3, flagship.VILT_IMAGE,
                                     flagship.VILT_IMAGE)
              and image.dtype == torch.float32
              and float(image.abs().max()) <= 1.0 + 1e-6,
              f"vilt batch image {tuple(image.shape)} {image.dtype}")
        rel, losses, acc, sps = _run_checks(
            trainer, recorder, launches, u, VILT_ATTENTION, VILT_LN,
            lambda c: _no_attention_dropout(flagship.vilt(c)),
            "train/vqa2/vqa2_mlp", "vilt",
            os.path.join(tmp, "datasets", IMAGE_SPLITS["test"][0][0]))
        bps, batch_s = _loader_alone(trainer, 6)
        trainer.teardown()
        model = flagship.vilt(trainer.config)
        model.load_state_dict({k: v.cpu() for k, v in
                               trainer.model.state_dict().items()},
                              strict=True)
        served_launches, served = _served_folder(
            card, trainer.config["env"]["save_dir"], model,
            flagship.split_samples(flagship.vilt_example_batch(
                SERVED_REQUESTS, seed=9)),
            dict(ZERO_COUNTS, flash_attention_fwd=VILT_ATTENTION,
                 layer_norm=VILT_LN), VILT_META, "vilt")
        print(f"phase vilt-run: ok mmf_run (cli/run.py's run(opts)) "
              f"finetunes ViLT-base on VQA2 with {flagship.VILT_VQA2_CONFIG} "
              f"over raw images, B={RUN_B}, {RUN_WORKERS} loader workers, on "
              f"the synthetic raw-image layout ({RUN_SPLITS} questions, the "
              f"five split_by_coco_2017 train files, {RUN_IMAGES} PNG images "
              f"of 200-480 px a side, written in {layout_s:.1f}s): {u} "
              f"updates, losses {losses} equal to the train step's on the "
              f"same batches (max rel {rel:.3g}, bound {RUN_LOSS_RTOL}); one "
              f"evaluation and checkpoint; val vqa_accuracy {acc:.4f}; "
              f"reports; launches {launches} (exact); run {run_s:.1f}s, "
              f"train {sps:.1f} samples/s over updates 3-{u}; the loader "
              f"alone {bps:.2f} batches/s, one batch's {RUN_B} samples (PNG "
              f"decode, resize to {flagship.VILT_IMAGE}, tokenizer, answers)"
              f" read in this process in {batch_s:.2f}s, on '{card}'")
        print(served)
    finally:
        if trainer is not None:
            trainer.teardown()
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: launches[k] + served_launches[k] for k in launches}


def phase_mmft_kernels(card):
    """K1, K1-stats, K2 and K3 in bf16 at MMFT's [64, 12, 114, 64] (its
    training batch) and [32, 12, 114, 64] (its serving bucket) with its
    mask, against their plain versions."""
    g = torch.Generator(device=DEV).manual_seed(7)
    rows = {b: _attention_case(f"mmft B={b}", *_mmft_attention_inputs(b, g))
            for b in (TRAIN_B, SERVE_B)}
    print(f"phase mmft-kernels: ok K1, K1-stats, K2 and K3 in bf16 at MMFT's "
          f"{MMFT_S} tokens (14 text + 100 regions, every one valid: 114 = "
          "64 + 50 rows), B = 64 (training) and 32 (the serving bucket), "
          "against their plain versions within the kernels phase's bounds;"
          " device ms (spin-queued), SDPA's, the plain versions' (CUDA "
          f"events), host us a call and the bound on '{card}':")
    for b, r in rows.items():
        ms, lib = r["ms"], r["library_ms"]
        print(f"  {r['shape']}: max_abs_err " + ", ".join(
            f"{n} {e:.3g}" for n, e in r["max_abs_err"].items())
            + "; " + ", ".join(
                f"{n} {ms[n]:.4f} (bound {r['bound_ms'][n]:.4f} "
                f"{r['bound_by'][n]})" for n in ms)
            + f"; sdpa fwd {lib['K1']:.4f}, fwd+lse {lib['K1-stats']:.4f}, "
            f"bwd {lib['K2+K3']:.4f} (K2+K3 {ms['K2'] + ms['K3']:.4f}); "
            "plain " + ", ".join(f"{n} {t:.4f}"
                                 for n, t in r["plain_ms"].items())
            + "; host us " + ", ".join(f"{n} {u:.1f}"
                                       for n, u in r["host_us"].items()))
    torch.cuda.empty_cache()
    return rows[TRAIN_B]


def _mmft_served_vs_plain(model, samples):
    """The in-memory engine's bucket-32 scores through the kernels
    against the same engine's through the plain versions, bf16 on both
    sides: (max abs error, min cosine), checked against the serving
    phase's bounds."""
    engine = ServingEngine(copy.deepcopy(model), device=DEV,
                           max_batch_size=SERVE_B, meta=VILT_META)
    reset_counts()
    got = engine.predict_many(samples)
    k_launches = read_counts()
    with plain_versions():
        want = engine.predict_many(samples)
    p_launches = read_counts()
    check(k_launches == dict(ZERO_COUNTS, flash_attention_fwd=MMFT_ATTENTION,
                             layer_norm=MMFT_LN) and p_launches == k_launches,
          f"mmft served launches {k_launches}, then {p_launches}")
    errs, coss = [], []
    for a, b in zip(got, want):
        a = np.asarray(a["scores"], np.float32)
        b = np.asarray(b["scores"], np.float32)
        check(a.shape == b.shape and np.isfinite(a).all(), f"{a.shape}")
        errs.append(float(np.abs(a - b).max()))
        coss.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
    check(max(errs) <= SERVE_ATOL and min(coss) >= SERVE_MIN_COSINE,
          f"mmft served kernels vs plain: error {max(errs)}, cosine "
          f"{min(coss)}")
    del engine
    torch.cuda.empty_cache()
    return max(errs), min(coss)


def phase_mmft_run(card):
    """mmf_run trains MMFTransformer on VQA2 region features (bf16, the
    vocab text processor's 14 tokens + 100 regions), evaluates and
    predicts; then mmf_serve serves the run's folder."""
    import shutil

    from mmf_tpu_torch.common.registry import registry
    from tests.torch_vqa2_layout import SPLITS, layout_opts, write_layout

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    registry.register_callback("chip_smoke_attention_cut")(_AttentionCut)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mmft_")
    trainer = None
    try:
        t0 = time.perf_counter()
        write_layout(tmp, n_train=RUN_SPLITS["train"],
                     n_val=RUN_SPLITS["val"], n_test=RUN_SPLITS["test"],
                     n_images=RUN_IMAGES, regions=REGIONS, feature_dim=VDIM,
                     num_answers=RUN_ANSWERS, vocab_size=VOCAB, seed=0,
                     glove=True)
        layout_s = time.perf_counter() - t0
        u = MMFT_RUN_UPDATES
        opts = flagship.MMFT_VQA2_OVERRIDES + _evaluated(u) + [
            opt for opt in layout_opts(tmp)
            if "tokenizer_config" not in opt]  # the vocab processor's
        trainer, recorder, launches, run_s = _cli_run(
            os.path.join(tmp, "save"), flagship.MMFT_VQA2_CONFIG,
            "mmf_transformer", "vqa2", u, opts, attention_cut=True)
        mc = trainer.config["model_config"]["mmf_transformer"]
        check((mc["hidden_size"], mc["num_hidden_layers"], mc["dtype"],
               mc["heads"][0]["num_labels"]) == (HIDDEN, 12, "bfloat16",
                                                 3129), dict(mc))
        text = recorder.batches[0]["text"]
        check(tuple(text.shape) == (RUN_B, flagship.MMFT_SEQ), text.shape)
        rel, losses, acc, sps = _run_checks(
            trainer, recorder, launches, u, MMFT_ATTENTION, MMFT_LN,
            lambda c: _no_attention_dropout(flagship.mmft(c)),
            "train/vqa2/logit_bce", "mmft",
            os.path.join(tmp, "datasets", "vqa2", "defaults", "annotations",
                         SPLITS["test"]))
        trainer.teardown()
        # the run's first batch from its initial weights, through the
        # kernels and through the plain versions
        vs_plain, k_launches = _kernels_vs_plain(
            trainer.config, recorder.initial, recorder.batches[0],
            lambda c, o: _without_dropout(flagship.mmft(c, o)),
            flagship.vqa2_trainer, COMPARED_STEPS, "mmft")
        per_step = dict(ZERO_COUNTS, flash_attention_fwd_stats=MMFT_ATTENTION,
                        flash_attention_bwd_dq=MMFT_ATTENTION,
                        flash_attention_bwd_dkv=MMFT_ATTENTION,
                        layer_norm=MMFT_LN, layer_norm_bwd=MMFT_LN)
        check(k_launches == {k: v * COMPARED_STEPS for k, v in
                             per_step.items()}, f"mmft kernel side "
              f"{k_launches}")
        model = flagship.mmft(trainer.config)
        model.load_state_dict({k: v.cpu() for k, v in
                               trainer.model.state_dict().items()},
                              strict=True)
        samples = flagship.split_samples(flagship.mmft_example_batch(
            SERVE_B, seed=9))
        serve_err, serve_cos = _mmft_served_vs_plain(model, samples)
        served_launches, served = _served_folder(
            card, trainer.config["env"]["save_dir"], model, samples,
            dict(ZERO_COUNTS, flash_attention_fwd=MMFT_ATTENTION,
                 layer_norm=MMFT_LN), VILT_META, "mmft")
        print(f"phase mmft-run: ok mmf_run trains MMFTransformer on VQA2 "
              f"features with {flagship.MMFT_VQA2_CONFIG} and "
              "flagship.MMFT_VQA2_OVERRIDES (bf16, 12 x 768, "
              f"{MMFT_S} tokens: the vocab processor's {flagship.MMFT_SEQ} "
              f"and {REGIONS} regions of {VDIM}; the config's 480 cut to "
              f"B={RUN_B}), the synthetic layout with GloVe files (written "
              f"in {layout_s:.1f}s): {u} updates, losses {losses} equal to "
              f"the train step's (max rel {rel:.3g}, bound {RUN_LOSS_RTOL});"
              f" val vqa_accuracy {acc:.4f}; launches {launches} (exact: "
              f"{MMFT_ATTENTION} attention calls and {MMFT_LN} LayerNorms a "
              f"forward); run {run_s:.1f}s, train {sps:.1f} samples/s over "
              f"updates 3-{u} on '{card}'")
        print("  kernels vs plain versions, the run's first batch and "
              f"initial weights, bf16 on both sides: {vs_plain}")
        print(f"  served at bucket 32, kernels vs plain versions (an "
              f"in-memory engine on the run's weights, bf16 on both sides):"
              f" max_abs_err {serve_err:.4g} (bound {SERVE_ATOL}), cosine "
              f"min {serve_cos:.7f} (bound {SERVE_MIN_COSINE})")
        print(served)
    finally:
        if trainer is not None:
            trainer.teardown()
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: launches[k] + served_launches[k] for k in launches}


# -- phases 20-22: Hateful Memes ---------------------------------------------
# MMBT on Hateful Memes: 3 modal tokens (start, the pooled ResNet cell,
# end) before 128 text tokens; the baselines' f32 BERT over 128 tokens
HM_MMBT_S, HM_TEXT_S = 3 + SEQ, SEQ
HM_B = 32  # projects/hateful_memes/configs/mmbt/defaults.yaml's batch
HM_BASELINE_B = 64  # concat_bert's and late_fusion's
HM_UPDATES = 4
HM_SPLITS = {"train": 256, "val": 32, "test": 32}
HM_IMAGES = 32  # memes of 300-800 px a side; samples share them
HM_LN = 26  # MMBT: 24 in the layers, the embedding LayerNorm twice
BERT_LN = 25  # the baselines' TransformerModel: 24 and the embeddings'
HM_ATTENTION = 12
# the ResNet's BatchNorm statistics after the compared steps, kernels
# against plain versions, relative to each tensor's largest entry: the
# ResNet runs neither kernel, but the second and third steps' batch
# statistics come from weights that Adam's first update moved by +-lr
# wherever a gradient lies within bf16 noise of 0, which differs between
# the sides (measured 5.1e-3 on an NVIDIA H100 80GB HBM3, 700 W)
HM_STATS_REL = 3e-2
# the baselines: (HATEFUL_MEMES_CONFIGS key, batch, BERT text encoder)
HM_BASELINES = (("concat_bert", 64, True), ("late_fusion", 64, True),
                ("concat_bow", 32, False), ("unimodal_text", 64, False),
                ("unimodal_text_bert", 128, True),
                ("unimodal_image", 32, False))
HM_BASELINE_UPDATES = 2


def _hm_attention_inputs(b, s, n_modal, dtype, g):
    """q, k, v, dO [b, 12, s, 64] as the views the attention block hands
    over, and a Hateful Memes mask as a bias: ``n_modal`` modal tokens,
    always valid, then texts of 6 tokens to the rest."""
    def proj():
        return torch.randn(b, s, HEADS, HEAD_DIM, device=DEV,
                           generator=g).to(dtype).transpose(1, 2)

    lengths = torch.randint(6, s - n_modal + 1, (b,), device=DEV,
                            generator=g)
    text = (torch.arange(s - n_modal, device=DEV)[None] < lengths[:, None])
    mask = torch.cat([torch.ones(b, n_modal, dtype=torch.int32, device=DEV),
                      text.int()], dim=1)
    return (proj(), proj(), proj(), A.make_attention_bias(mask, dtype),
            proj())


def phase_hm_kernels(card):
    """K1 (all three forms), K2 and K3 at MMBT's [32, 12, 131, 64] bf16
    and the baselines' [64, 12, 128, 64] f32, against their plain
    versions."""
    g = torch.Generator(device=DEV).manual_seed(13)
    rows, raws = {}, {}
    for label, b, s, n_modal, dt in (
            ("mmbt", HM_B, HM_MMBT_S, 3, torch.bfloat16),
            ("baselines", HM_BASELINE_B, HM_TEXT_S, 0, torch.float32)):
        q, k, v, bias, dout = _hm_attention_inputs(b, s, n_modal, dt, g)
        rows[label] = _attention_case(f"hateful memes {label}", q, k, v,
                                      bias, dout)
        raws[label] = _raw_case(q, k, v, bias, label, iters=20,
                                plain_iters=10)
        del q, k, v, bias, dout
    torch.cuda.empty_cache()
    print(f"phase hm-kernels: ok K1, K1-stats, K1-raw, K2 and K3 at MMBT's "
          f"[{HM_B}, 12, {HM_MMBT_S}, 64] bf16 (3 modal tokens and texts of "
          f"6-{SEQ} tokens: 131 = 2 x 64 + 3 rows) and the f32 baselines' "
          f"[{HM_BASELINE_B}, 12, {HM_TEXT_S}, 64] (texts of 6-{SEQ} "
          "tokens: two full tiles), against their plain versions within "
          "the kernels phase's bounds (K1's three forms bit-equal across "
          "two calls); device ms (spin-queued), SDPA's, the plain "
          "versions' (CUDA events), host us a call and the bound (f32: "
          "split-TF32 operations or bytes, the FP32 FMA bound beside it) "
          f"on '{card}':")
    for label, r in rows.items():
        ms, lib, raw = r["ms"], r["library_ms"], raws[label]
        fma = r["fma_bound_ms"]
        print(f"  {label} {r['shape']}: max_abs_err " + ", ".join(
            f"{n} {e:.3g}" for n, e in r["max_abs_err"].items())
            + f", K1-raw {raw['max_abs_err']:.3g}; " + ", ".join(
                f"{n} {ms[n]:.4f} (bound {r['bound_ms'][n]:.4f} "
                f"{r['bound_by'][n]}"
                + (f", FMA {fma[n]:.4f}" if fma else "") + ")" for n in ms)
            + f", K1-raw {raw['ms']:.4f} (bound {raw['bound_ms']:.4f} "
            f"{raw['bound_by']}; plain {raw['plain_ms']:.4f}); sdpa fwd "
            f"{lib['K1']:.4f}, fwd+lse {lib['K1-stats']:.4f}, bwd "
            f"{lib['K2+K3']:.4f} (K2+K3 {ms['K2'] + ms['K3']:.4f}); plain "
            + ", ".join(f"{n} {t:.4f}" for n, t in r["plain_ms"].items())
            + "; host us " + ", ".join(f"{n} {u:.1f}" for n, u in
                                       r["host_us"].items())
            + f", K1-raw {raw['host_us']:.1f}")
    return rows, raws


def _hm_layout(tmp):
    from tests.torch_hm_layout import write_layout

    t0 = time.perf_counter()
    write_layout(tmp, n_train=HM_SPLITS["train"], n_val=HM_SPLITS["val"],
                 n_test=HM_SPLITS["test"], n_images=HM_IMAGES,
                 vocab_size=VOCAB, seed=0)
    return time.perf_counter() - t0


def _hm_opts(tmp, key, updates):
    from tests.torch_hm_layout import layout_opts

    bert = flagship.HATEFUL_MEMES_CONFIGS[key][1]
    opts = _evaluated(updates) + layout_opts(tmp, bert) + \
        flagship.HATEFUL_MEMES_OVERRIDES.get(key, [])
    if key != "mmbt":
        # the final model only: no validation inside a baseline's run (the
        # trainer evaluates val after it, _hm_reports), whose early
        # stopping would write the best and current checkpoints, 0.8-2 GB
        # each with the optimizer state, and read the best back
        opts += ["training.evaluation_interval=1000", *LOADER_IN_PROCESS]
    return opts


def _hm_reports(trainer, label):
    """The run's csv prediction reports: one row a val and a test sample,
    columns id, proba, label; then val's accuracy, binary_f1 and roc_auc
    through the evaluation loop, each finite."""
    import csv
    import glob

    save_dir = trainer.config["env"]["save_dir"]
    rows = {}
    for split in ("val", "test"):
        files = glob.glob(os.path.join(save_dir, "reports",
                                       f"hateful_memes_*_{split}_*.csv"))
        check(len(files) == 1, f"{label} {split} reports {files}")
        with open(files[0]) as f:
            rows[split] = list(csv.DictReader(f))
        check(len(rows[split]) == HM_SPLITS[split] and all(
            list(r) == ["id", "proba", "label"]
            and 0.0 <= float(r["proba"]) <= 1.0 and r["label"] in "01"
            for r in rows[split]), f"{label} {split} rows {rows[split][:2]}")
    report, meter = trainer.evaluation_loop("val")
    metrics = {k: meter.meters[f"val/hateful_memes/{k}"].global_avg
               for k in ("accuracy", "binary_f1", "roc_auc")}
    check(report.batch_size == HM_SPLITS["val"] and all(
        math.isfinite(v) for v in metrics.values()),
        f"{label} val {report.batch_size} samples, {metrics}")
    return metrics


def _hm_step_device_ms(cfg, recorder):
    """Device time of the train step alone (torch.profiler, 1 step after
    a warm-up) from the run's initial weights on its first batch: (ms a
    step, {category: (ms, launches)})."""
    model = flagship.hateful_memes_model(cfg)
    model.load_state_dict(recorder.initial, strict=True)
    state, step = flagship.hateful_memes_trainer(model, cfg, seed=1,
                                                 device=DEV)
    box = [state]

    def one_step():
        box[0], rep = step(box[0], recorder.batches[0])
        float(rep["total_loss"])

    one_step()
    result = _device_ms(one_step, PROFILED_STEPS)
    del state, step, model, box
    torch.cuda.empty_cache()
    return result


def _hm_forwards(batch_size, validated=True):
    """A run's evaluation forwards: the validation inside the run (where
    ``validated``), then the val and test predictions."""
    val = -(-HM_SPLITS["val"] // batch_size)
    return (1 + validated) * val + -(-HM_SPLITS["test"] // batch_size)


def phase_hm_mmbt_run(card):
    """mmf_run trains MMBT on Hateful Memes from its project config over
    raw images (ResNet-152 at 224 px trained with its BatchNorm
    statistics), evaluates and predicts csv rows; then 3 steps from the
    run's initial weights through the kernels against the plain
    versions at attention dropout 0."""
    import shutil

    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.modules.resnet import BatchNorm

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hm_")
    trainer = None
    key, u = "mmbt", HM_UPDATES
    try:
        layout_s = _hm_layout(tmp)
        torch.cuda.reset_peak_memory_stats()
        trainer, recorder, launches, run_s = _cli_run(
            os.path.join(tmp, "save"), flagship.HATEFUL_MEMES_CONFIGS[key][0],
            key, "hateful_memes", u, _hm_opts(tmp, key, u),
            batch_size=HM_B)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        mc = trainer.config["model_config"]["mmbt"]
        text = mc["text_encoder"]["params"]
        sched = trainer.config["scheduler"]["params"]["num_training_steps"]
        check((text["hidden_size"], text["num_hidden_layers"], mc["dtype"],
               mc["num_labels"], trainer.config["evaluation"][
                   "predict_file_format"], sched) == (
            HIDDEN, 12, "bfloat16", 2, "csv", u), f"{dict(mc)} {sched}")
        batch = recorder.batches[0]
        check(tuple(batch["image"].shape) == (HM_B, 3, 224, 224)
              and tuple(batch["input_ids"].shape) == (HM_B, SEQ),
              f"mmbt batch {tuple(batch['image'].shape)}")
        losses = list(trainer.meter.meters[
            "train/hateful_memes/cross_entropy"].averaged_value_deque)
        check(len(losses) == u and all(math.isfinite(x) for x in losses),
              f"mmbt losses {losses}")
        # the config's attention-probability dropout (0.1) sends the
        # training steps' attention to the plain version, as in JAX
        forwards = _hm_forwards(HM_B)
        want = dict(ZERO_COUNTS, flash_attention_fwd=HM_ATTENTION * forwards,
                    layer_norm=HM_LN * (u + forwards),
                    layer_norm_bwd=HM_LN * u)
        check(launches == want, f"mmbt launches {launches}, want {want}")
        n_bn = sum(isinstance(m, BatchNorm) for m in trainer.model.modules())
        stats = dict(trainer.model.named_buffers())
        check(int(stats["ResNet152ImageEncoder_0.model.bn1."
                        "num_batches_tracked"]) == u, "BatchNorm steps")
        metrics = _hm_reports(trainer, "mmbt")
        t = recorder.loss_read
        steady = [n for n in range(3, u + 1)]
        sps = HM_B * len(steady) / (t[u] - t[2])
        update_ms = 1e3 * (t[u] - t[2]) / len(steady)
        meters = trainer.profile_meter.meters
        split = {k: 1e3 * meters[k].median for k in RUN_POINTS
                 if k in meters and meters[k].averaged_value_deque}
        bps, batch_s = _loader_alone(trainer, 4, "hateful_memes", HM_B)
        trainer.teardown()

        # the train step alone on the run's first batch: device time
        # by kind, against the CLI's update time
        cfg = trainer.config
        dev_ms, by_category = _hm_step_device_ms(cfg, recorder)

        # kernels vs plain versions at attention dropout 0. Adam's first
        # steps move each weight by about its lr whatever its gradient's
        # size, so an update's cosine counts the signs that agree; the
        # ResNet's gradients reach it through the bf16 trunk, and those
        # within bf16 noise of 0 step either way: the ResNet is held by
        # its gradients and its BatchNorm statistics, the update cosine
        # by the trunk
        bn_stats = []
        vs_plain, k_launches = _kernels_vs_plain(
            cfg, recorder.initial, batch,
            lambda c, o: _without_dropout(flagship.hateful_memes_model(c, o)),
            flagship.hateful_memes_trainer, COMPARED_STEPS, "mmbt",
            stats=bn_stats,
            update_held=lambda n: not n.startswith("ResNet152ImageEncoder"))
        per_step = dict(ZERO_COUNTS, flash_attention_fwd_stats=HM_ATTENTION,
                        flash_attention_bwd_dq=HM_ATTENTION,
                        flash_attention_bwd_dkv=HM_ATTENTION,
                        layer_norm=HM_LN, layer_norm_bwd=HM_LN)
        check(k_launches == {k: v * COMPARED_STEPS for k, v in
                             per_step.items()}, f"mmbt kernel side "
              f"{k_launches}")
        k_stats, p_stats = bn_stats
        check(set(k_stats) == set(p_stats) and len(k_stats) == 2 * n_bn,
              f"{len(k_stats)} running statistics, {n_bn} BatchNorms")
        stats_err = {n: float((k_stats[n] - p_stats[n]).abs().max())
                     / float(p_stats[n].abs().max()) for n in k_stats}
        worst_s = max(stats_err, key=stats_err.get)
        stats_rel = stats_err[worst_s]
        moved = min(float((p_stats[n] - recorder.initial[n]).abs().max())
                    for n in p_stats)
        check(stats_rel <= HM_STATS_REL and moved > 0,
              f"mmbt BatchNorm statistics kernels vs plain: {stats_rel} at "
              f"{worst_s}; least moved {moved}")
        print(f"phase hm-mmbt-run: ok mmf_run trains MMBT on Hateful Memes "
              f"with {flagship.HATEFUL_MEMES_CONFIGS[key][0]} over raw images"
              f" (ResNet-152 at 224 px in training mode, {n_bn} BatchNorms; "
              f"12 x {HIDDEN} bf16 trunk over {HM_MMBT_S} tokens; B={HM_B}, "
              f"{RUN_WORKERS} loader workers; the synthetic layout: "
              f"{HM_SPLITS} memes over {HM_IMAGES} PNG images of 300-800 px,"
              f" written in {layout_s:.1f}s; warmup cut to 2): {u} updates, "
              f"losses {[round(x, 4) for x in losses]}; launches "
              f"{launches} (exact: {HM_LN} K4 and K4-bwd an update, the "
              "training attention plain at the config's dropout 0.1; 12 K1 "
              f"+ {HM_LN} K4 in each of {forwards} eval forwards); val "
              + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
              + f"; csv reports of {HM_SPLITS['val']} val and "
              f"{HM_SPLITS['test']} test rows (id,proba,label); "
              f"num_training_steps '${{training.max_updates}}' read as {sched}")
        print(f"  on '{card}': train {sps:.1f} samples/s over updates "
              f"3-{u} ({update_ms:.1f} ms an update); the loader alone "
              f"{bps:.2f} batches/s ({HM_B * bps:.0f} samples/s), one "
              f"batch's {HM_B} samples (PNG decode, resize 256, crop 224, "
              f"tokenizer) in this process {batch_s:.2f}s; host split (ms, "
              "median of the run's updates): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in split.items())
              + f"; device time {dev_ms:.2f} ms a step (torch.profiler, 1 "
              f"step of the train step alone on the run's first batch): "
              f"idle {100 * max(0.0, 1 - dev_ms / update_ms):.1f}% of the "
              f"CLI's update; run {run_s:.1f}s; max_memory_allocated "
              f"{peak_gb:.2f} GB")
        print("  device time a step by kind of kernel (ms, launches): "
              + "; ".join(f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                          sorted(by_category.items(),
                                 key=lambda kv: -kv[1][0])))
        print(f"  kernels vs plain versions, the run's first batch and "
              f"initial weights at dropout 0: {vs_plain}; the ResNet's "
              f"BatchNorm statistics after the {COMPARED_STEPS} steps: max "
              f"rel {stats_rel:.3g} at {worst_s} (bound {HM_STATS_REL}), "
              f"every one moved from its initial value (least {moved:.3g})")
    finally:
        if trainer is not None:
            trainer.teardown()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _hm_served_vs_cpu(model, label):
    """The run's model served at bucket 32 (an in-memory engine, the
    kernels) against the f32 CPU forward of the same weights (plain
    versions): (max abs error over the largest |score|, cosine of the
    scores), checked against the ViLT phase's f32 bounds taken relative
    to the largest score (the ResNet's eval activations at seeded
    weights reach 1e3 and more)."""
    batch = flagship.hateful_memes_train_batch(SERVE_B, seed=9)
    batch.pop("targets")
    samples = flagship.split_samples(dict(batch, **flagship.HATEFUL_MEMES_META))
    engine = ServingEngine(copy.deepcopy(model), device=DEV,
                           max_batch_size=SERVE_B)
    reset_counts()
    got = np.stack([np.asarray(o["scores"], np.float32)
                    for o in engine.predict_many(samples)])
    launches = read_counts()
    check(launches == dict(ZERO_COUNTS, flash_attention_fwd=HM_ATTENTION,
                           layer_norm=BERT_LN),
          f"{label} served launches {launches}")
    del engine
    cpu = copy.deepcopy(model).cpu().eval()
    cpu_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        want = cpu(dict(cpu_batch, **flagship.HATEFUL_MEMES_META))[
            "scores"].float().numpy()
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / top
    cos = float((got * want).sum() / (np.linalg.norm(got)
                                      * np.linalg.norm(want)))
    check(got.shape == want.shape and err <= VILT_SERVE_ATOL
          and cos >= VILT_SERVE_MIN_COSINE,
          f"{label} served vs CPU f32: rel {err}, cosine {cos}")
    return err, cos, top


def phase_hm_baselines(card):
    """mmf_run trains, evaluates and predicts each Hateful Memes baseline
    from its project config at its batch size; concat_bert's bucket-32
    forward against the CPU."""
    import shutil

    from mmf_tpu_torch.common.registry import registry

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hm_baselines_")
    total = dict(ZERO_COUNTS)
    lines = []
    served = step_ms = None
    u = HM_BASELINE_UPDATES
    try:
        layout_s = _hm_layout(tmp)
        for key, b, bert in HM_BASELINES:
            name = flagship.hateful_memes_model_name(key)
            torch.cuda.reset_peak_memory_stats()
            trainer, recorder, launches, run_s = _cli_run(
                os.path.join(tmp, f"save_{key}"),
                flagship.HATEFUL_MEMES_CONFIGS[key][0], name,
                "hateful_memes", u, _hm_opts(tmp, key, u), batch_size=b)
            try:
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                check(int(trainer.config["training"]["batch_size"]) == b,
                      f"{key} batch size")
                losses = list(trainer.meter.meters[
                    "train/hateful_memes/cross_entropy"].averaged_value_deque)
                check(len(losses) == u and all(math.isfinite(x)
                                               for x in losses),
                      f"{key} losses {losses}")
                forwards = _hm_forwards(b, validated=False)
                want = dict(ZERO_COUNTS)
                if bert:
                    want.update(flash_attention_fwd=HM_ATTENTION * forwards,
                                layer_norm=BERT_LN * (u + forwards),
                                layer_norm_bwd=BERT_LN * u)
                check(launches == want, f"{key} launches {launches}, want "
                      f"{want}")
                metrics = _hm_reports(trainer, key)
                t = recorder.loss_read
                n_params = sum(p.numel() for p in trainer.model.parameters())
                lines.append(
                    f"  {key} ({n_params / 1e6:.1f}M params, B={b}): losses "
                    f"{[round(x, 4) for x in losses]}; launches "
                    f"{ {k: v for k, v in launches.items() if v} or 'none'} "
                    "(exact" + (f": {BERT_LN} K4 and K4-bwd an update, 12 K1"
                                f" + {BERT_LN} K4 in each of {forwards} eval"
                                " forwards" if bert else "") + "); val "
                    + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
                    + f"; update 2 {1e3 * (t[2] - t[1]):.1f} ms; run "
                    f"{run_s:.1f}s; max_memory_allocated {peak_gb:.2f} GB")
                for k in total:
                    total[k] += launches[k]
                if key == "concat_bert":
                    model = flagship.hateful_memes_model(trainer.config)
                    model.load_state_dict({k: v.cpu() for k, v in
                                           trainer.model.state_dict().items()},
                                          strict=True)
                    served = _hm_served_vs_cpu(model, key)
                    del model
                    # the f32 BERT's GEMMs run without TF32 (cuBLAS's
                    # default): their share of a step
                    step_ms = _hm_step_device_ms(trainer.config, recorder)
            finally:
                trainer.teardown()
                del trainer, recorder
                torch.cuda.empty_cache()
        err, cos, top = served
        print(f"phase hm-baselines: ok mmf_run trains each Hateful Memes "
              f"baseline from its project config ({u} updates, no "
              "validation inside the run, the loader in the main process, "
              "csv predictions, then one evaluation of val; the synthetic "
              "layout written in "
              f"{layout_s:.1f}s; warmup cut to 2; the unimodal text configs "
              "with flagship.HATEFUL_MEMES_OVERRIDES' optimizer); the BERT "
              "text encoders in f32, their training attention plain at "
              f"dropout 0.1, on '{card}':")
        for line in lines:
            print(line)
        dev_ms, by_category = step_ms
        print(f"  concat_bert's step (B={HM_BASELINE_B}) alone on its run's "
              f"first batch: device time {dev_ms:.2f} ms (torch.profiler, 1 "
              "step), GEMMs "
              f"{100 * by_category.get('GEMMs', (0.0, 0))[0] / dev_ms:.0f}% "
              "of it (the f32 BERT's, TF32 off, and the classifier's); by "
              "kind (ms, launches): " + "; ".join(
                  f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                  sorted(by_category.items(), key=lambda kv: -kv[1][0])))
        print(f"  concat_bert at bucket 32 (an in-memory engine on the run's"
              f" weights, the kernels, cuDNN's TF32 default) against its f32 "
              f"CPU forward: max abs err {err:.3g} of the largest |score| "
              f"{top:.4g} (bound {VILT_SERVE_ATOL}), cosine {cos:.7f} (bound"
              f" {VILT_SERVE_MIN_COSINE})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


# M4C on TextVQA (flagship.textvqa_m4c_config: TextBert 3 x 768 over 20
# question tokens, MMT 4 x 768 over 20 + 100 + 50 prefix tokens and 12
# decode steps, 5000 answers and 50 OCR copy slots, f32), at the config's
# batch
M4C_B = 128
M4C_PREFIX = flagship.M4C_TEXT + flagship.M4C_OBJECTS + flagship.M4C_OCR
M4C_S = M4C_PREFIX + flagship.M4C_STEPS  # 182
# attention calls: TextBert's 3 and the MMT's 4 a training pass; an
# evaluation forward's greedy decode runs TextBert, the prefill (4) and
# 4 a decode step over its 12 steps: 3 + 4 + 48 = 55 K1
M4C_TRAIN_ATTENTION = 3 + 4
M4C_EVAL_ATTENTION = 3 + 4 + 4 * flagship.M4C_STEPS
# LayerNorms, each a ResidualLayerNorm (K4; K4-bwd in training):
# TextBert's embeddings and 2 a layer (7), the object and OCR branches'
# feature and box LayerNorms (4), PrevPredEmbeddings' answer, OCR and
# embedding LayerNorms (3) and 2 an MMT layer (8): a training pass 22; an
# evaluation forward 7 + 4, the prefill's 8, and 3 + 8 a decode step
M4C_TRAIN_LN = 7 + 4 + 3 + 8
M4C_EVAL_LN = 7 + 4 + 8 + flagship.M4C_STEPS * (3 + 8)
M4C_UPDATES = 8
M4C_SPLITS = {"train": 1024, "val": 256, "test": 128}
M4C_IMAGES = 200  # TextVQA images hold up to 50 OCR tokens; samples share
# every dropout of the model at 0 (the config keys reach each of them)
M4C_NO_DROPOUT = {
    "text_bert": {"hidden_dropout_prob": 0.0,
                  "attention_probs_dropout_prob": 0.0},
    "mmt": {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
    "obj": {"dropout_prob": 0.0}, "ocr": {"dropout_prob": 0.0}}
# the cached greedy decode against 12 full passes, step by step on the same
# fed-back indices: the scores of a step, relative to its largest |score|
# (f32 GEMMs of other shapes: 170 prefix rows recomputed against cached),
# and an argmax may differ only where the full pass's top-2 margin is
# within 10x that difference
M4C_DECODE_REL = 1e-4


def _m4c_attention_inputs(case, g, b=M4C_B):
    """M4C's attention calls, f32 q, k, v, dO as the views the attention
    block hands over, with its -10000 biases: TextBert over 20 question
    tokens of 1-20 (a [B,1,1,20] padding bias); the training pass over
    182 = 20 + 100 + 50 + 12 tokens with the per-row prefix-LM bias
    [B,1,182,182] (ragged questions, 50-100 objects, 0-50 OCR tokens, the
    decode span causal); the prefill over the 170 prefix tokens
    ([B,1,1,170]); the decode's 12 queries over 170 cached + 12 own keys
    (bias [B,1,12,182], the training bias's last rows)."""
    spans = ((flagship.M4C_TEXT, 1), (flagship.M4C_OBJECTS,
                                      flagship.M4C_OBJECTS // 2),
             (flagship.M4C_OCR, 0))
    valid = [torch.arange(n, device=DEV)[None] < torch.randint(
        lo, n + 1, (b, 1), device=DEV, generator=g) for n, lo in spans]
    steps = flagship.M4C_STEPS
    mask = torch.cat(valid + [torch.ones(b, steps, dtype=torch.bool,
                                         device=DEV)], 1).float()
    if case in ("textbert", "prefill"):
        n = flagship.M4C_TEXT if case == "textbert" else M4C_PREFIX
        sq = skv = n
        bias = ((1.0 - mask[:, :n]) * -10000.0)[:, None, None, :]
    else:
        ext = mask[:, None, None, :].expand(b, 1, M4C_S, M4C_S).clone()
        ext[:, :, -steps:, -steps:] = torch.tril(
            torch.ones(steps, steps, device=DEV))
        bias = (1.0 - ext) * -10000.0
        sq, skv = (steps, M4C_S) if case == "decode" else (M4C_S, M4C_S)
        if case == "decode":
            bias = bias[:, :, -steps:].contiguous()

    def proj(s):
        return torch.randn(b, s, HEADS, HEAD_DIM, device=DEV,
                           generator=g).transpose(1, 2)

    return proj(sq), proj(skv), proj(skv), bias, proj(sq)


def phase_m4c_kernels(card):
    """K1 (its three forms), K2 and K3 in f32 at M4C's four attention
    shapes against their plain versions, timed beside SDPA; K1 over the
    cached prefix K/V against K1 over the whole sequence's rows."""
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity
    g = torch.Generator(device=DEV).manual_seed(14)
    rows, raws = {}, {}
    for case in ("textbert", "train", "prefill", "decode"):
        q, k, v, bias, dout = _m4c_attention_inputs(case, g)
        rows[case] = _attention_case(f"m4c {case}", q, k, v, bias, dout)
        raws[case] = _raw_case(q, k, v, bias, f"m4c {case}", iters=20,
                               plain_iters=10)
        del q, k, v, bias, dout
    q, k, v, bias, _ = _m4c_attention_inputs("train", g)
    steps = flagship.M4C_STEPS
    full = A.flash_attention(q, k, v, bias)[:, :, -steps:]
    cached = A.flash_attention(q[:, :, -steps:], k, v,
                               bias[:, :, -steps:].contiguous())
    torch.cuda.synchronize()
    cache_err = float((cached - full).abs().max())
    bit_equal = torch.equal(cached, full)
    check(cache_err <= 1e-6, f"m4c cached decode K1 vs the full pass's "
          f"rows: {cache_err}")
    del q, k, v, bias, full, cached
    torch.cuda.empty_cache()
    print(f"phase m4c-kernels: ok K1, K1-stats, K1-raw, K2 and K3 in f32 at "
          f"M4C's shapes (B={M4C_B}, 12 heads of 64, the -10000 biases): "
          f"TextBert [{M4C_B}, 12, {flagship.M4C_TEXT}, 64] (padding bias), "
          f"the training pass [{M4C_B}, 12, {M4C_S}, 64] (the per-row "
          f"prefix-LM bias [B, 1, {M4C_S}, {M4C_S}]), the prefill "
          f"[{M4C_B}, 12, {M4C_PREFIX}, 64] and the decode (12 queries over "
          f"{M4C_S} keys, bias [B, 1, 12, {M4C_S}]), against their plain "
          "versions within the kernels phase's bounds (K1's three forms "
          "bit-equal across two calls); K1 over the cached prefix K/V "
          f"against K1 over the {M4C_S} tokens' last 12 rows: max abs "
          f"{cache_err:.3g} (bound 1e-6), bit-equal {bit_equal}; device ms "
          "(spin-queued), SDPA's, the plain versions' (CUDA events), host "
          "us a call and the bound (split-TF32 operations or bytes, the "
          f"FP32 FMA bound beside it) on '{card}':")
    for case, r in rows.items():
        ms, lib, raw, fma = r["ms"], r["library_ms"], raws[case], \
            r["fma_bound_ms"]
        print(f"  {case} {r['shape']}: max_abs_err " + ", ".join(
            f"{n} {e:.3g}" for n, e in r["max_abs_err"].items())
            + f", K1-raw {raw['max_abs_err']:.3g}; " + ", ".join(
                f"{n} {ms[n]:.4f} (bound {r['bound_ms'][n]:.4f} "
                f"{r['bound_by'][n]}, FMA {fma[n]:.4f})" for n in ms)
            + f", K1-raw {raw['ms']:.4f} (bound {raw['bound_ms']:.4f} "
            f"{raw['bound_by']}; plain {raw['plain_ms']:.4f}); sdpa fwd "
            f"{lib['K1']:.4f}, fwd+lse {lib['K1-stats']:.4f}, bwd "
            f"{lib['K2+K3']:.4f} (K2+K3 {ms['K2'] + ms['K3']:.4f}); plain "
            + ", ".join(f"{n} {t:.4f}" for n, t in r["plain_ms"].items())
            + "; host us " + ", ".join(f"{n} {u:.1f}" for n, u in
                                       r["host_us"].items())
            + f", K1-raw {raw['host_us']:.1f}")
    return rows, raws


def _m4c_native_libraries(words):
    """The LMDB core and the PHOC featurizer: built from the checkout's
    sources under build/ and loaded in this process, and the C PHOC equal
    to its python twin on ``words``: (library file -> path)."""
    from mmf_tpu_torch.utils.native import build as native_build
    from mmf_tpu_torch.utils.native import lmdb_shim
    from mmf_tpu_torch.utils.phoc import build_phoc

    lmdb_shim.library()
    got = build_phoc.build_phoc_batch(words)
    want = np.stack([build_phoc.build_phoc_python(build_phoc._normalize(w))
                     for w in words])
    check(np.array_equal(got, want) and got.any(), "PHOC C vs python twin")
    libs = native_build.loaded()
    root = os.path.dirname(os.path.abspath(__file__))
    check(sorted(n.split("-")[0] for n in libs) == ["liblmdbcore", "libphoc"]
          and all(p.startswith(os.path.join(root, "build", "mmf_tpu_torch",
                                            "native")) for p in libs.values()),
          f"native libraries {libs}")
    return libs


def _m4c_decode_against_full_passes(model, batch):
    """The cached greedy decode (prefill, then decode_step over the
    cached K/V) against 12 full passes of MMT.forward (the reference's
    decode), step by step from the same fed-back indices (the full
    pass's argmax): (worst relative score difference, argmax mismatches,
    near-tie mismatches, the model's own decode equal to the stepped
    one). A mismatch is allowed only where the full pass's top-2 margin
    lies within 10x the two paths' score difference."""
    model.eval()
    steps = flagship.M4C_STEPS
    with torch.no_grad():
        encoded = model._encode(batch)
        txt_mask, obj_mask, ocr_mmt_in, ocr_mask = (encoded[1], encoded[3],
                                                    encoded[4], encoded[5])
        inds = torch.zeros(M4C_B, steps, dtype=torch.long, device=DEV)
        inds[:, 0] = int(model.config.get("bos_idx", 1))
        enc_seq, kvs, enc_mask = model.mmt.prefill(*encoded)
        start = txt_mask.shape[-1] + obj_mask.shape[-1]
        ocr_out = enc_seq[:, start:start + ocr_mask.shape[-1]]
        worst, mismatches, ties = 0.0, 0, 0
        for t in range(steps):
            res = model.mmt(*encoded, model.classifier_w, inds)
            full = model._scores(res["mmt_dec_output"],
                                 res["mmt_ocr_output"], ocr_mask).float()
            dec = model.mmt.decode_step(kvs, enc_mask, model.classifier_w,
                                        ocr_mmt_in, inds)
            cached = model._scores(dec, ocr_out, ocr_mask).float()
            diff = (cached[:, t] - full[:, t]).abs().amax(-1)
            top = full[:, t].abs().amax(-1)
            worst = max(worst, float((diff / top).max()))
            top2 = full[:, t].topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            differ = cached[:, t].argmax(-1) != full[:, t].argmax(-1)
            mismatches += int(differ.sum())
            ties += int((differ & (margin <= 10 * diff)).sum())
            inds = torch.cat([inds[:, :1], full.argmax(-1)[:, :-1]], 1)
        own = model(batch)["scores"].argmax(-1)
    return worst, mismatches, ties, torch.equal(own, full.argmax(-1))


def phase_m4c_run(card):
    """mmf_run trains M4C on TextVQA at full width from its project
    config, reading region and OCR features from LMDB, evaluates with the
    greedy decode and textvqa_accuracy, and predicts the answers; the
    decode against 12 full passes; 3 steps from the run's initial weights
    through the kernels against the plain versions at dropout 0."""
    import glob
    import shutil

    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.datasets.processors import processors as P
    from tests.torch_textvqa_layout import (
        SPLITS,
        FastTextStandIn,
        layout_opts,
        write_layout,
    )

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_m4c_")
    # the run's folder outlives the phase: m4c-serve serves it
    save = tempfile.mkdtemp(prefix="chip_smoke_m4c_save_")
    served = False
    trainer = None
    load_fasttext = P.FastTextProcessor._load_fasttext_model

    def stand_in(self, model_file):  # wiki.en.bin's seeded stand-in
        self.model = FastTextStandIn()

    P.FastTextProcessor._load_fasttext_model = stand_in
    u, steps = M4C_UPDATES, flagship.M4C_STEPS
    try:
        t0 = time.perf_counter()
        write_layout(tmp, n_train=M4C_SPLITS["train"],
                     n_val=M4C_SPLITS["val"], n_test=M4C_SPLITS["test"],
                     n_images=M4C_IMAGES, num_answers=flagship.M4C_ANSWERS,
                     vocab_size=VOCAB, seed=0)
        layout_s = time.perf_counter() - t0
        lmdb_mb = sum(os.path.getsize(f) for f in glob.glob(os.path.join(
            tmp, "datasets", "textvqa", "**", "data.mdb"),
            recursive=True)) / 1e6
        torch.cuda.reset_peak_memory_stats()
        path, datasets, model_name = flagship.M4C_FAMILY["textvqa"]
        opts = (_evaluated(u) + flagship.M4C_FAMILY_OVERRIDES["textvqa"]
                + layout_opts(tmp) + ["scheduler.params.warmup_iterations=2"])
        trainer, recorder, launches, run_s = _cli_run(
            save, path, model_name, datasets, u, opts, batch_size=M4C_B)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cfg = trainer.config
        mc = cfg["model_config"]["m4c"]
        model = trainer.model
        check((mc["text_bert"]["num_hidden_layers"],
               mc["mmt"]["num_hidden_layers"], mc["mmt"]["hidden_size"],
               str(mc.get("dtype", "float32")),
               tuple(model.classifier_w.shape),
               registry.get("textvqa_num_final_outputs"),
               cfg["optimizer"]["type"], cfg["scheduler"]["type"]) == (
            3, 4, HIDDEN, "float32", (flagship.M4C_ANSWERS, HIDDEN),
            flagship.M4C_ANSWERS + flagship.M4C_OCR, "Adam", "multi_step"),
            f"m4c config {dict(mc)}")
        batch = recorder.batches[0]
        shapes = {k: tuple(batch[k].shape) for k in (
            "text", "image_feature_0", "image_feature_1",
            "context_feature_0", "context_feature_1", "order_vectors",
            "ocr_bbox_coordinates", "train_prev_inds", "targets")}
        check(shapes == {
            "text": (M4C_B, flagship.M4C_TEXT),
            "image_feature_0": (M4C_B, flagship.M4C_OBJECTS, VDIM),
            "image_feature_1": (M4C_B, flagship.M4C_OBJECTS, VDIM),
            "context_feature_0": (M4C_B, flagship.M4C_OCR, 300),
            "context_feature_1": (M4C_B, flagship.M4C_OCR, 604),
            "order_vectors": (M4C_B, flagship.M4C_OCR, flagship.M4C_OCR),
            "ocr_bbox_coordinates": (M4C_B, flagship.M4C_OCR, 4),
            "train_prev_inds": (M4C_B, steps),
            "targets": (M4C_B, steps,
                        flagship.M4C_ANSWERS + flagship.M4C_OCR)},
            f"m4c batch {shapes}")
        losses = list(trainer.meter.meters[
            "train/textvqa/m4c_decoding_bce_with_mask"].averaged_value_deque)
        check(len(losses) == u and all(math.isfinite(x) for x in losses),
              f"m4c losses {losses}")
        # the config's attention-probability dropout (0.1, TransformerConfig's
        # default: the YAML sets no rate) sends the training attention to
        # the plain version, as in JAX
        val_batches = -(-M4C_SPLITS["val"] // M4C_B)
        forwards = 2 * val_batches + -(-M4C_SPLITS["test"] // M4C_B)
        want = dict(ZERO_COUNTS,
                    flash_attention_fwd=M4C_EVAL_ATTENTION * forwards,
                    layer_norm=M4C_TRAIN_LN * u + M4C_EVAL_LN * forwards,
                    layer_norm_bwd=M4C_TRAIN_LN * u)
        check(launches == want, f"m4c launches {launches}, want {want}")

        save_dir = cfg["env"]["save_dir"]
        reports = {}
        for split in ("val", "test"):
            files = glob.glob(os.path.join(save_dir, "reports",
                                           f"textvqa_*_{split}_*.json"))
            check(len(files) == 1, f"m4c {split} reports {files}")
            with open(files[0]) as f:
                reports[split] = json.load(f)
            ids = sorted(int(r["question_id"]) for r in np.load(
                os.path.join(tmp, "datasets", "textvqa", "defaults",
                             "annotations", SPLITS[split]),
                allow_pickle=True)[1:])
            check(sorted(r["question_id"] for r in reports[split]) == ids
                  and all(set(r) == {"question_id", "image_id", "answer",
                                     "pred_source"}
                          for r in reports[split]),
                  f"m4c {split} rows {reports[split][:2]}")
        sources = [s for r in reports["test"] for s in r["pred_source"]]
        t1 = time.perf_counter()
        reset_counts()
        report, meter = trainer.evaluation_loop("val")
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t1
        check(read_counts() == dict(
            ZERO_COUNTS, flash_attention_fwd=M4C_EVAL_ATTENTION * val_batches,
            layer_norm=M4C_EVAL_LN * val_batches), "m4c eval launches")
        acc = meter.meters["val/textvqa/textvqa_accuracy"].global_avg
        val_loss = meter.meters[
            "val/textvqa/m4c_decoding_bce_with_mask"].global_avg
        check(report.batch_size == M4C_SPLITS["val"] and 0.0 <= acc <= 1.0
              and math.isfinite(val_loss),
              f"m4c val {report.batch_size}, accuracy {acc}, loss "
              f"{val_loss}")
        t = recorder.loss_read
        sps = M4C_B * (u - 2) / (t[u] - t[2])
        update_ms = 1e3 * (t[u] - t[2]) / (u - 2)
        meters = trainer.profile_meter.meters
        split = {k: 1e3 * meters[k].median for k in RUN_POINTS
                 if k in meters and meters[k].averaged_value_deque}
        # the loader alone: a fresh epoch's first batch (it waits while
        # the workers drain the batches they had prefetched for the epoch
        # before), then its next five; one batch's samples in this process
        batches = iter(trainer.train_loader)
        t1 = time.perf_counter()
        next(batches)
        first_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        for _ in range(5):
            next(batches)
        bps = 5 / (time.perf_counter() - t1)
        del batches
        dataset = trainer.dataset_loader.datamodules["textvqa"].train_dataset
        t1 = time.perf_counter()
        for i in range(M4C_B):
            dataset[i]
        batch_s = time.perf_counter() - t1
        imdb = np.load(os.path.join(tmp, "datasets", "textvqa", "defaults",
                                    "annotations", SPLITS["train"]),
                       allow_pickle=True)
        libs = _m4c_native_libraries(sorted({
            w for row in imdb[1:17] for w in row["ocr_tokens"]}))
        requests = _request_samples(trainer, "textvqa", SERVE_B)
        _prune_checkpoints(save)
        trainer.teardown()

        # the evaluation forward alone on a val batch: ms a batch (CUDA
        # events, best of 3) and device time by kind
        val_batch = train_state._to_device(
            next(iter(trainer.val_loader)).pytree(), DEV)
        val_batch.update(dataset_name="textvqa", dataset_type="val")
        trainer.teardown()
        model.eval()

        def decode():
            with torch.no_grad():
                return model(val_batch)["scores"]

        decode()
        events = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            decode()
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end))
        decode_ms = min(events)
        dec_dev_ms, dec_by_category = _device_ms(decode, PROFILED_STEPS)
        worst, mismatches, ties, own = _m4c_decode_against_full_passes(
            model, val_batch)
        check(worst <= M4C_DECODE_REL and mismatches == ties and own,
              f"m4c cached decode vs full passes: rel {worst}, "
              f"{mismatches} argmax mismatches ({ties} near-ties), the "
              f"model's own decode equal {own}")
        del val_batch

        # the train step alone on the run's first batch: device time by
        # kind, against the CLI's update time
        def build(c, o=None):
            return flagship.m4c_family_model(c, o)

        step_model = build(cfg)
        step_model.load_state_dict(recorder.initial, strict=True)
        state, step = flagship.textvqa_trainer(step_model, cfg, seed=1)
        box = [state]

        def one_step():
            box[0], rep = step(box[0], batch)
            float(rep["total_loss"])

        one_step()
        dev_ms, by_category = _device_ms(one_step, PROFILED_STEPS)
        del state, step, step_model, box
        torch.cuda.empty_cache()

        vs_plain, k_launches = _kernels_vs_plain(
            cfg, recorder.initial, batch,
            lambda c, o: flagship.m4c_family_model(c, M4C_NO_DROPOUT),
            flagship.textvqa_trainer, COMPARED_STEPS, "m4c")
        per_step = dict(ZERO_COUNTS,
                        flash_attention_fwd_stats=M4C_TRAIN_ATTENTION,
                        flash_attention_bwd_dq=M4C_TRAIN_ATTENTION,
                        flash_attention_bwd_dkv=M4C_TRAIN_ATTENTION,
                        layer_norm=M4C_TRAIN_LN,
                        layer_norm_bwd=M4C_TRAIN_LN)
        check(k_launches == {k: v * COMPARED_STEPS for k, v in
                             per_step.items()},
              f"m4c kernel side {k_launches}")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"phase m4c-run: ok mmf_run trains M4C on TextVQA with "
              f"{flagship.TEXTVQA_M4C_CONFIG} and "
              "flagship.TEXTVQA_M4C_OVERRIDES (TextBert 3 x 768 over "
              f"{flagship.M4C_TEXT} tokens, MMT 4 x 768 over {M4C_PREFIX} + "
              f"{steps} tokens, {flagship.M4C_ANSWERS} answers + "
              f"{flagship.M4C_OCR} OCR copies, f32, {n_params / 1e6:.1f}M "
              f"parameters; B={M4C_B}, {RUN_WORKERS} loader workers; the "
              f"synthetic layout: {M4C_SPLITS} questions over {M4C_IMAGES} "
              f"images, two LMDBs of [n, 2048] f32 features ({lmdb_mb:.0f} "
              "MB, written by the port's core), the seeded fasttext "
              f"stand-in, in {layout_s:.1f}s; warmup 1000 cut to 2): {u} "
              f"updates, losses {[round(x, 4) for x in losses]}; launches "
              f"{launches} (exact: {M4C_TRAIN_LN} K4 and K4-bwd an update, "
              "the training attention plain at TransformerConfig's dropout "
              f"0.1; {M4C_EVAL_ATTENTION} K1 and {M4C_EVAL_LN} K4 in each "
              f"of {forwards} greedy-decode forwards); val textvqa_accuracy "
              f"{acc:.4f}, loss {val_loss:.4f}; json reports of "
              f"{len(reports['val'])} val and {len(reports['test'])} test "
              f"answers ({sources.count('OCR')} OCR copies, "
              f"{sources.count('VOCAB')} vocabulary words in test); native "
              "libraries built from the checkout and loaded: "
              + ", ".join(sorted(libs)) + " (PHOC's C equal to its python "
              "twin)")
        print(f"  on '{card}': train {sps:.1f} samples/s over updates "
              f"3-{u} ({update_ms:.1f} ms an update); the loader alone "
              f"(a fresh epoch: its first batch after {first_s:.2f}s, while "
              "the workers drain the batches prefetched before, then 5) "
              f"{bps:.2f} batches/s ({M4C_B * bps:.0f} samples/s), one "
              f"batch's {M4C_B} samples (2 LMDB reads, fasttext, PHOC, "
              f"tokenizer, m4c_answer) in this process {batch_s:.2f}s; "
              "host split (ms, median of the run's updates): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in split.items())
              + f"; device time {dev_ms:.2f} ms a step (torch.profiler, 1 "
              f"step of the train step alone on the run's first batch): "
              f"idle {100 * max(0.0, 1 - dev_ms / update_ms):.1f}% of the "
              f"CLI's update; run {run_s:.1f}s; max_memory_allocated "
              f"{peak_gb:.2f} GB; evaluation of {M4C_SPLITS['val']} val "
              f"questions {M4C_SPLITS['val'] / eval_s:.1f} samples/s")
        print("  device time a step by kind of kernel (ms, launches): "
              + "; ".join(f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                          sorted(by_category.items(),
                                 key=lambda kv: -kv[1][0])))
        print(f"  greedy decode of a val batch (B={M4C_B}: TextBert, the "
              f"prefill, {steps} decode steps over the cached prefix K/V): "
              f"{decode_ms:.2f} ms a batch (CUDA events, best of 3), device "
              f"{dec_dev_ms:.2f} ms (torch.profiler, 1 forward; idle "
              f"{100 * max(0.0, 1 - dec_dev_ms / decode_ms):.1f}%); by kind "
              "(ms, launches): " + "; ".join(
                  f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                  sorted(dec_by_category.items(), key=lambda kv: -kv[1][0])))
        print(f"  the cached decode against {steps} full passes of "
              "MMT.forward, step by step on the same fed-back indices: "
              f"scores max rel {worst:.3g} (bound {M4C_DECODE_REL}), "
              f"{mismatches} argmax mismatches of {M4C_B * steps} "
              f"({ties} at near-ties), the model's own decode token for "
              "token equal to the full passes'")
        print("  kernels vs plain versions, the run's first batch and "
              f"initial weights at dropout 0: {vs_plain}")
        served = True
    finally:
        P.FastTextProcessor._load_fasttext_model = load_fasttext
        if trainer is not None:
            trainer.teardown()
        shutil.rmtree(tmp, ignore_errors=True)
        if not served:
            shutil.rmtree(save, ignore_errors=True)
    return {k: launches[k] + k_launches[k] for k in launches}, (save,
                                                                requests)


# the rest of the M4C family (phases 25-26): each config of
# flagship.M4C_FAMILY but TextVQA's (m4c-run) through mmf_run at full
# width, then mmf_serve on a TextVQA M4C and a captioner checkpoint
FAMILY_SPLITS = {"train": 256, "val": 128, "test": 128}
FAMILY_IMAGES = 48  # images hold up to 100 objects and 50 OCR tokens
FAMILY_UPDATES = {"textcaps": 5, "stvqa": 2, "ocrvqa": 2, "joint": 2,
                  "joint_coco": 3}
# the run whose update is timed (over updates 3-5, with
# the loader in RUN_WORKERS workers and one epoch of train samples, so
# that no epoch restarts the workers); the others read 5-10 batches, 0.4
# s each in this process, less than starting the workers of three loaders
TIMED_RUN = "textcaps"
FAMILY_METRICS = {"textcaps": ("textcaps_bleu4",),
                  "joint_coco": ("textcaps_bleu4",),
                  "stvqa": ("stvqa_anls", "stvqa_accuracy"),
                  "ocrvqa": ("ocrvqa_accuracy",),
                  "joint": ("textvqa_accuracy",)}
FAMILY_DATASETS = ("textvqa", "stvqa", "ocrvqa", "textcaps")
CAPTIONER_RUNS = ("textcaps", "joint_coco")
UNK = 3  # <unk>'s index in the layouts' answer vocabularies
# a single-dataset run's evaluation forwards: the evaluation at its end,
# then the val and test predictions, one batch each
FAMILY_FORWARDS = 3
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVED_DECODE_BUCKETS = (1, 8, 32)
SERVE_LATENCY_CALLS = 20  # p95 is then the largest
M4C_PER_FORWARD = dict(ZERO_COUNTS, flash_attention_fwd=M4C_EVAL_ATTENTION,
                       layer_norm=M4C_EVAL_LN)


class _EvalForwards:
    """Counts M4C's evaluation forwards (greedy decodes, the captioner's
    included) while the block runs."""

    def __enter__(self):
        from mmf_tpu_torch.models.m4c import M4C

        self.n, self._forward = 0, M4C.forward
        counter = self

        def forward(model, sample_list):
            counter.n += not model.training
            return counter._forward(model, sample_list)

        M4C.forward = forward
        return self

    def __exit__(self, *exc):
        from mmf_tpu_torch.models.m4c import M4C

        M4C.forward = self._forward


def _clear_family_state():
    """The registry's state of the M4C family's datasets (their
    processors and answer spaces, which a dataset of the same name reuses)
    and the registered config: what a fresh process holds."""
    from mmf_tpu_torch.common.registry import registry

    state = registry.mapping["state"]
    for key in [k for k in state if k == "config" or k.startswith(tuple(
            f"{d}_" for d in FAMILY_DATASETS))]:
        del state[key]


def _prune_checkpoints(save_dir):
    """A run's folder as mmf_serve needs it: config.yaml and the final
    ``.pth``; the ``.ckpt`` files (the optimizer state too) go."""
    import glob

    for f in glob.glob(os.path.join(save_dir, "**", "*.ckpt"),
                       recursive=True):
        os.remove(f)


def _request_samples(trainer, dataset_name, n):
    """The first ``n`` val samples of a run's dataset as serving requests:
    their array fields, the nested info dicts and the packed uint8
    ``context_tokens`` included (M4C's samples as JAX's engine stacks
    them)."""
    def arrays(tree):
        return {k: arrays(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in tree.items() if isinstance(v, dict)
                or isinstance(v, (np.ndarray, np.generic))}

    dataset = trainer.dataset_loader.datamodules[dataset_name].val_dataset
    return [arrays(dataset[i]) for i in range(n)]


def _family_run(key, root, card):
    """mmf_run of ``flagship.M4C_FAMILY[key]`` on the layouts under
    ``root``: (trainer, recorder, launches, its printed line)."""
    import glob

    from tests.torch_textvqa_layout import layout_opts

    path, datasets, model_name = flagship.M4C_FAMILY[key]
    names = datasets.split(",")
    u = FAMILY_UPDATES[key]
    workers = RUN_WORKERS if key == TIMED_RUN else 0
    # one checkpoint, the final one: a full-width checkpoint with its
    # optimizer state is ~1.1 GB
    opts = (_evaluated(u) + flagship.M4C_FAMILY_OVERRIDES[key]
            + [o for d in names for o in layout_opts(root, d)]
            + ["scheduler.params.warmup_iterations=2",
               "training.checkpoint_interval=1000",
               f"training.num_workers={workers}"])
    _clear_family_state()
    with _EvalForwards() as forwards:
        trainer, recorder, launches, run_s = _cli_run(
            os.path.join(root, f"save_{key}"), path, model_name, datasets,
            u, opts, batch_size=M4C_B)

    cfg = trainer.config
    mc = cfg["model_config"][model_name]
    model = trainer.model
    check((mc["text_bert"]["num_hidden_layers"],
           mc["mmt"]["num_hidden_layers"], mc["mmt"]["hidden_size"],
           str(mc.get("dtype", "float32")), tuple(model.classifier_w.shape),
           type(model).__name__) == (
        3, 4, HIDDEN, "float32", (flagship.M4C_ANSWERS, HIDDEN),
        "M4CCaptioner" if key in CAPTIONER_RUNS else "M4C"),
        f"{key} config {dict(mc)}")
    losses = {d: list(trainer.meter.meters[
        f"train/{d}/m4c_decoding_bce_with_mask"].averaged_value_deque)
        for d in names
        if f"train/{d}/m4c_decoding_bce_with_mask" in trainer.meter.meters}
    check(sum(map(len, losses.values())) == u and all(
        math.isfinite(x) for v in losses.values() for x in v),
        f"{key} losses {losses}")
    n = forwards.n
    want = dict(ZERO_COUNTS, flash_attention_fwd=M4C_EVAL_ATTENTION * n,
                layer_norm=M4C_TRAIN_LN * u + M4C_EVAL_LN * n,
                layer_norm_bwd=M4C_TRAIN_LN * u)
    check(launches == want and (n == FAMILY_FORWARDS or key == "joint"),
          f"{key} launches {launches} over {n} evaluation forwards, want "
          f"{want}")
    save_dir = cfg["env"]["save_dir"]
    rows = {}
    for d in names:
        for split in ("val", "test"):
            files = glob.glob(os.path.join(save_dir, "reports",
                                           f"{d}_*_{split}_*.json"))
            check(len(files) == 1, f"{key} {d} {split} reports {files}")
            with open(files[0]) as f:
                rows[d, split] = json.load(f)
    fields = ({"caption_id", "image_id", "caption", "pred_source"}
              if key in CAPTIONER_RUNS else
              {"question_id", "image_id", "answer", "pred_source"})
    # each dataset's file holds every dataset's rows (ROADMAP C.4)
    check(all(len(r) == len(names) * FAMILY_SPLITS[split]
              and all(set(x) == fields for x in r)
              for (_, split), r in rows.items()),
          f"{key} report rows {[(k, len(r)) for k, r in rows.items()]}")
    # the run's one validation (at its last update)
    check(len(recorder.val_meters) == 1, f"{key} validations "
          f"{len(recorder.val_meters)}")
    meter = recorder.val_meters[0]
    values = {k.split("/", 1)[1]: m.global_avg for k, m in
              meter.meters.items() if k.startswith("val/")
              and k.rsplit("/", 1)[1] in FAMILY_METRICS[key]}
    check(len(values) == len(FAMILY_METRICS[key])
          and all(0.0 <= v <= 1.0 for v in values.values()),
          f"{key} val metrics {values}")
    _prune_checkpoints(save_dir)
    # the update on the host clock: over updates 3-u where the run has
    # them (the first batches left out), else update 2
    t, first = recorder.loss_read, min(2, u - 1)
    update_ms = 1e3 * (t[u] - t[first]) / (u - first)
    meters = trainer.profile_meter.meters
    split = {k: 1e3 * meters[k].median for k in RUN_POINTS
             if k in meters and meters[k].averaged_value_deque}
    line = (f"  {key} ({path}, {datasets}, {type(model).__name__}): {u} "
            f"updates at B={M4C_B}, losses " + ", ".join(
                f"{d} {[round(x, 4) for x in v]}" for d, v in
                losses.items()) + f"; launches {launches} (exact: "
            f"{M4C_TRAIN_LN} K4 and K4-bwd an update, {M4C_EVAL_ATTENTION} "
            f"K1 and {M4C_EVAL_LN} K4 in each of {n} greedy-decode "
            "forwards); val " + ", ".join(f"{k} {v:.4f}" for k, v in
                                          values.items())
            + f"; {sum(len(r) for r in rows.values())} report rows; "
            f"{update_ms:.1f} ms an update over updates {first + 1}-{u} "
            f"(host clock, {workers} loader workers); run {run_s:.1f}s on "
            f"'{card}'")
    return trainer, recorder, launches, line, (update_ms, split)


def phase_m4c_family(card):
    """mmf_run at full width for the M4C captioner on TextCaps (the
    <unk> column at -1e10 in every decoded step, BLEU-4, caption
    predictions; its update's device time and the greedy decode's; 2
    steps through the kernels against the plain versions at dropout 0 on
    a batch with <unk> targets and one without), and for M4C on ST-VQA,
    OCR-VQA and TextVQA jointly with ST-VQA (ANLS and accuracies, answer
    predictions): (launches, (captioner folder, its requests), root)."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.datasets.processors import processors as P
    from mmf_tpu_torch.utils.native import build as native_build
    from tests.torch_textvqa_layout import FastTextStandIn, write_layout

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    root = tempfile.mkdtemp(prefix="chip_smoke_m4c_family_")
    load_fasttext = P.FastTextProcessor._load_fasttext_model

    def stand_in(self, model_file):  # wiki.en.bin's seeded stand-in
        self.model = FastTextStandIn()

    P.FastTextProcessor._load_fasttext_model = stand_in
    # BLEU-4's warning for an order without a match (a decode after 8
    # updates matches no 2-gram of the references), muted for the phase
    muted = contextlib.ExitStack()
    muted.enter_context(warnings.catch_warnings())
    warnings.filterwarnings("ignore", message="\nThe hypothesis contains 0 "
                            "counts of")
    total, lines, trainer, done = dict(ZERO_COUNTS), [], None, False
    try:
        t0 = time.perf_counter()
        for i, d in enumerate(FAMILY_DATASETS):
            write_layout(root, n_train=max(FAMILY_SPLITS["train"], M4C_B
                                           * FAMILY_UPDATES.get(d, 0)),
                         n_val=FAMILY_SPLITS["val"],
                         n_test=FAMILY_SPLITS["test"],
                         n_images=FAMILY_IMAGES,
                         num_answers=flagship.M4C_ANSWERS, vocab_size=VOCAB,
                         seed=10 + i, dataset=d)
        layout_s = time.perf_counter() - t0

        # the captioner on TextCaps
        trainer, recorder, launches, line, (update_ms, split) = \
            _family_run("textcaps", root, card)
        lines.append(line)
        total = {k: total[k] + launches[k] for k in total}
        cfg = trainer.config
        model = trainer.model
        requests = _request_samples(trainer, "textcaps", SERVE_B)
        val_batch = train_state._to_device(
            next(iter(trainer.val_loader)).pytree(), DEV)
        val_batch.update(dataset_name="textcaps", dataset_type="val")
        trainer.teardown()
        model.eval()

        def decode():
            with torch.no_grad():
                return model(val_batch)["scores"]

        scores = decode()
        check(bool((scores[..., UNK] == -1e10).all())
              and not bool((scores.argmax(-1) == UNK).any()),
              "the captioner's <unk> column is not -1e10 in every step")

        decode_ms = time_ms(decode, iters=1, repeats=3)
        dec_dev_ms, _ = _device_ms(decode, PROFILED_STEPS)
        del val_batch
        batch = recorder.batches[0]
        check(float(batch["train_loss_mask"].sum()) > 0,
              "no TextCaps caption of the first batch was spelled")

        def build(c, o=None):
            return flagship.m4c_family_model(c, M4C_NO_DROPOUT)

        step_model = flagship.m4c_family_model(cfg)
        step_model.load_state_dict(recorder.initial, strict=True)
        state, step = flagship.textvqa_trainer(step_model, cfg, seed=1)
        box = [state]

        def one_step():
            box[0], rep = step(box[0], batch)
            float(rep["total_loss"])

        one_step()
        dev_ms, by_category = _device_ms(one_step, PROFILED_STEPS)
        del state, step, step_model, box
        # <unk> targets: the masked -1e10 logit adds 1e10 a target to the
        # BCE sum on both sides; the batch without them keeps the bound
        # meaningful
        with_unk = dict(batch, targets=batch["targets"].clone())
        mask = batch["train_loss_mask"].bool()
        with_unk["targets"][..., UNK] = mask.float()
        no_unk = dict(batch, targets=batch["targets"].clone())
        no_unk["targets"][..., UNK] = 0.0
        compared = []
        for label, b in (("no <unk> target", no_unk),
                         ("<unk> targets", with_unk)):
            text, k_launches = _kernels_vs_plain(
                cfg, recorder.initial, b, build, flagship.textvqa_trainer,
                2, f"captioner ({label})")
            check(k_launches == {k: v * 2 for k, v in dict(
                ZERO_COUNTS, flash_attention_fwd_stats=M4C_TRAIN_ATTENTION,
                flash_attention_bwd_dq=M4C_TRAIN_ATTENTION,
                flash_attention_bwd_dkv=M4C_TRAIN_ATTENTION,
                layer_norm=M4C_TRAIN_LN, layer_norm_bwd=M4C_TRAIN_LN).items()},
                f"captioner kernel side {k_launches}")
            total = {k: total[k] + k_launches[k] for k in total}
            compared.append(f"{label}: {text}")
        del model, with_unk, no_unk, batch
        torch.cuda.empty_cache()
        captioner = (cfg["env"]["save_dir"], requests)

        for key in ("stvqa", "ocrvqa", "joint"):
            trainer, _, launches, line, _ = _family_run(key, root, card)
            lines.append(line)
            total = {k: total[k] + launches[k] for k in total}
            trainer.teardown()
            del trainer
            trainer = None
            torch.cuda.empty_cache()
        libs = native_build.loaded()
        here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "mmf_tpu_torch", "native")
        check(any(n.startswith("libeditdist-") and p.startswith(here)
                  for n, p in libs.items()),
              f"the edit-distance library was not built from the checkout: "
              f"{libs}")
        print(f"phase m4c-family: ok mmf_run at full width (TextBert 3 x "
              f"768, MMT 4 x 768, {flagship.M4C_ANSWERS} answers + "
              f"{flagship.M4C_OCR} OCR copies, f32) on synthetic layouts "
              f"(tests/torch_textvqa_layout.py: {FAMILY_SPLITS} over "
              f"{FAMILY_IMAGES} images a dataset, two LMDBs each, written in "
              f"{layout_s:.1f}s), each config with its flagship."
              "M4C_FAMILY_OVERRIDES; the edit-distance library built from "
              "the checkout and loaded:")
        for line in lines:
            print(line)
        print(f"  the captioner: <unk> at -1e10 in every decoded step; its "
              f"update {update_ms:.1f} ms (host clock, updates 3-"
              f"{FAMILY_UPDATES[TIMED_RUN]}, {RUN_WORKERS} loader workers; "
              "host split, ms, median of the run's updates: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in split.items())
              + f"), device {dev_ms:.2f} ms a step (torch.profiler, the "
              "train step alone on the run's first batch, 1 step; idle "
              f"{100 * max(0.0, 1 - dev_ms / update_ms):.1f}% of the "
              "update), by kind "
              "(ms, launches): " + "; ".join(
                  f"{cat} {ms:.2f} x{cnt:.0f}" for cat, (ms, cnt) in
                  sorted(by_category.items(), key=lambda kv: -kv[1][0]))
              + f"; greedy decode of a val batch (B={M4C_B}) {decode_ms:.2f}"
              f" ms (CUDA events, best of 3), device {dec_dev_ms:.2f} ms "
              f"(idle {100 * max(0.0, 1 - dec_dev_ms / decode_ms):.1f}%)")
        for text in compared:
            print(f"  the captioner, kernels vs plain versions, the run's "
                  f"first batch with {text}")
        done = True
    finally:
        muted.close()
        P.FastTextProcessor._load_fasttext_model = load_fasttext
        if trainer is not None:
            trainer.teardown()
        if not done:
            shutil.rmtree(root, ignore_errors=True)
    return total, captioner, root


def _served_decode_cases(g):
    """K1's inference form at a served M4C decode step, buckets 1, 8 and
    32 ([b, 12, 12 rows, 182 keys], bias [b, 1, 12, 182]): against the
    plain version, device ms beside SDPA's and the plain version's, host
    us a call, the bound."""
    rows = {}
    for b in SERVED_DECODE_BUCKETS:
        q, k, v, bias, _ = _m4c_attention_inputs("decode", g, b=b)
        out = A.flash_attention(q, k, v, bias)
        torch.cuda.synchronize()
        err = max_err(out, A.mha_reference(q, k, v, bias), torch.float32)
        heads, sq, skv, d = q.shape[1:3] + k.shape[2:]
        nb = 2 * _nbytes(q) + 2 * _nbytes(k) + _nbytes(bias)
        ops = 4 * b * heads * sq * skv * d
        bound_ms, bound_by = max(
            (1e3 * nb / HBM_BYTES_PER_S, "bytes"),
            (1e3 * SPLIT_TF32_PRODUCTS * ops / TF32_FLOPS, "operations"))
        rows[f"bucket {b}"] = {
            "shape": [b, heads, sq, skv, d], "dtype": "float32",
            "max_abs_err": err,
            "ms": device_ms(lambda: A.flash_attention(q, k, v, bias),
                            iters=50),
            "plain_ms": time_ms(lambda: A.mha_reference(q, k, v, bias),
                                iters=20),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias), iters=50),
            "host_us": host_us(lambda: A.flash_attention(q, k, v, bias)),
            "bound_ms": bound_ms, "bound_by": bound_by}
        check(err <= TOL[torch.float32]["atol"] + TOL[torch.float32]["rtol"]
              * float(out.abs().max()), f"served decode K1 at bucket {b}: "
              f"{err}")
        del q, k, v, bias, out
    return rows


def _served_vs_cpu(got, want):
    """A greedy decode's scores [steps, V] against the CPU's: the
    largest difference over the steps up to the first where the argmax
    differs, relative to the largest |score|, and whether that step's
    top-2 margin in the CPU's scores lies within 10x the difference (a
    near-tie, after which the fed-back tokens differ)."""
    tg, tw = got.argmax(-1), want.argmax(-1)
    differ = np.nonzero(tg != tw)[0]
    last = int(differ[0]) + 1 if len(differ) else len(tg)
    diff = np.abs(got[:last] - want[:last])
    rel = float(diff.max()) / float(np.abs(want[:last]).max())
    tie = True
    if len(differ):
        top2 = np.sort(want[last - 1])[-2:]
        tie = float(top2[1] - top2[0]) <= 10 * float(diff[-1].max())
    return rel, bool(len(differ)), tie


class _DecodeSplit:
    """K1 launches (inference form) inside M4C's prefill and inside its
    cached decode steps while the block runs, read from the wrapper's
    count before and after each call; the rest are TextBert's."""

    def __enter__(self):
        from mmf_tpu_torch.models.m4c import MMT

        self.prefill = self.decode = 0
        self._methods = MMT.prefill, MMT.decode_step
        split = self

        def counted(method, field):
            def call(mmt, *args, **kwargs):
                before = A.flash_attention.launches
                out = method(mmt, *args, **kwargs)
                setattr(split, field, getattr(split, field)
                        + A.flash_attention.launches - before)
                return out
            return call

        MMT.prefill = counted(MMT.prefill, "prefill")
        MMT.decode_step = counted(MMT.decode_step, "decode")
        return self

    def __exit__(self, *exc):
        from mmf_tpu_torch.models.m4c import MMT

        MMT.prefill, MMT.decode_step = self._methods


def phase_m4c_serve(card, folders):
    """mmf_serve (cli/serve.py build_server, port 0) on m4c-run's TextVQA
    M4C folder and m4c-family's captioner folder, as a fresh process
    holds them (no dataset in the registry): the dataset's samples at
    buckets 1-32 through the served engine's predict_many (JAX's HTTP
    path cannot take M4C's nested fields, ROADMAP C.4), exact launches a
    batch, the answers against a CPU engine on the same checkpoint, the
    per-bucket decode ms beside its device time, batch-1 p50 / p95; the
    served-decode K1 instances against their plain versions."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity
    try:
        return _m4c_serve(card, folders)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _m4c_serve(card, folders):
    from mmf_tpu_torch.cli import serve as serve_cli

    g = torch.Generator(device=DEV).manual_seed(16)
    decode_rows = _served_decode_cases(g)
    total, lines, decode_launches = dict(ZERO_COUNTS), [], {}
    for key, (folder, samples) in folders.items():
        _clear_family_state()
        cpu = ServingEngine.from_checkpoint(folder, device="cpu",
                                            max_batch_size=SERVE_B)
        # the CPU engine's answers, each sample's compared with the
        # served one at every bucket it lies in
        wants = [w["scores"] for w in cpu.predict_many(samples)]
        del cpu
        _clear_family_state()
        t0 = time.perf_counter()
        server = serve_cli.build_server(serve_cli.parse_opts(
            [f"checkpoint={folder}", "port=0",
             f"max_batch_size={SERVE_B}"])).start()
        try:
            engine = server.engine
            check(engine.buckets == SERVE_BUCKETS, f"{engine.buckets}")
            engine.predict(samples[0])
            first_s = time.perf_counter() - t0
            worst, flips, ties, ms, dev = 0.0, 0, 0, {}, {}
            for b in SERVE_BUCKETS:
                chunk = samples[:b]
                engine.predict_many(chunk)  # the bucket's first batch
                reset_counts()  # the main path, counted from zero
                with _DecodeSplit() as split:
                    outs = engine.predict_many(chunk)
                torch.cuda.synchronize()
                launches = read_counts()
                check(launches == M4C_PER_FORWARD, f"{key} served launches "
                      f"{launches} at bucket {b}, want {M4C_PER_FORWARD}")
                # MMT's 4 layers in the prefill and in each of the 12
                # cached decode steps; the rest, TextBert's 3
                text_k1 = (launches["flash_attention_fwd"] - split.prefill
                           - split.decode)
                check((text_k1, split.prefill, split.decode) == (
                    3, 4, 4 * flagship.M4C_STEPS), f"{key} K1 at bucket "
                    f"{b}: {text_k1} in TextBert, {split.prefill} in the "
                    f"prefill, {split.decode} in the decode steps")
                decode_launches.setdefault(b, set()).add(split.decode)
                total = {k: total[k] + launches[k] for k in total}
                for o, want in zip(outs, wants):
                    got = o["scores"]
                    check(got.shape == (flagship.M4C_STEPS,
                                        flagship.M4C_ANSWERS
                                        + flagship.M4C_OCR)
                          and np.isfinite(got).all() and set(o) ==
                          {"scores"}, f"{key} served answer {got.shape}")
                    rel, flip, tie = _served_vs_cpu(got, want)
                    worst, flips, ties = max(worst, rel), flips + flip, \
                        ties + (flip and tie)
                    check(not (key == "textcaps" and (got[:, UNK] <= -1e9)
                               .all()), "a served captioner masked <unk>")
                best = float("inf")
                for _ in range(3):
                    t1 = time.perf_counter()
                    engine.predict_many(chunk)
                    best = min(best, 1e3 * (time.perf_counter() - t1))
                ms[b] = best
                dev[b] = _device_ms(lambda: engine.predict_many(chunk), 1)[0]
            check(worst <= SERVE_F32_REL and flips == ties,
                  f"{key} served vs CPU engine: rel {worst}, {flips} "
                  f"argmax flips ({ties} at near-ties)")
            lat = []
            for i in range(SERVE_LATENCY_CALLS):
                t1 = time.perf_counter()
                engine.predict(samples[i % len(samples)])
                lat.append(1e3 * (time.perf_counter() - t1))
        finally:
            server.shutdown()
        p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
        lines.append(
            f"  {key} ({folder}): buckets {list(SERVE_BUCKETS)}, launches "
            f"exact a batch ({M4C_EVAL_ATTENTION} K1: {text_k1} in TextBert, "
            f"{split.prefill} in the prefill, {split.decode} in the "
            f"{flagship.M4C_STEPS} decode steps, counted in each; "
            f"{M4C_EVAL_LN} K4); vs a CPU engine on the checkpoint: max rel "
            f"{worst:.3g} of the largest score (bound {SERVE_F32_REL}; "
            f"{flips} argmax flips, {ties} at near-ties, compared up to the "
            f"flip); build_server to the first answer {first_s:.2f}s; "
            "predict_many ms a batch (host clock, best of 3) / device ms "
            "(torch.profiler): " + ", ".join(
                f"{b}: {ms[b]:.2f} / {dev[b]:.2f}" for b in SERVE_BUCKETS)
            + f"; batch 1 over {SERVE_LATENCY_CALLS} calls p50 {p50:.2f} "
            f"ms, p95 {p95:.2f} ms (device {dev[1]:.2f} ms, idle "
            f"{100 * max(0.0, 1 - dev[1] / p50):.1f}%)")
    for b, row in decode_rows.items():
        # the decode steps' K1 launches a served batch at this bucket, as
        # counted above (one number: both checkpoints gave it)
        (row["launches_per_served_batch"],) = decode_launches[
            int(b.split()[1])]
    print(f"phase m4c-serve: ok mmf_serve on the TextVQA M4C and the "
          "captioner checkpoints written by mmf_run (a served captioner "
          "masks no <unk>: no answer processor outside a run, in JAX too), "
          f"the datasets' val samples through predict_many on '{card}':")
    for line in lines:
        print(line)
    print("  served-decode K1 (f32, [b, 12, 12, 182], bias [b, 1, 12, 182]"
          "): " + "; ".join(
              f"{name} max_abs_err {r['max_abs_err']:.3g}, {r['ms']:.4f} ms "
              f"(bound {r['bound_ms']:.4f} {r['bound_by']}), sdpa "
              f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}, host us "
              f"{r['host_us']:.1f}, {r['launches_per_served_batch']} "
              "launches a served batch" for name, r in decode_rows.items()))
    return total, decode_rows


# -- phases 27-28: UNITER, LXMERT and VinVL -----------------------------------
VINVL_SEQ = flagship.VL3_SEQ["vinvl_vqa2"]  # 70 caption and tag tokens
LX_TEXT = flagship.VL3_SEQ["lxmert_pretrain"]  # masked VQA2's 20 tokens
LX_REGIONS = flagship.VL3_REGIONS["lxmert_pretrain"]  # and 36 regions
# their f32 attention calls at B=TRAIN_B (12 heads of 64): label -> (Sq,
# Skv). UNITER over 128 + 100 tokens, VinVL over 70 + 100; LXMERT's
# relational self-attention over the regions and its cross layer both ways
# (its text self-attention's 128 is the Hateful Memes baselines' shape),
# and the same at its pretraining's 20 tokens and 36 regions
VL3_ATTENTION_SHAPES = {
    "uniter": (S, S),
    "vinvl": (VINVL_SEQ + REGIONS, VINVL_SEQ + REGIONS),
    "lxmert regions": (REGIONS, REGIONS),
    "lxmert text-regions": (SEQ, REGIONS),
    "lxmert regions-text": (REGIONS, SEQ),
    "lxmert pretrain text-regions": (LX_TEXT, LX_REGIONS),
    "lxmert pretrain regions-text": (LX_REGIONS, LX_TEXT),
}
# their trunks' f32 residual LayerNorms at B=TRAIN_B: label -> rows
VL3_LN_ROWS = {"uniter": TRAIN_B * S,
               "vinvl": TRAIN_B * (VINVL_SEQ + REGIONS),
               "lxmert text": TRAIN_B * SEQ,
               "lxmert pretrain regions": TRAIN_B * LX_REGIONS}
# launches a forward. UNITER: 12 attention calls; the text embeddings'
# LayerNorm, the image embeddings' three (features, boxes, their sum), two
# a layer, and the VQA2 mlp head's: 29; a pretraining task runs the trunk
# (28) and its head (the mlm, mrc and mrfr transforms' 1, itm's 0)
UNITER_ATTENTION, UNITER_LN = 12, 1 + 3 + 2 * 12 + 1
UNITER_TASK_LN = {"mlm": 29, "itm": 28, "mrc": 29, "mrfr": 29}
# LXMERT: 9 language and 5 relational layers, and 5 cross layers of two
# cross-attention calls (one module, both ways) and two self-attention
# calls: 34; the embeddings', the region encoder's two, two a language or
# relational layer, six a cross layer: 61, and the classifier's transform
# (62), or the masked LM's and the feature regression's transforms (63)
LXMERT_ATTENTION = 9 + 5 + 5 * 4
LXMERT_TRUNK_LN = 1 + 2 + 2 * 9 + 2 * 5 + 5 * 6
LXMERT_LN, LXMERT_PRETRAIN_LN = LXMERT_TRUNK_LN + 1, LXMERT_TRUNK_LN + 2
# the classifier reads the text stream alone: the last cross layer's
# region outputs (its region-queries cross call and LayerNorm, the region
# self-attention and its LayerNorm, the feed-forward's LayerNorm) reach no
# loss, and autograd runs no backward there: 2 attention calls and 3
# LayerNorms fewer a step
LXMERT_BWD_ATTENTION, LXMERT_BWD_LN = LXMERT_ATTENTION - 2, LXMERT_LN - 3
# VinVL: 12 attention calls; the embeddings', the regions', two a layer
VINVL_ATTENTION, VINVL_LN = 12, 1 + 1 + 2 * 12
VL3_PER_FORWARD = {  # key -> (attention calls, LayerNorms) a forward,
    # and (attention backwards, LayerNorm backwards) a step
    "uniter_vqa2": (UNITER_ATTENTION, UNITER_LN, UNITER_ATTENTION,
                    UNITER_LN),
    "lxmert_vqa2": (LXMERT_ATTENTION, LXMERT_LN, LXMERT_BWD_ATTENTION,
                    LXMERT_BWD_LN),
    "lxmert_pretrain": (LXMERT_ATTENTION, LXMERT_PRETRAIN_LN,
                        LXMERT_ATTENTION, LXMERT_PRETRAIN_LN),
    "vinvl_vqa2": (VINVL_ATTENTION, VINVL_LN, VINVL_ATTENTION, VINVL_LN),
}
# the layout's questions: a batch each for val and test, three for train
VL3_SPLITS = {"train": 3 * RUN_B, "val": RUN_B, "test": RUN_B}
VL3_UPDATES = {"uniter_vqa2": 3, "uniter_masked_coco": 4, "lxmert_vqa2": 3,
               "lxmert_pretrain": 2, "vinvl_vqa2": 3}
# UNITER's masked-COCO run at training.seed 4: Python's random, seeded
# with it, draws itm, mrc, mlm, mrfr for the first four updates (the
# loader's workers draw the masks in their own processes)
VL3_TASK_SEED = 4
# the configs of the compared steps: UNITER's trunk through its VQA2
# config, LXMERT's through both
VL3_COMPARED = ("uniter_vqa2", "lxmert_vqa2", "lxmert_pretrain",
                "vinvl_vqa2")


def _vl3_layer_norm_case(g, rows):
    """K4 and K4-bwd in f32 with the residual at ``rows`` x 768 (a
    trunk's LayerNorms at B=TRAIN_B): against their plain versions, by
    device_ms over rotating input sets beside F.layer_norm's forward and
    backward, with host time and the bound."""
    dt = torch.float32
    row_bytes = rows * HIDDEN * 4
    n_sets = max(3, math.ceil(ROTATE_BYTES / (2 * row_bytes)))
    pool = [torch.randn(1, n_sets * rows, HIDDEN, device=DEV, generator=g)
            for _ in range(3)]
    w = 1.0 + 0.1 * torch.randn(HIDDEN, device=DEV, generator=g)
    bb = 0.1 * torch.randn(HIDDEN, device=DEV, generator=g)
    sets = _ln_sets(pool, rows, 2 * row_bytes)
    x, res, dy = sets[0]
    out = L.layer_norm_kernel(x, w, bb, res)
    got = L.layer_norm_backward_kernel(x, w, dy, res)
    torch.cuda.synchronize()
    f_err = max_err(out, L._ln_reference(x, res, w, bb, 1e-12), dt)
    want = L._ln_backward_reference(x, res, w, bb, dy, 1e-12)
    b_err = max(rel_err(a, b_, rel, f"K4-bwd vl3 {rows} {n}")
                for n, a, b_, rel in zip(
                    ("dx", "dscale", "dbias"), got,
                    (want[0], want[2], want[3]),
                    (LN_DX_REL[dt], LN_PARAM_REL, LN_PARAM_REL)))
    lib = [_ln_library_backward(x_, r_, w, bb, dy_) for x_, r_, dy_ in sets]
    fwd = {"ms": device_ms(rotating(
        lambda x_, r_, _: L.layer_norm_kernel(x_, w, bb, r_), sets)),
        "library_ms": device_ms(rotating(
            lambda x_, r_, _: F.layer_norm(x_ + r_, (HIDDEN,), w, bb, 1e-12),
            sets)),
        "plain_ms": device_ms(rotating(
            lambda x_, r_, _: L._ln_reference(x_, r_, w, bb, 1e-12), sets),
            iters=5),
        "host_us": host_us(lambda: L.layer_norm_kernel(x, w, bb, res)),
        "max_abs_err": f_err}
    fwd["bound_ms"], fwd["bound_by"] = bound(_nbytes(x, res, w, bb, out),
                                             8 * x.numel(), dt)
    bwd = {"ms": device_ms(rotating(
        lambda x_, r_, dy_: L.layer_norm_backward_kernel(x_, w, dy_, r_),
        sets)),
        "library_ms": device_ms(rotating(lambda f_: f_(),
                                         [(f_,) for f_ in lib])),
        "plain_ms": device_ms(rotating(
            lambda x_, r_, dy_: L._ln_backward_reference(x_, r_, w, bb, dy_,
                                                         1e-12), sets),
            iters=5),
        "host_us": host_us(lambda: L.layer_norm_backward_kernel(x, w, dy,
                                                                res)),
        "max_abs_err": b_err}
    bwd["bound_ms"], bwd["bound_by"] = bound(
        _nbytes(x, res, w, dy, got[0], got[1], got[2]), 10 * x.numel(), dt)
    del lib, pool, sets
    torch.cuda.empty_cache()
    return {"rows": rows, "sets": n_sets, "K4": fwd, "K4-bwd": bwd}


def phase_vl3_kernels(card):
    """K1 (its three forms), K2 and K3 in f32 at UNITER's, VinVL's and
    LXMERT's attention shapes, and K4 and K4-bwd in f32 at their trunks'
    LayerNorm rows, against their plain versions, timed beside SDPA and
    F.layer_norm with the bounds and host time."""
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity
    g = torch.Generator(device=DEV).manual_seed(17)
    rows, raws = {}, {}
    for label, (sq, skv) in VL3_ATTENTION_SHAPES.items():
        q, k, v, bias, dout = _attention_inputs(TRAIN_B, sq, skv,
                                                torch.float32, g)
        rows[label] = _attention_case(f"vl3 {label}", q, k, v, bias, dout,
                                      iters=10, plain_iters=5, repeats=3)
        raws[label] = _raw_case(q, k, v, bias, f"vl3 {label}", iters=10,
                                plain_iters=3)
        del q, k, v, bias, dout
        torch.cuda.empty_cache()
    ln = {label: _vl3_layer_norm_case(g, n)
          for label, n in VL3_LN_ROWS.items()}
    print(f"phase vl3-kernels: ok K1, K1-stats, K1-raw, K2 and K3 in f32 at "
          f"UNITER's, VinVL's and LXMERT's shapes (B={TRAIN_B}, 12 heads of "
          "64, a padding mask over the keys), K4 and K4-bwd in f32 with the "
          "residual at their trunks' rows, against their plain versions "
          "within the kernels phase's bounds; device ms (spin-queued; the "
          "LayerNorms over rotating input sets), SDPA's or F.layer_norm's, "
          "the plain versions', host us a call and the bound (split-TF32 "
          f"operations or bytes, the FP32 FMA bound beside it) on '{card}':")
    for label, r in rows.items():
        ms, lib, raw, fma = r["ms"], r["library_ms"], raws[label], \
            r["fma_bound_ms"]
        print(f"  {label} {r['shape']}: max_abs_err " + ", ".join(
            f"{n} {e:.3g}" for n, e in r["max_abs_err"].items())
            + f", K1-raw {raw['max_abs_err']:.3g}; " + ", ".join(
                f"{n} {ms[n]:.4f} (bound {r['bound_ms'][n]:.4f} "
                f"{r['bound_by'][n]}, FMA {fma[n]:.4f})" for n in ms)
            + f", K1-raw {raw['ms']:.4f} (bound {raw['bound_ms']:.4f}); sdpa"
            f" fwd {lib['K1']:.4f}, fwd+lse {lib['K1-stats']:.4f}, bwd "
            f"{lib['K2+K3']:.4f} (K2+K3 {ms['K2'] + ms['K3']:.4f}); plain "
            + ", ".join(f"{n} {t:.4f}" for n, t in r["plain_ms"].items())
            + "; host us " + ", ".join(f"{n} {u:.1f}" for n, u in
                                       r["host_us"].items()))
    for label, r in ln.items():
        print(f"  LayerNorm {label} f32 [{r['rows']}, {HIDDEN}] residual "
              f"({r['sets']} rotating sets): " + "; ".join(
                  f"{n} max_abs_err {c['max_abs_err']:.3g}, {c['ms']:.4f} "
                  f"(F.layer_norm {c['library_ms']:.4f}, plain "
                  f"{c['plain_ms']:.4f}, bound {c['bound_ms']:.4f} "
                  f"{c['bound_by']}), host us {c['host_us']:.1f}"
                  for n, c in ((n, r[n]) for n in ("K4", "K4-bwd"))))
    return rows, raws, ln


def _vl3_build(cfg, overrides=None):
    """The config's model at dropout 0 (the compared steps)."""
    return _without_dropout(flagship.vl3_model(cfg, overrides))


def _vl3_compared(key, card):
    """3 steps through the kernels against 3 through the plain versions
    at dropout 0 from seeded weights on a batch of the config's widths
    (B=TRAIN_B): the training phase's bounds; exact launches."""
    cfg = flagship.vl3_config(key, ["scheduler.params.num_warmup_steps=2"])
    model = flagship.vl3_model(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = flagship.vl3_batch(key, TRAIN_B, seed=7)
    device = []
    line, launches = _kernels_vs_plain(cfg, init, batch, _vl3_build,
                                       flagship.vl3_trainer, COMPARED_STEPS,
                                       key, device_out=device)
    dev_ms, by_category = device[0]
    ln_ms, ln_n = by_category.get("LayerNorm backward K4-bwd", (0.0, 0.0))
    line += (f"; the kernels' steps' device time {dev_ms:.2f} ms a step "
             f"(torch.profiler over the {COMPARED_STEPS} steps), of it "
             f"LayerNorm backward K4-bwd {ln_ms:.3f} ms x{ln_n:.0f}")
    att, ln, att_bwd, ln_bwd = VL3_PER_FORWARD[key]
    want = dict(ZERO_COUNTS, flash_attention_fwd_stats=att * COMPARED_STEPS,
                flash_attention_bwd_dq=att_bwd * COMPARED_STEPS,
                flash_attention_bwd_dkv=att_bwd * COMPARED_STEPS,
                layer_norm=ln * COMPARED_STEPS,
                layer_norm_bwd=ln_bwd * COMPARED_STEPS)
    check(launches == want, f"{key} compared launches {launches}, want "
          f"{want}")
    return f"  {key} compared steps: {line}", launches


def _vl3_opts(key, root):
    """A ``VL3`` run's options on the layout at ``root``: its overrides,
    the layout's paths and vocabulary, no epoch limit (LXMERT's project
    defaults set 20 epochs)."""
    from tests.torch_vqa2_layout import layout_opts

    _, dataset, _ = flagship.VL3[key]
    vocab = os.path.join(root, "vocab.txt")
    opts = [*flagship.VL3_OVERRIDES[key], "training.max_epochs=null"]
    if key == "uniter_masked_coco":
        return opts + [
            "run_type=train", f"training.seed={VL3_TASK_SEED}",
            *layout_opts(root, dataset, "masked_token_processor")]
    if key == "lxmert_pretrain":
        return opts + [
            "run_type=train",
            *layout_opts(root, dataset, "masked_token_processor",
                         train_files=2),
            f"dataset_config.{dataset}.processors.text_processor.params."
            f"tokenizer_config.params.vocab_file={vocab}"]
    # no validation inside the run: its early stopping would write the
    # best and current checkpoints, 1.3-2.4 GB each with the optimizer
    # state (f32), and read the best back; the run predicts val and test
    # and writes the final weights, and the trainer then evaluates val.
    # The loader in the main process (the pretraining runs keep their
    # workers: the workers draw the masks and tasks)
    opts += ["run_type=train_val_inference", "evaluation.predict=true",
             "training.evaluation_interval=1000",
             "training.checkpoint_interval=1000", *LOADER_IN_PROCESS,
             *layout_opts(root, "vqa2")]
    if key == "vinvl_vqa2":
        opts.append("dataset_config.vinvl.processors.text_processor.params."
                    f"tokenizer_config.params.vocab_file={vocab}")
    return opts


def _vl3_run(key, root, card):
    """``mmf_run`` of a ``VL3`` config at full width (B=RUN_B): exact
    launches (training attention takes the plain path at
    the configs' attention dropout 0.1, as in JAX; K4 and K4-bwd an
    update; K1 and K4 a prediction forward), its losses against the
    train step alone on the batches it took, and, for the finetuning
    configs, the final weights, the reports and the run's trainer's val
    vqa_accuracy. (line, launches, trainer)."""
    import glob

    from mmf_tpu_torch.common.registry import registry

    path, dataset, model = flagship.VL3[key]
    state = registry.mapping["state"]
    for name in [k for k in state if k.startswith(("vqa2_", "vinvl_"))]:
        del state[name]
    u = VL3_UPDATES[key]
    trainer, recorder, launches, run_s = _cli_run(
        os.path.join(root, f"save_{key}"), path, model, dataset, u,
        _vl3_opts(key, root))
    mc = trainer.config["model_config"][model]
    check(mc.get("hidden_size", 768) == HIDDEN and mc.get("dtype", "float32")
          == "float32", f"{key} config {dict(mc)}")
    losses = [k for k in trainer.meter.meters if k.startswith("train/")
              and k != "train/total_loss"]
    tasks = [b.get("task") for b in recorder.batches]
    if key == "uniter_masked_coco":
        check(set(tasks) == set(flagship.UNITER_PRETRAIN_TASKS),
              f"UNITER's drawn tasks {tasks}")
        ln = sum(UNITER_TASK_LN[t] for t in tasks)
        want = dict(ZERO_COUNTS, layer_norm=ln, layer_norm_bwd=ln)
        # an update's loss is its task's: the run's total is compared
        keys = ["train/total_loss"]
    else:
        att, per, _, per_bwd = VL3_PER_FORWARD[key]
        forwards = 0
        if key != "lxmert_pretrain":  # the val and test predictions
            forwards = -(-VL3_SPLITS["val"] // RUN_B) + -(
                -VL3_SPLITS["test"] // RUN_B)
        want = dict(ZERO_COUNTS, flash_attention_fwd=att * forwards,
                    layer_norm=per * (u + forwards),
                    layer_norm_bwd=per_bwd * u)
        keys = losses
    check(launches == want, f"{key} mmf-run launches {launches}, want "
          f"{want}")
    rel, got = _steps_again(trainer, recorder, flagship.vl3_model,
                            flagship.vl3_trainer, keys)
    # the last update, loss read to loss read (host clock): the loader,
    # the step and the loss's copy
    t = recorder.loss_read
    line = (f"  {key}: mmf_run of {path} with flagship.VL3_OVERRIDES, B="
            f"{RUN_B}, {trainer.config['training']['num_workers']} loader "
            f"workers: {u} updates, "
            + ", ".join(f"{k} {[round(x, 6) for x in got[k]]}" for k in keys)
            + f" equal to the train step's on the same batches (max rel "
            f"{rel:.3g}, bound {RUN_LOSS_RTOL}); launches {launches} "
            f"(exact); run {run_s:.1f}s, the last update "
            f"{1e3 * (t[u] - t[u - 1]):.1f} ms")
    if key == "uniter_masked_coco":
        line += f"; tasks drawn {tasks}"
    if key in ("uniter_vqa2", "lxmert_vqa2", "vinvl_vqa2"):
        save_dir = trainer.config["env"]["save_dir"]
        check(os.path.exists(os.path.join(save_dir, f"{model}_final.pth")),
              f"{key}: no final model in {save_dir}")
        reports = {split: json.load(open(f)) for split in ("val", "test")
                   for f in glob.glob(os.path.join(
                       save_dir, "reports", f"{dataset}_*_{split}_*.json"))}
        rows = {k: len(v) for k, v in reports.items()}
        # VinVL's dataset formats no prediction rows, in JAX too
        want_rows = ({"val": 0, "test": 0} if key == "vinvl_vqa2" else
                     {"val": VL3_SPLITS["val"], "test": VL3_SPLITS["test"]})
        check(rows == want_rows, f"{key} report rows {rows}")
        report, meter = trainer.evaluation_loop("val")
        acc = meter.meters[f"val/{dataset}/vqa_accuracy"].global_avg
        check(report.batch_size == VL3_SPLITS["val"] and 0.0 <= acc <= 1.0,
              f"{key} val vqa_accuracy {acc}")
        line += (f"; val vqa_accuracy {acc:.4f} over {VL3_SPLITS['val']} "
                 f"questions, report rows {rows}")
    return line, launches, trainer


def phase_vl3_runs(card):
    """UNITER, LXMERT and VinVL at full width: mmf_run of the five
    ``flagship.VL3`` configs on a synthetic VQA2 and COCO layout, the
    compared steps, and mmf_serve of the three finetuned folders against
    a CPU engine on the same weights."""
    from mmf_tpu_torch.common.registry import registry
    from tests.torch_vqa2_layout import write_layout

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vl3_")
    total = dict(ZERO_COUNTS)
    lines, trainers, seconds = [], [], {}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    try:
        t0 = time.perf_counter()
        write_layout(tmp, n_train=VL3_SPLITS["train"],
                     n_val=VL3_SPLITS["val"], n_test=VL3_SPLITS["test"],
                     n_images=RUN_IMAGES, regions=REGIONS, feature_dim=VDIM,
                     num_answers=RUN_ANSWERS, vocab_size=VOCAB, seed=0,
                     full_boxes=True, cls_prob_width=flagship.V_TARGET_SIZE,
                     coco=True, object_labels=True)
        # masked VQA2 for LXMERT at its 36 regions an image, as MMF's
        # VQA2 features have them: the features database cuts the
        # features to max_features, and the boxes in their info stay as
        # many as the file holds, in JAX too
        lx_root = os.path.join(tmp, "lxmert_36")
        write_layout(lx_root, n_train=VL3_SPLITS["train"],
                     n_val=VL3_SPLITS["val"], n_test=VL3_SPLITS["test"],
                     n_images=RUN_IMAGES, regions=LX_REGIONS,
                     feature_dim=VDIM, num_answers=RUN_ANSWERS,
                     vocab_size=VOCAB, seed=0, full_boxes=True)
        seconds["layout"] = time.perf_counter() - t0
        for key in flagship.VL3:
            t0 = time.perf_counter()
            line, launches, trainer = _vl3_run(
                key, lx_root if key == "lxmert_pretrain" else tmp, card)
            trainer.teardown()
            add(launches)
            lines.append(line)
            if key in ("uniter_vqa2", "lxmert_vqa2", "vinvl_vqa2"):
                trainers.append((key, trainer))
            else:
                del trainer
            seconds[key] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        for key in VL3_COMPARED:
            t0 = time.perf_counter()
            line, launches = _vl3_compared(key, card)
            add(launches)
            lines.append(line)
            seconds[f"{key} compared"] = time.perf_counter() - t0
        for key, trainer in trainers:
            t0 = time.perf_counter()
            att, ln = VL3_PER_FORWARD[key][:2]
            model = flagship.vl3_model(trainer.config)
            model.load_state_dict({k: v.cpu() for k, v in
                                   trainer.model.state_dict().items()},
                                  strict=True)
            batch = flagship.vl3_batch(key, SERVED_REQUESTS, seed=9)
            batch.pop("targets")
            launches, line = _served_folder(
                card, trainer.config["env"]["save_dir"], model,
                flagship.split_samples(batch),
                dict(ZERO_COUNTS, flash_attention_fwd=att, layer_norm=ln),
                None, key, ref_device="cpu")
            add(launches)
            lines.append(f"  {key} served:" + line[1:])
            seconds[f"{key} served"] = time.perf_counter() - t0
            del model
            torch.cuda.empty_cache()
    finally:
        for _, trainer in trainers:
            trainer.teardown()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase vl3-runs: ok UNITER, LXMERT and VinVL (BERT-base, 768 wide, "
          f"12 heads, f32) through mmf_run, the compared steps and mmf_serve "
          f"on a synthetic VQA2 and COCO layout ({VL3_SPLITS} questions over "
          f"{RUN_IMAGES} images, {REGIONS} boxes of {VDIM}, cls_prob "
          f"{flagship.V_TARGET_SIZE} wide, object labels, COCO's imdb files "
          f"and VinVL's label map) on '{card}'; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ":")
    for line in lines:
        print(line)
    return total


# -- phase 29: K4-bwd at the shapes the main paths ran it at -----------------
class LnBwdRecord:
    """The shapes K4-bwd ran at on the main paths, by phase: each
    optimizer step that launched K4-bwd is filed under its phase with its
    calls' multiset of (rows, hidden, dtype, residual), as K4-bwd reads
    them (``L.kernel_operands``). It wraps ``L.layer_norm_backward``, the
    autograd backward's dispatch (the kernels phases call the wrapper
    directly and are not recorded), and closes a step at each optimizer
    step (torch's global post-step hook). Calls outside any step are
    filed under the phase's end."""

    def __init__(self):
        self.phase = "start"
        self.pending = []  # this step's calls so far
        self.steps = {}  # phase -> {step's calls (sorted tuple): steps}
        self._dispatch = None
        self._hook = None

    def _key(self, x, residual):
        native = x.dtype in L._DTYPE_CODE and (residual is None
                                               or residual.dtype == x.dtype)
        return (x.numel() // x.shape[-1], x.shape[-1],
                str(x.dtype if native else torch.float32)[6:],
                residual is not None and native)

    def _close(self, *_):
        if self.pending:
            sig = tuple(sorted(collections.Counter(self.pending).items()))
            per = self.steps.setdefault(self.phase, {})
            per[sig] = per.get(sig, 0) + 1
            self.pending = []

    def set_phase(self, name):
        self._close()
        self.phase = name

    def start(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        dispatch = self._dispatch = L.layer_norm_backward

        def recording(x, residual, scale, bias, dy, eps):
            before = L.layer_norm_backward_kernel.launches
            out = dispatch(x, residual, scale, bias, dy, eps)
            if L.layer_norm_backward_kernel.launches > before:
                self.pending.append(self._key(x, residual))
            return out

        L.layer_norm_backward = recording
        self._hook = register_optimizer_step_post_hook(self._close)

    def stop(self):
        self._close()
        L.layer_norm_backward = self._dispatch
        self._hook.remove()

    def shapes(self):
        """{(rows, hidden, dtype, residual): [(phase, steps, calls a
        step)]} over every recorded step."""
        out = {}
        for phase, per in self.steps.items():
            for sig, n in per.items():
                for key, calls in sig:
                    out.setdefault(key, []).append((phase, n, calls))
        return out


def _ln_bwd_shape_case(g, rows, hidden, dtype, residual):
    """K4-bwd at one recorded shape: against its plain backward within
    the kernels phase's tolerances, bit-equal across two calls, timed by
    device_ms over rotating input sets (ROTATE_BYTES) beside
    F.layer_norm's backward, with the byte bound and host us a call."""
    dt = getattr(torch, dtype)
    elt = torch.empty((), dtype=dt).element_size()
    per_call = (3 if residual else 2) * rows * hidden * elt
    n_sets = max(3, math.ceil(ROTATE_BYTES / per_call))
    pool = [torch.randn(1, n_sets * rows, hidden, device=DEV,
                        generator=g).to(dt) for _ in range(3)]
    w = 1.0 + 0.1 * torch.randn(hidden, device=DEV, generator=g)
    bb = 0.1 * torch.randn(hidden, device=DEV, generator=g)
    sets = [(x_, r_ if residual else None, dy_)
            for x_, r_, dy_ in _ln_sets(pool, rows, per_call)]
    x, res, dy = sets[0]
    got = L.layer_norm_backward_kernel(x, w, dy, res)
    again = L.layer_norm_backward_kernel(x, w, dy, res)
    torch.cuda.synchronize()
    form = (f"{dtype} [{rows}, {hidden}] "
            f"{'residual' if residual else 'no residual'}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K4-bwd {form}: not bit-equal across calls")
    want = L._ln_backward_reference(x, res, w, bb, dy, 1e-12)
    errs = [rel_err(a, b, rel, f"K4-bwd {name} {form}")
            for name, a, b, rel in zip(
                ("dx", "dscale", "dbias"), got, (want[0], want[2], want[3]),
                (LN_DX_REL[dt], LN_PARAM_REL, LN_PARAM_REL))]
    del want
    lib = [_ln_library_backward(x_, r_, w, bb, dy_) for x_, r_, dy_ in sets]
    r = {"form": form, "max_abs_err": max(errs),
         "ms": device_ms(rotating(
             lambda x_, r_, dy_: L.layer_norm_backward_kernel(x_, w, dy_,
                                                              r_), sets),
             repeats=3),
         "library_ms": device_ms(rotating(lambda f_: f_(),
                                          [(f_,) for f_ in lib]), repeats=3),
         "host_us": host_us(lambda: L.layer_norm_backward_kernel(
             x, w, dy, res), iters=30),
         "sets": n_sets}
    r["bound_ms"], r["bound_by"] = bound(
        _nbytes(x, res, w, dy, got[0], got[1], got[2]), 10 * x.numel(), dt)
    # K4, the forward, at the same shape beside F.layer_norm (after the
    # add; its weights in x's dtype)
    y = L.layer_norm_kernel(x, w, bb, res)
    torch.cuda.synchronize()
    if dt in TOL:
        max_err(y, L._ln_reference(x, res, w, bb, 1e-12), dt)
    w_dt, bb_dt = w.to(dt), bb.to(dt)
    k4 = {"ms": device_ms(rotating(
        lambda x_, r_, _: L.layer_norm_kernel(x_, w, bb, r_), sets),
        repeats=3),
        "library_ms": device_ms(rotating(
            lambda x_, r_, _: F.layer_norm(x_ if r_ is None else x_ + r_,
                                           (hidden,), w_dt, bb_dt, 1e-12),
            sets), repeats=3)}
    k4["bound_ms"], k4["bound_by"] = bound(_nbytes(x, res, w, bb, y),
                                           8 * x.numel(), dt)
    r["K4"] = k4
    del lib, pool, sets, got, again, y
    torch.cuda.empty_cache()
    return r


# BUTD on COCO and Pythia on VQA2 at full width, on one synthetic layout
# (tests/torch_vqa2_layout.py with COCO's captions): 100 regions x 2048,
# BUTD's COCO vocabulary at CAPTION_VOCAB words (MMF's thresh-5 file holds
# ~9,500 and is not in the repository), 52 decode steps, f32
CAPTION_VOCAB = 9487
CAPTION_IMAGES = 200  # 106 train images: 530 captions; 1536 questions
CAPTION_SPLITS = {"train": 1536, "val": 256, "test": 256}  # VQA2 questions
BUTD_B, PYTHIA_B, JOINT_B = 256, 512, 128
BUTD_UPDATES, PYTHIA_UPDATES, JOINT_UPDATES = 3, 3, 3
BUTD_SERVED_CALLS = 8  # batch-1 beam searches served (p95: the largest)
BUTD_CPU_REQUESTS = 4  # served captions held against the CPU engine's
# a card forward against the CPU's on the same weights and inputs, f32
# with TF32 off: the largest |difference| over the largest |output|
CARD_VS_CPU_RTOL = 1e-4


def _caption_layout():
    """The layout both phases read, under a fresh folder: (root, seconds)."""
    from tests.torch_vqa2_layout import write_layout

    root = tempfile.mkdtemp(prefix="chip_smoke_captions_")
    t0 = time.perf_counter()
    write_layout(root, n_train=CAPTION_SPLITS["train"],
                 n_val=CAPTION_SPLITS["val"], n_test=CAPTION_SPLITS["test"],
                 n_images=CAPTION_IMAGES, glove=True, coco=True,
                 caption_vocab=CAPTION_VOCAB, visual_genome=True, ocr=True,
                 vizwiz=True)
    return root, time.perf_counter() - t0


def phase_caption_layout(card):
    """The layout of butd-run, pythia-run, multihead-run and
    lorra-ban-run: its folder."""
    root, seconds = _caption_layout()
    print(f"phase caption-layout: ok BUTD's COCO captions and Pythia's "
          f"VQA2 questions with their OCR tokens (and their copies as "
          f"Visual Genome's and VizWiz's) over "
          f"{CAPTION_IMAGES} images of 100 regions x "
          f"2048 (tests/torch_vqa2_layout.py), written in {seconds:.1f}s",
          flush=True)
    return root


def _features_opts(root, dataset):
    """The layout's data dir and ``dataset``'s region features (the
    layout's folders of .npy files stand for the config's LMDBs)."""
    return [f"env.data_dir={root}"] + [
        f"dataset_config.{dataset}.features.{split}=[coco/defaults/"
        f"features/{folder}]" for split, folder in (
            ("train", "trainval2014"), ("val", "trainval2014"),
            ("test", "test2015"))]


def _card_vs_cpu(model, batch, field):
    """``field`` of ``model``'s eval forward on the card and on a CPU
    copy of it: (|card - cpu| max / |cpu| max, card, cpu)."""
    cpu = copy.deepcopy(model).to("cpu").eval()
    model.eval()
    with torch.no_grad():
        got = model(train_state._to_device(dict(batch), DEV))[field]
        want = cpu(train_state._to_device(dict(batch), torch.device("cpu")))[
            field]
    got = got.float().cpu()
    rel = float((got - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)
    del cpu
    return rel, got, want


def _run_update_ms(recorder, u):
    """An update on the host clock over updates 2-u (the first left out)."""
    t = recorder.loss_read
    return 1e3 * (t[u] - t[1]) / (u - 1)


def phase_butd_run(card, root):
    """BUTD through mmf_run at full width on COCO (B=256): the defaults
    config trains teacher-forced on ``text[:, 1:]`` (the reference's
    targets, ROADMAP C.10) and evaluates BLEU-4 on the greedy argmax;
    ``beam_search.yaml`` (k = 5) and ``nucleus_sampling.yaml`` evaluate
    the trained weights and write ``{image_id, caption}`` rows; a step's
    device time by kind, the decodes' ms, the served beam search at batch
    1 and bucket 32 from the beam config's checkpoint, the card against
    the CPU: the launches (no hand-written kernel runs here)."""
    import glob

    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.serving import ServingEngine

    total = dict(ZERO_COUNTS)
    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    u = BUTD_UPDATES
    # one validation, at the end; greedy captions give no prediction
    # rows (KeyError: 'captions', in JAX too, ROADMAP C.4)
    opts = (flagship.BUTD_OVERRIDES + _features_opts(root, "coco")
            + [f"training.evaluation_interval={u}",
               "training.checkpoint_interval=1000", "run_type=train_val",
               *LOADER_IN_PROCESS])
    trainer, recorder, launches, run_s = _cli_run(
        os.path.join(root, "save_butd"), flagship.BUTD["defaults"], "butd",
        "coco", u, opts, batch_size=BUTD_B)
    total = {k: total[k] + launches[k] for k in total}
    check(launches == ZERO_COUNTS, f"butd launches {launches}")
    vocab = registry.get("coco_text_processor").get_vocab_size()
    mc = trainer.config["model_config"]["butd"]
    model = trainer.model
    check((model.vocab_size, model.max_length, model.hidden_dim,
           tuple(model.step.top_down_attention.Dense_0.weight.shape)) == (
        vocab, 52, 1024, (1024, 2048)), f"butd model {dict(mc)}")
    losses = list(trainer.meter.meters[
        "train/coco/caption_cross_entropy"].averaged_value_deque)
    check(len(losses) == u and all(math.isfinite(x) for x in losses),
          f"butd losses {losses}")
    check(len(recorder.val_meters) == 1, "butd validations")
    meter = recorder.val_meters[0]
    bleu = meter.meters["val/coco/caption_bleu4"].global_avg
    val_loss = meter.meters["val/coco/caption_cross_entropy"].global_avg
    check(0.0 <= bleu <= 1.0 and math.isfinite(val_loss),
          f"butd val {bleu} {val_loss}")
    update_ms = _run_update_ms(recorder, u)
    trainer.teardown()
    batch = recorder.batches[0]
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    final = os.path.join(root, "butd_trained.pth")
    torch.save(weights, final)

    # the step alone on the run's first batch: device time by kind
    cfg = trainer.config
    step_model = flagship.caption_model(cfg)
    step_model.load_state_dict(recorder.initial, strict=True)
    state, step = flagship.caption_trainer(step_model, cfg, seed=1)
    box = [state]
    torch.cuda.reset_peak_memory_stats()

    def one_step():
        box[0], rep = step(box[0], batch)
        float(rep["total_loss"])

    one_step()
    t0 = time.perf_counter()
    one_step()
    step_wall_ms = 1e3 * (time.perf_counter() - t0)
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_ms, by_category = _device_ms(one_step, 1)
    del state, step, step_model, box

    # the card against the CPU: teacher-forced scores and greedy captions
    # of 4 captions on the trained weights
    small = {k: v[:4] for k, v in batch.items() if torch.is_tensor(v)}
    small.update(dataset_name="coco", dataset_type="val")
    tf_rel, _, _ = _card_vs_cpu(model, small, "scores")
    check(tf_rel <= CARD_VS_CPU_RTOL, f"butd teacher forcing card vs cpu "
          f"{tf_rel}")
    # greedy: each caption's scores up to its first step whose argmax
    # differs, and such a step only at a near-tie (_served_vs_cpu)
    greedy = {k: v for k, v in small.items() if k != "text"}
    _, g_card, g_cpu = _card_vs_cpu(model, greedy, "scores")
    g_cmp = [_served_vs_cpu(a.numpy(), b.float().numpy())
             for a, b in zip(g_card, g_cpu)]
    g_rel = max(r for r, _, _ in g_cmp)
    greedy_same = sum(not differs for _, differs, _ in g_cmp)
    check(g_rel <= CARD_VS_CPU_RTOL and all(tie for _, _, tie in g_cmp),
          f"butd greedy card vs cpu: {g_cmp}")

    # beam search and nucleus sampling through mmf_run on the trained
    # weights: one update (no loss under these types, in JAX too) writes
    # the folder, then the val evaluation (BLEU-4) and the predictions
    decodes, lines = {}, []
    for key in ("beam_search", "nucleus_sampling"):
        dopts = (flagship.BUTD_OVERRIDES + _features_opts(root, "coco")
                 + _evaluated(1)
                 + [f"checkpoint.resume_file={final}",
                    f"model_config.butd.text_vocab_size={vocab}",
                    *LOADER_IN_PROCESS])
        dtrainer, drecorder, dlaunches, drun_s = _cli_run(
            os.path.join(root, f"save_butd_{key}"), flagship.BUTD[key],
            "butd", "coco", 1, dopts, batch_size=BUTD_B)
        total = {k: total[k] + dlaunches[k] for k in total}
        check(dlaunches == ZERO_COUNTS, f"butd {key} launches {dlaunches}")
        dmodel = dtrainer.model
        check(all(torch.equal(v, weights[k]) for k, v in
                  dmodel.state_dict().items()),
              f"butd {key}: an update without a loss moved the weights")
        check(len(drecorder.val_meters) == 1, f"butd {key} validations")
        dbleu = drecorder.val_meters[0].meters[
            "val/coco/caption_bleu4"].global_avg
        save_dir = dtrainer.config["env"]["save_dir"]
        rows = {}
        for split in ("val", "test"):
            files = glob.glob(os.path.join(save_dir, "reports",
                                           f"coco_*_{split}_*.json"))
            check(len(files) == 1, f"butd {key} {split} reports {files}")
            with open(files[0]) as f:
                rows[split] = json.load(f)
        check(all(r and all(set(x) == {"image_id", "caption"} for x in r)
                  for r in rows.values()) and 0.0 <= dbleu <= 1.0,
              f"butd {key} rows {[len(r) for r in rows.values()]} {dbleu}")
        val_batch = train_state._to_device(dict(batch), DEV)
        val_batch.update(dataset_name="coco", dataset_type="val")
        val_batch.pop("text")
        dmodel.eval()

        def decode():
            with torch.no_grad():
                return dmodel(val_batch)["captions"]

        caps = decode()
        check(tuple(caps.shape) == (BUTD_B, 52) and int(caps.min()) >= 0
              and int(caps.max()) < vocab, f"butd {key} captions "
              f"{tuple(caps.shape)}")
        torch.cuda.reset_peak_memory_stats()
        decode_ms = time_ms(decode, iters=1, repeats=3)
        decode_peak = torch.cuda.max_memory_allocated() / 1e9
        dec_dev_ms, dec_by = _device_ms(decode, 1)
        decodes[key] = (decode_ms, dec_dev_ms, dec_by, decode_peak)
        lines.append(
            f"  {key}: val BLEU-4 {dbleu:.4f}, {sum(map(len, rows.values()))}"
            f" prediction rows {{image_id, caption}} (val {len(rows['val'])},"
            f" test {len(rows['test'])}); a decode of B={BUTD_B} "
            f"{decode_ms:.1f} ms (CUDA events, best of 3), device "
            f"{dec_dev_ms:.1f} ms (idle "
            f"{100 * max(0.0, 1 - dec_dev_ms / decode_ms):.1f}%), peak "
            f"{decode_peak:.2f} GB, by kind (ms, launches): " + "; ".join(
                f"{c} {ms:.2f} x{n:.0f}" for c, (ms, n) in sorted(
                    dec_by.items(), key=lambda kv: -kv[1][0])[:4])
            + f"; run {drun_s:.1f}s")
        if key == "beam_search":
            beam_dir = save_dir
            requests = [{"image_feature_0": batch["image_feature_0"][i]
                         .cpu().numpy()} for i in range(SERVE_B)]
            cpu_model = flagship.caption_model(dtrainer.config).eval()
            cpu_model.load_state_dict(
                {k: v.cpu() for k, v in dmodel.state_dict().items()})
        dtrainer.teardown()
        del dtrainer, dmodel, val_batch
        torch.cuda.empty_cache()

    # served: the beam config's checkpoint through from_checkpoint
    _prune_checkpoints(beam_dir)
    engine = ServingEngine.from_checkpoint(beam_dir, max_batch_size=SERVE_B)
    reset_counts()
    engine.predict(requests[0])
    lat = []
    for i in range(BUTD_SERVED_CALLS):
        t0 = time.perf_counter()
        out = engine.predict(requests[i % SERVE_B])
        lat.append(1e3 * (time.perf_counter() - t0))
    check(tuple(out["captions"].shape) == (52,), f"served caption "
          f"{out['captions'].shape}")
    engine.predict_many(requests)
    t0 = time.perf_counter()
    served = engine.predict_many(requests)
    bucket_ms = 1e3 * (time.perf_counter() - t0)
    served_launches = read_counts()
    check(served_launches == ZERO_COUNTS, f"served butd {served_launches}")
    # the CPU engine decodes the first BUTD_CPU_REQUESTS of them (a
    # full-width beam search on the host's cores takes seconds a sample)
    cpu_engine = ServingEngine(cpu_model, device="cpu",
                               max_batch_size=BUTD_CPU_REQUESTS,
                               meta=dict(engine.meta))
    want = cpu_engine.predict_many(requests[:BUTD_CPU_REQUESTS])
    same = sum(bool(np.array_equal(g["captions"], w["captions"]))
               for g, w in zip(served, want))
    check(same == BUTD_CPU_REQUESTS, f"served beam search: {same}/"
          f"{BUTD_CPU_REQUESTS} captions equal to the CPU engine's")
    del engine, cpu_engine, cpu_model
    torch.cuda.empty_cache()
    print(f"phase butd-run: ok BUTD at full width (B={BUTD_B}, 100 regions x "
          f"2048 through fc7 2048, attention 1024, LSTMs 1024, words 300, "
          f"{vocab} words in the COCO vocabulary (synthetic: "
          f"{CAPTION_VOCAB} in the file), 52 steps, f32), "
          f"{flagship.BUTD['defaults']} with flagship.BUTD_OVERRIDES: "
          f"{u} updates, losses {[round(x, 4) for x in losses]}, val "
          f"caption_cross_entropy {val_loss:.4f}, BLEU-4 {bleu:.4f}; "
          f"{update_ms:.1f} ms an update over updates 2-{u} (host clock, "
          f"the loader in the main process; run {run_s:.1f}s); the step alone "
          f"{step_wall_ms:.1f} ms wall, device {dev_ms:.2f} ms (idle "
          f"{100 * max(0.0, 1 - dev_ms / step_wall_ms):.1f}%), peak "
          f"{step_peak_gb:.2f} GB, by kind (ms, launches): " + "; ".join(
              f"{c} {ms:.2f} x{n:.0f}" for c, (ms, n) in sorted(
                  by_category.items(), key=lambda kv: -kv[1][0]))
          + f"; card vs CPU on 4 captions: teacher-forced scores rel "
          f"{tf_rel:.2e} (bound {CARD_VS_CPU_RTOL}), greedy scores rel "
          f"{g_rel:.2e} (bound {CARD_VS_CPU_RTOL}), {greedy_same}/4 greedy "
          "captions equal (a difference only at a near-tie); launches "
          f"{launches} (no hand-written kernel on this path); on '{card}'")
    for line in lines:
        print(line)
    print(f"  served beam search (k = 5) from {os.path.basename(beam_dir)}"
          f" through ServingEngine.from_checkpoint: batch 1 p50 "
          f"{np.percentile(lat, 50):.1f} ms, p95 {np.percentile(lat, 95):.1f}"
          f" ms over {BUTD_SERVED_CALLS} calls (host clock); bucket "
          f"{SERVE_B} {bucket_ms:.1f} ms; {same}/{BUTD_CPU_REQUESTS} of its "
          "captions equal to the CPU engine's on the same weights")
    return total


def phase_pythia_run(card, root):
    """Pythia through mmf_run at full width on VQA2 (B=512; the combine
    and classifier 5000 wide, the attention text embedding 1024 wide,
    3129 answers): the updates' losses, val accuracy, prediction rows, a
    step's device time by kind, served at bucket 32 from the run's
    folder; ``pythia_question_only`` and ``pythia_image_only``: one
    forward each on the card against the CPU."""
    import glob

    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.serving import ServingEngine

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    u = PYTHIA_UPDATES
    opts = _features_opts(root, "vqa2") + _evaluated(u) + [
        *LOADER_IN_PROCESS]
    trainer, recorder, launches, run_s = _cli_run(
        os.path.join(root, "save_pythia"), flagship.PYTHIA_VQA2_CONFIG,
        "pythia", "vqa2", u, opts, batch_size=PYTHIA_B)
    check(launches == ZERO_COUNTS, f"pythia launches {launches}")
    model = trainer.model
    check((model.classifier.module.f_o_image.Dense_0.weight.shape[0],
           model.text_dim, model.classifier.module.linear_text.weight.shape[
               0]) == (5000, 2048, flagship.VQA2_NUM_LABELS),
          "pythia widths")
    losses = list(trainer.meter.meters[
        "train/vqa2/logit_bce"].averaged_value_deque)
    check(len(losses) == u and all(math.isfinite(x) for x in losses),
          f"pythia losses {losses}")
    check(len(recorder.val_meters) == 1, "pythia validations")
    acc = recorder.val_meters[0].meters["val/vqa2/vqa_accuracy"].global_avg
    check(0.0 <= acc <= 1.0, f"pythia accuracy {acc}")
    save_dir = trainer.config["env"]["save_dir"]
    rows = {}
    for split in ("val", "test"):
        files = glob.glob(os.path.join(save_dir, "reports",
                                       f"vqa2_*_{split}_*.json"))
        check(len(files) == 1, f"pythia {split} reports {files}")
        with open(files[0]) as f:
            rows[split] = json.load(f)
    check(len(rows["val"]) == CAPTION_SPLITS["val"]
          and len(rows["test"]) == CAPTION_SPLITS["test"],
          f"pythia rows {[len(r) for r in rows.values()]}")
    update_ms = _run_update_ms(recorder, u)
    trainer.teardown()
    batch = recorder.batches[0]
    cfg = trainer.config
    step_model = flagship.caption_model(cfg)
    step_model.load_state_dict(recorder.initial, strict=True)
    state, step = flagship.caption_trainer(step_model, cfg, seed=1)
    box = [state]
    torch.cuda.reset_peak_memory_stats()

    def one_step():
        box[0], rep = step(box[0], batch)
        float(rep["total_loss"])

    one_step()
    t0 = time.perf_counter()
    one_step()
    step_wall_ms = 1e3 * (time.perf_counter() - t0)
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_ms, by_category = _device_ms(one_step, 1)
    del state, step, step_model, box
    small = {k: (v[:8] if torch.is_tensor(v) else
                 {kk: vv[:8] for kk, vv in v.items()})
             for k, v in batch.items() if torch.is_tensor(v)
             or isinstance(v, dict)}
    small.update(dataset_name="vqa2", dataset_type="val")
    rel, _, _ = _card_vs_cpu(model, small, "scores")
    check(rel <= CARD_VS_CPU_RTOL, f"pythia card vs cpu {rel}")

    # served at bucket 32 from the run's folder
    _prune_checkpoints(save_dir)
    engine = ServingEngine.from_checkpoint(save_dir, max_batch_size=SERVE_B)
    fields = {k: v for k, v in batch.items()
              if k in ("text", "image_feature_0", "image_info_0")}
    requests = [{k: ({kk: vv[i].cpu().numpy() for kk, vv in v.items()}
                     if isinstance(v, dict) else v[i].cpu().numpy())
                 for k, v in fields.items()} for i in range(SERVE_B)]
    engine.predict_many(requests)
    t0 = time.perf_counter()
    served = engine.predict_many(requests)
    bucket_ms = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        model.eval()
        want = model({k: (v[:SERVE_B] if torch.is_tensor(v) else
                          {kk: vv[:SERVE_B] for kk, vv in v.items()})
                      for k, v in fields.items()})["scores"].float(
                          ).cpu().numpy()
    got = np.stack([o["scores"] for o in served])
    served_rel = float(np.abs(got - want).max() / np.abs(want).max())
    check(served_rel <= CARD_VS_CPU_RTOL, f"pythia served {served_rel}")
    del engine

    # the ablations: one forward each, card against CPU
    ablations = []
    words = model.word_embedding.weight.shape[0]
    for name in flagship.PYTHIA_MODELS[1:]:
        acfg = flagship.pythia_config(
            [f"env.data_dir={root}",
             f"model_config.{name}.text_vocab_size={words}"], model=name)
        amodel = flagship.caption_model(acfg)
        amodel.init_weights(torch.Generator().manual_seed(5))
        amodel.to(DEV)
        arel, scores, _ = _card_vs_cpu(amodel, small, "scores")
        check(arel <= CARD_VS_CPU_RTOL and tuple(scores.shape) == (
            8, flagship.VQA2_NUM_LABELS), f"{name} card vs cpu {arel}")
        ablations.append(f"{name} rel {arel:.2e}")
        del amodel
    del model
    torch.cuda.empty_cache()
    print(f"phase pythia-run: ok Pythia at full width (B={PYTHIA_B}, 100 "
          "regions x 2048 through fc7, the attention text embedding 1024 "
          "wide (2 glimpses), combine and classifier 5000 wide, "
          f"{flagship.VQA2_NUM_LABELS} answers, f32), "
          f"{flagship.PYTHIA_VQA2_CONFIG}: {u} updates, losses "
          f"{[round(x, 4) for x in losses]}, val vqa_accuracy {acc:.4f}, "
          f"{len(rows['val'])} + {len(rows['test'])} prediction rows; "
          f"{update_ms:.1f} ms an update over updates 2-{u} (host clock, "
          f"the loader in the main process; run {run_s:.1f}s); the step alone "
          f"{step_wall_ms:.1f} ms wall, device {dev_ms:.2f} ms (idle "
          f"{100 * max(0.0, 1 - dev_ms / step_wall_ms):.1f}%), peak "
          f"{step_peak_gb:.2f} GB, by kind (ms, launches): " + "; ".join(
              f"{c} {ms:.2f} x{n:.0f}" for c, (ms, n) in sorted(
                  by_category.items(), key=lambda kv: -kv[1][0]))
          + f"; card vs CPU on 8 questions rel {rel:.2e} (bound "
          f"{CARD_VS_CPU_RTOL}); served from the run's folder at bucket "
          f"{SERVE_B}: {bucket_ms:.1f} ms, rel {served_rel:.2e} against the "
          "in-memory model; one forward each: " + ", ".join(ablations)
          + f"; launches {launches} (no hand-written kernel on this path); "
          f"on '{card}'")
    return dict(ZERO_COUNTS)


def phase_m4c_coco_joint(card):
    """The M4C captioner trained jointly on TextCaps and COCO
    (``flagship.JOINT_COCO``, B=128) at full width: the family run's
    checks (exact K4 / K4-bwd launches an update, K1 and K4 in each
    greedy-decode forward, BLEU-4, caption rows), and its first batch
    through the kernels against the plain versions (K1-stats, K2, K3):
    the launches."""
    from mmf_tpu_torch.datasets.processors import processors as P
    from tests.torch_textvqa_layout import (
        FastTextStandIn,
        write_joint_coco_layout,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_joint_coco_")
    load_fasttext = P.FastTextProcessor._load_fasttext_model

    def stand_in(self, model_file):  # wiki.en.bin's seeded stand-in
        self.model = FastTextStandIn()

    P.FastTextProcessor._load_fasttext_model = stand_in
    muted = contextlib.ExitStack()
    muted.enter_context(warnings.catch_warnings())
    warnings.filterwarnings("ignore", message="\nThe hypothesis contains 0 "
                            "counts of")
    trainer = None
    try:
        t0 = time.perf_counter()
        write_joint_coco_layout(
            root, n_train=JOINT_B * JOINT_UPDATES // 2,
            n_val=FAMILY_SPLITS["val"], n_test=FAMILY_SPLITS["test"],
            n_images=FAMILY_IMAGES, coco_images=FAMILY_IMAGES,
            num_answers=flagship.M4C_ANSWERS, vocab_size=VOCAB, seed=30)
        layout_s = time.perf_counter() - t0
        trainer, recorder, launches, line, (update_ms, split) = \
            _family_run("joint_coco", root, card)
        total = dict(launches)
        cfg = trainer.config
        batch = recorder.batches[0]
        model = trainer.model
        val_batch = train_state._to_device(
            next(iter(trainer.val_loader)).pytree(), DEV)
        val_batch.update(dataset_name="textcaps", dataset_type="val")
        trainer.teardown()
        model.eval()

        def decode():
            with torch.no_grad():
                return model(val_batch)["scores"]

        torch.cuda.reset_peak_memory_stats()
        decode_ms = time_ms(decode, iters=1, repeats=3)
        dec_dev_ms, _ = _device_ms(decode, 1)
        decode_peak = torch.cuda.max_memory_allocated() / 1e9
        del model, val_batch
        step_model = flagship.m4c_family_model(cfg)
        step_model.load_state_dict(recorder.initial, strict=True)
        state, step = flagship.textvqa_trainer(step_model, cfg, seed=1)
        box = [state]

        def one_step():
            box[0], rep = step(box[0], batch)
            float(rep["total_loss"])

        one_step()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one_step()
        step_wall_ms = 1e3 * (time.perf_counter() - t0)
        step_peak = torch.cuda.max_memory_allocated() / 1e9
        dev_ms, by_category = _device_ms(one_step, 1)
        del state, step, step_model, box
        torch.cuda.empty_cache()

        def build(c, o=None):
            return flagship.m4c_family_model(c, M4C_NO_DROPOUT)

        text, k_launches = _kernels_vs_plain(
            cfg, recorder.initial, batch, build, flagship.textvqa_trainer, 1,
            "joint captioner")
        check(k_launches == dict(
            ZERO_COUNTS, flash_attention_fwd_stats=M4C_TRAIN_ATTENTION,
            flash_attention_bwd_dq=M4C_TRAIN_ATTENTION,
            flash_attention_bwd_dkv=M4C_TRAIN_ATTENTION,
            layer_norm=M4C_TRAIN_LN, layer_norm_bwd=M4C_TRAIN_LN),
            f"joint captioner kernel side {k_launches}")
        total = {k: total[k] + k_launches[k] for k in total}
        print(f"phase m4c-coco-joint: ok {flagship.JOINT_COCO[0]} with "
              "flagship.M4C_FAMILY_OVERRIDES['joint_coco'] at full width "
              "(TextBert 3 x 768, MMT 4 x 768, "
              f"{flagship.M4C_ANSWERS} answers + {flagship.M4C_OCR} OCR "
              f"copies, f32) on the joint layout (write_joint_coco_layout: "
              f"32 TextCaps tiles and COCO's captions, written in "
              f"{layout_s:.1f}s):")
        print(line)
        print(f"  the step alone on the run's first batch: {step_wall_ms:.1f}"
              f" ms wall, device {dev_ms:.2f} ms (idle "
              f"{100 * max(0.0, 1 - dev_ms / step_wall_ms):.1f}%), peak "
              f"{step_peak:.2f} GB, by kind (ms, launches): " + "; ".join(
                  f"{c} {ms:.2f} x{n:.0f}" for c, (ms, n) in sorted(
                      by_category.items(), key=lambda kv: -kv[1][0]))
              + f"; a greedy decode of a val batch (B={JOINT_B}) "
              f"{decode_ms:.2f} ms (CUDA events, best of 3), device "
              f"{dec_dev_ms:.2f} ms (idle "
              f"{100 * max(0.0, 1 - dec_dev_ms / decode_ms):.1f}%), peak "
              f"{decode_peak:.2f} GB")
        print(f"  the first batch, kernels vs plain versions: {text}")
        return total
    finally:
        muted.close()
        P.FastTextProcessor._load_fasttext_model = load_fasttext
        if trainer is not None:
            trainer.teardown()
        shutil.rmtree(root, ignore_errors=True)


# -- phases 32-34: mmf_bert and Pythia's multihead --------------------------
PYTHIA2_B, MMF_BERT_MASKED_B = 512, 480  # the configs' batches
MMF_BERT_SEQ = flagship.MMF_BERT_SEQ  # bert_tokenizer's 128 tokens
# the attention calls and their shapes (sq, skv, head dim, a padding bias):
# mmf_bert's 768 wide over 8 heads (D = 96): the text self-attention with
# the key padding, the regions' intra-attention, the text's queries over
# the regions; multihead's 2048-wide question over 8 heads (D = 256, the
# wide kernels): one query row over the 100 regions
PYTHIA2_ATTENTION_SHAPES = {
    "mmf_bert text self 128x128": (MMF_BERT_SEQ, MMF_BERT_SEQ, 96, True),
    "mmf_bert intra 100x100": (REGIONS, REGIONS, 96, False),
    "mmf_bert cross 128x100": (MMF_BERT_SEQ, REGIONS, 96, False),
    "multihead 1x100": (1, REGIONS, 256, False),
}
# the wide kernels' edges at D = 256: q rows of one 16-row block or not,
# or one row into the next, against kv of one row, a 32-row ring tile, a
# ragged second, several tiles
WIDE_EDGES = [(sq, skv) for sq in (1, 2, 15, 16, 17)
              for skv in (1, 31, 32, 33, 100, 130)]
# from the code: a forward runs the text self-attention, the regions'
# intra-attention and one cross-attention (VQA2's one feature set, the
# config's one embedding), and LayerNorms in TextEmbeddings and in the
# head's transform (VQA: classifier_transform; pretraining: cls.transform);
# multihead runs one attention a feature set and no LayerNorm
MMF_BERT_ATTENTION, MMF_BERT_LN, MULTIHEAD_ATTENTION = 3, 2, 1
PYTHIA2_UPDATES = 2
PYTHIA2_SPLITS = {"train": 1024, "val": 512, "test": 512}
VG_B = 128  # projects/pythia/configs/visual_genome/defaults.yaml's batch


def _sdpa_backend(q, k, v, bias):
    """The backend F.scaled_dot_product_attention dispatches (q, k, v,
    bias) to, by name."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, bias, 0.0,
                                              False)).name


def _wide_edges(g):
    """K1 (both forms), K2 and K3 at D = 256 over WIDE_EDGES (B=2, 2
    heads, a padding bias, the second batch's every key -inf) against the
    plain versions: the largest relative error of each."""
    worst = collections.defaultdict(float)
    for sq, skv in WIDE_EDGES:
        q, k, v, _, dout = _attention_inputs(2, sq, skv, torch.float32, g,
                                             heads=2, head_dim=256)
        mask = torch.ones(2, skv, device=DEV, dtype=torch.int32)
        mask[:, skv // 2 + 1:] = 0
        mask[1] = 0
        bias = A.combine_biases(A.make_attention_bias(mask),
                                A.make_attention_bias(mask))
        out = A.flash_attention(q, k, v, bias)
        out_s, m, l = A.flash_attention_with_stats(q, k, v, bias)
        dq, delta = A.flash_attention_bwd_dq(q, k, v, bias, out_s, m, l,
                                             dout)
        dk, dv = A.flash_attention_bwd_dkv(q, k, v, bias, dout, m, l, delta)
        torch.cuda.synchronize()
        ref_out, ref_m, ref_l = A.flash_forward_reference(q, k, v, bias)
        check(torch.equal(out, out_s) and bool((out[1] == 0).all()),
              f"wide edge {sq}x{skv}: forms differ or the -inf batch")
        worst["K1"] = max(worst["K1"], max_err(out, ref_out, torch.float32))
        torch.testing.assert_close(m, ref_m, **STATS_TOL)
        torch.testing.assert_close(l, ref_l, **STATS_TOL)
        ref = A.flash_backward_reference(q, k, v, bias, out_s, m, l, dout)
        # one key: ds = dp - delta cancels, dq and dk are rounding
        for n, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            if skv > 1 or n == "dv":
                scale = max(float(want.abs().max()), 1e-6)
                worst[n] = max(worst[n], rel_err(
                    got, want, GRAD_REL[torch.float32],
                    f"wide edge {sq}x{skv} {n}") / scale)
    return dict(worst)


def phase_pythia2_kernels(card):
    """K1 (inference and stats forms), K2 and K3 in f32 at mmf_bert's
    (D = 96) and multihead's (D = 256, the wide kernels) shapes at B=512,
    against their plain versions, timed beside SDPA (its backend named)
    and the plain versions with the bounds and host time; the wide
    kernels' edges at D = 256."""
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity
    g = torch.Generator(device=DEV).manual_seed(23)
    rows, backends = {}, {}
    for label, (sq, skv, d, padded) in PYTHIA2_ATTENTION_SHAPES.items():
        q, k, v, bias, dout = _attention_inputs(PYTHIA2_B, sq, skv,
                                                torch.float32, g, heads=8,
                                                head_dim=d)
        bias = bias if padded else None
        backends[label] = _sdpa_backend(q, k, v, bias)
        rows[label] = _attention_case(f"pythia2 {label}", q, k, v, bias,
                                      dout, iters=10, plain_iters=3,
                                      repeats=3)
        del q, k, v, bias, dout
        torch.cuda.empty_cache()
    edges = _wide_edges(g)
    print(f"phase pythia2-kernels: ok K1, K1-stats, K2 and K3 in f32 at "
          f"mmf_bert's shapes (B={PYTHIA2_B}, 8 heads of 96, the text "
          "self-attention with its key padding) and multihead's (8 heads of "
          "256: the wide FMA kernels), against their plain versions within "
          "the kernels phase's bounds; device ms (spin-queued), SDPA's (the "
          "backend it dispatches to named), the plain versions', host us a "
          "call and the bound (bytes, or split-TF32 operations; the FP32 FMA "
          f"bound beside it) on '{card}':")
    for label, r in rows.items():
        ms, lib, fma = r["ms"], r["library_ms"], r["fma_bound_ms"]
        print(f"  {label} {r['shape']}: max_abs_err " + ", ".join(
            f"{n} {e:.3g}" for n, e in r["max_abs_err"].items()) + "; "
            + ", ".join(f"{n} {ms[n]:.4f} (bound {r['bound_ms'][n]:.4f} "
                        f"{r['bound_by'][n]}, FMA {fma[n]:.4f}, "
                        f"{100 * r['bound_ms'][n] / ms[n]:.0f}% of it)"
                        for n in ms)
            + f"; sdpa ({backends[label]}) fwd {lib['K1']:.4f}, fwd+lse "
            f"{lib['K1-stats']:.4f}, bwd {lib['K2+K3']:.4f} (K2+K3 "
            f"{ms['K2'] + ms['K3']:.4f}); plain " + ", ".join(
                f"{n} {t:.4f}" for n, t in r["plain_ms"].items())
            + "; host us " + ", ".join(f"{n} {u:.1f}" for n, u in
                                       r["host_us"].items()))
    print(f"  D=256 edges ({len(WIDE_EDGES)} cases, Sq 1-17 x Skv 1-130, B=2, "
          "2 heads, a padding bias and a batch of -inf keys): max error over "
          "the largest entry " + ", ".join(f"{n} {e:.3g}"
                                           for n, e in edges.items())
          + f" (bound: K1 {TOL[torch.float32]}, gradients "
          f"{GRAD_REL[torch.float32]})")
    for label, b in backends.items():
        rows[label]["sdpa_backend"] = b
    return rows


def _pythia2_layout(tmp):
    """mmf_bert's VQA2 layout: full boxes (its config returns the
    features' info, whose boxes must batch), BERT's vocabulary size."""
    from tests.torch_vqa2_layout import write_layout

    write_layout(tmp, n_train=PYTHIA2_SPLITS["train"],
                 n_val=PYTHIA2_SPLITS["val"], n_test=PYTHIA2_SPLITS["test"],
                 n_images=RUN_IMAGES, regions=REGIONS, feature_dim=VDIM,
                 num_answers=RUN_ANSWERS, vocab_size=VOCAB, seed=0,
                 full_boxes=True)


def _no_mha_dropout(model):
    """Dropout 0 on the built modules, attention probabilities too (the
    compared steps)."""
    from mmf_tpu_torch.modules.attention import TorchMultiheadAttention

    for m in model.modules():
        if isinstance(m, TorchMultiheadAttention):
            m.dropout = 0.0
    return _without_dropout(model)


def _pythia2_build(cfg, overrides=None):
    return _no_mha_dropout(flagship.pythia2_model(cfg, overrides))


def _mmf_bert_compared(cfg, head, card):
    """3 steps of mmf_bert's ``head`` through the kernels against 3
    through the plain versions at dropout 0 from seeded weights (B=64,
    128 tokens, 100 regions): the training phase's bounds; exact
    launches a step."""
    model = flagship.pythia2_model(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = flagship.mmf_bert_batch(TRAIN_B, pretraining=head ==
                                    "pretraining", seed=7)
    device = []
    line, launches = _kernels_vs_plain(cfg, init, batch, _pythia2_build,
                                       flagship.vl3_trainer, COMPARED_STEPS,
                                       f"mmf_bert {head}", device_out=device)
    dev_ms, by_category = device[0]
    att_ms, att_n = by_category.get("attention K1/K2/K3", (0.0, 0.0))
    n = COMPARED_STEPS
    want = dict(ZERO_COUNTS, flash_attention_fwd_stats=MMF_BERT_ATTENTION * n,
                flash_attention_bwd_dq=MMF_BERT_ATTENTION * n,
                flash_attention_bwd_dkv=MMF_BERT_ATTENTION * n,
                layer_norm=MMF_BERT_LN * n, layer_norm_bwd=MMF_BERT_LN * n)
    check(launches == want, f"mmf_bert {head} compared launches {launches}, "
          f"want {want}")
    return (f"  {head} compared steps (B={TRAIN_B}): {line}; the kernels' "
            f"steps' device time {dev_ms:.2f} ms a step, of it attention "
            f"{att_ms:.3f} ms x{att_n:.0f}"), launches


def phase_mmf_bert_run(card):
    """mmf_bert at full width (768 wide, 8 heads of 96, f32) through
    mmf_run: VQA2 finetuning at B=512 (2 updates, the val and test
    predictions) and masked-VQA2 pretraining at B=480 (2 updates), exact
    launches an update and a prediction forward, the losses against the
    train step on the batches the runs took; mmf_serve's engine on the
    VQA2 folder at bucket 32 (exact launches a forward) against the
    in-memory model; 3 compared steps of each head at dropout 0."""
    import glob

    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.serving import ServingEngine
    from tests.torch_vqa2_layout import layout_opts

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mmf_bert_")
    total = dict(ZERO_COUNTS)
    lines, seconds = [], {}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    trainer = None
    try:
        t0 = time.perf_counter()
        _pythia2_layout(tmp)
        seconds["layout"] = time.perf_counter() - t0
        u = PYTHIA2_UPDATES
        # VQA2: no validation inside the run (its early stopping would
        # write and read back checkpoints no number needs); the run
        # predicts val and test, then the trainer evaluates val
        t0 = time.perf_counter()
        path, dataset, model_name = flagship.PYTHIA2["mmf_bert_vqa2"]
        trainer, recorder, launches, run_s = _cli_run(
            os.path.join(tmp, "save_vqa2"), path, model_name, dataset, u,
            flagship.PYTHIA2_OVERRIDES["mmf_bert_vqa2"] + [
                "run_type=train_val_inference", "evaluation.predict=true",
                "training.evaluation_interval=1000",
                "training.checkpoint_interval=1000", *LOADER_IN_PROCESS,
                *layout_opts(tmp, "vqa2")], batch_size=PYTHIA2_B)
        forwards = -(-PYTHIA2_SPLITS["val"] // PYTHIA2_B) + -(
            -PYTHIA2_SPLITS["test"] // PYTHIA2_B)
        # training attention is plain at the config's dropout 0.1
        want = dict(ZERO_COUNTS,
                    flash_attention_fwd=MMF_BERT_ATTENTION * forwards,
                    layer_norm=MMF_BERT_LN * (u + forwards),
                    layer_norm_bwd=MMF_BERT_LN * u)
        check(launches == want, f"mmf_bert vqa2 launches {launches}, want "
              f"{want}")
        add(launches)
        mc = trainer.config["model_config"]["mmf_bert"]
        check(mc["hidden_size"] == HIDDEN and trainer.model.head == "vqa"
              and trainer.model.text_embedding.num_heads == 8,
              f"mmf_bert config {dict(mc)}")
        key = "train/vqa2/logit_bce"
        rel, got = _steps_again(trainer, recorder, flagship.pythia2_model,
                                flagship.vl3_trainer, [key])
        save_dir = trainer.config["env"]["save_dir"]
        rows = {split: len(json.load(open(f))) for split in ("val", "test")
                for f in glob.glob(os.path.join(
                    save_dir, "reports", f"vqa2_*_{split}_*.json"))}
        check(rows == {"val": PYTHIA2_SPLITS["val"],
                       "test": PYTHIA2_SPLITS["test"]},
              f"mmf_bert report rows {rows}")
        report, meter = trainer.evaluation_loop("val")
        acc = meter.meters["val/vqa2/vqa_accuracy"].global_avg
        check(0.0 <= acc <= 1.0, f"mmf_bert val vqa_accuracy {acc}")
        t = recorder.loss_read
        lines.append(
            f"  vqa2: mmf_run of {path}, B={PYTHIA2_B}: {u} updates, {key} "
            f"{[round(x, 6) for x in got[key]]} equal to the train step's on "
            f"the same batches (max rel {rel:.3g}, bound {RUN_LOSS_RTOL}); "
            f"launches {launches} (exact: {MMF_BERT_ATTENTION} K1 and "
            f"{MMF_BERT_LN} K4 a prediction forward, {MMF_BERT_LN} K4 and "
            f"K4-bwd an update); val vqa_accuracy {acc:.4f}, report rows "
            f"{rows}; run {run_s:.1f}s, the last update "
            f"{1e3 * (t[u] - t[u - 1]):.1f} ms (host clock, the loader in "
            "the main process)")
        # the step alone on the run's first batch (the config's dropout:
        # training attention plain), its device time by kind
        batch = recorder.batches[0]
        step_model = flagship.pythia2_model(trainer.config)
        step_model.load_state_dict(recorder.initial, strict=True)
        state, step = flagship.vl3_trainer(step_model, trainer.config, seed=1)
        box = [state]
        torch.cuda.reset_peak_memory_stats()

        def one_step():
            box[0], rep = step(box[0], batch)
            float(rep["total_loss"])

        one_step()
        t1 = time.perf_counter()
        one_step()
        step_wall_ms = 1e3 * (time.perf_counter() - t1)
        step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dev_ms, by_category = _device_ms(one_step, 1)
        del state, step, step_model, box
        lines.append(
            f"  vqa2 step alone (B={PYTHIA2_B}): {step_wall_ms:.1f} ms wall, "
            f"device {dev_ms:.2f} ms (idle "
            f"{100 * max(0.0, 1 - dev_ms / step_wall_ms):.1f}%), peak "
            f"{step_peak_gb:.2f} GB, by kind (ms, launches): " + "; ".join(
                f"{c} {ms:.3f} x{n:.0f}" for c, (ms, n) in sorted(
                    by_category.items(), key=lambda kv: -kv[1][0])))
        # served: one bucket of 32 from the run's folder
        fields = ("input_ids", "input_mask", "segment_ids",
                  "image_feature_0")
        requests = [{k: batch[k][i].cpu().numpy() for k in fields}
                    for i in range(SERVE_B)]
        model = trainer.model.eval()
        trainer.teardown()
        _prune_checkpoints(save_dir)
        engine = ServingEngine.from_checkpoint(save_dir,
                                               max_batch_size=SERVE_B)
        engine.predict_many(requests)
        reset_counts()
        t0s = time.perf_counter()
        served = engine.predict_many(requests)
        bucket_ms = 1e3 * (time.perf_counter() - t0s)
        per = read_counts()
        check(per == dict(ZERO_COUNTS, flash_attention_fwd=MMF_BERT_ATTENTION,
                          layer_norm=MMF_BERT_LN),
              f"mmf_bert served launches {per}")
        add(per)
        with torch.no_grad():
            want_s = model({k: batch[k][:SERVE_B] for k in fields})[
                "scores"].float().cpu().numpy()
        got_s = np.stack([o["scores"] for o in served])
        served_rel = float(np.abs(got_s - want_s).max()
                           / np.abs(want_s).max())
        check(served_rel <= CARD_VS_CPU_RTOL, f"mmf_bert served "
              f"{served_rel}")
        small = {k: batch[k][:8] for k in fields}
        cpu_rel, _, _ = _card_vs_cpu(model, small, "scores")
        check(cpu_rel <= CARD_VS_CPU_RTOL, f"mmf_bert card vs cpu {cpu_rel}")
        lines.append(
            f"  served from the run's folder (ServingEngine.from_checkpoint) "
            f"at bucket {SERVE_B}: {bucket_ms:.1f} ms, launches {per} (exact "
            f"a forward), rel {served_rel:.2e} against the in-memory model; "
            f"card vs CPU on 8 questions rel {cpu_rel:.2e} (bound "
            f"{CARD_VS_CPU_RTOL})")
        del engine, model, trainer, recorder
        trainer = None
        seconds["vqa2"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        # masked VQA2 pretraining at B=480
        t0 = time.perf_counter()
        path, dataset, model_name = flagship.PYTHIA2["mmf_bert_masked_vqa2"]
        trainer, recorder, launches, run_s = _cli_run(
            os.path.join(tmp, "save_masked"), path, model_name, dataset, u,
            flagship.PYTHIA2_OVERRIDES["mmf_bert_masked_vqa2"] + [
                "run_type=train", *LOADER_IN_PROCESS,
                *layout_opts(tmp, "masked_vqa2", "masked_token_processor")],
            batch_size=MMF_BERT_MASKED_B)
        want = dict(ZERO_COUNTS, layer_norm=MMF_BERT_LN * u,
                    layer_norm_bwd=MMF_BERT_LN * u)
        check(launches == want, f"mmf_bert masked launches {launches}, "
              f"want {want}")
        add(launches)
        keys = ["masked_vqa2/train/masked_lm_loss",
                "masked_vqa2/train/next_sentence_loss"]
        rel, got = _steps_again(trainer, recorder, flagship.pythia2_model,
                                flagship.vl3_trainer, keys)
        t = recorder.loss_read
        lines.append(
            f"  masked_vqa2: mmf_run of {path} with "
            f"flagship.PYTHIA2_OVERRIDES, B={MMF_BERT_MASKED_B}: {u} updates, "
            + ", ".join(f"{k} {[round(x, 6) for x in got[k]]}" for k in keys)
            + f" equal to the train step's on the same batches (max rel "
            f"{rel:.3g}); launches {launches} (exact); run {run_s:.1f}s, "
            f"the last update {1e3 * (t[u] - t[u - 1]):.1f} ms")
        cfg_masked = trainer.config
        trainer.teardown()
        del trainer, recorder
        trainer = None
        seconds["masked_vqa2"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        for head, cfg in (("vqa", flagship.pythia2_config("mmf_bert_vqa2")),
                          ("pretraining", cfg_masked)):
            line, launches = _mmf_bert_compared(cfg, head, card)
            add(launches)
            lines.append(line)
        seconds["compared"] = time.perf_counter() - t0
    finally:
        if trainer is not None:
            trainer.teardown()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase mmf-bert-run: ok mmf_bert (768 wide, 8 heads of 96, f32, "
          f"{MMF_BERT_SEQ} tokens, 100 regions x 2048 through fc7 and the "
          f"shared projection) on a synthetic VQA2 layout "
          f"({PYTHIA2_SPLITS} questions, full boxes) on '{card}'; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ":")
    for line in lines:
        print(line)
    return total


def phase_multihead_run(card, root):
    """Pythia's multihead at full width (B=512: the 2048-wide question
    over the 100 regions in 8 heads of 256) and Pythia on Visual Genome
    (B=128) through mmf_run: exact launches an update and an evaluation
    forward, the losses against the train step, a multihead step's device
    time by kind, card against CPU, one served bucket of each model from
    its run's folder."""
    import glob

    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.serving import ServingEngine

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    u = PYTHIA2_UPDATES
    lines, total = [], dict(ZERO_COUNTS)
    for key, b in (("multihead", PYTHIA2_B), ("pythia_visual_genome", VG_B)):
        t0 = time.perf_counter()
        path, dataset, model_name = flagship.PYTHIA2[key]
        trainer, recorder, launches, run_s = _cli_run(
            os.path.join(root, f"save_{key}"), path, model_name, dataset, u,
            _features_opts(root, dataset) + _evaluated(u)
            + flagship.PYTHIA2_OVERRIDES[key] + [*LOADER_IN_PROCESS],
            batch_size=b)
        val = -(-CAPTION_SPLITS["val"] // b)
        forwards = 2 * val + -(-CAPTION_SPLITS["test"] // b)
        att = MULTIHEAD_ATTENTION if key == "multihead" else 0
        want = dict(ZERO_COUNTS, flash_attention_fwd=att * forwards,
                    flash_attention_fwd_stats=att * u,
                    flash_attention_bwd_dq=att * u,
                    flash_attention_bwd_dkv=att * u)
        check(launches == want, f"{key} launches {launches}, want {want}")
        for k in total:
            total[k] += launches[k]
        model = trainer.model
        if key == "multihead":
            emb = model.image_feature_embeddings_0_0
            check((model.text_dim, emb.num_heads, emb.q_proj.weight.shape[0])
                  == (2048, 8, 2048), "multihead widths")
        loss_key = f"train/{dataset}/logit_bce"
        rel, got = _steps_again(trainer, recorder, flagship.pythia2_model,
                                flagship.caption_trainer, [loss_key])
        acc = recorder.val_meters[0].meters[
            f"val/{dataset}/vqa_accuracy"].global_avg
        save_dir = trainer.config["env"]["save_dir"]
        rows = {split: len(json.load(open(f))) for split in ("val", "test")
                for f in glob.glob(os.path.join(
                    save_dir, "reports", f"{dataset}_*_{split}_*.json"))}
        check(rows == {"val": CAPTION_SPLITS["val"],
                       "test": CAPTION_SPLITS["test"]},
              f"{key} report rows {rows}")
        trainer.teardown()
        batch = recorder.batches[0]
        line = (f"  {key}: mmf_run of {path}, B={b}: {u} updates, {loss_key} "
                f"{[round(x, 6) for x in got[loss_key]]} equal to the train "
                f"step's on the same batches (max rel {rel:.3g}); launches "
                f"{launches} (exact: {att} K1-stats, K2 and K3 an update, "
                f"{att} K1 an evaluation forward); val vqa_accuracy "
                f"{acc:.4f}, report rows {rows}; run {run_s:.1f}s")
        if key == "multihead":
            cfg = trainer.config
            step_model = flagship.pythia2_model(cfg)
            step_model.load_state_dict(recorder.initial, strict=True)
            state, step = flagship.caption_trainer(step_model, cfg, seed=1)
            box = [state]
            torch.cuda.reset_peak_memory_stats()

            def one_step():
                box[0], rep = step(box[0], batch)
                float(rep["total_loss"])

            one_step()
            t1 = time.perf_counter()
            one_step()
            step_wall_ms = 1e3 * (time.perf_counter() - t1)
            step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
            dev_ms, by_category = _device_ms(one_step, 1)
            del state, step, step_model, box
            line += (f"; the step alone {step_wall_ms:.1f} ms wall, device "
                     f"{dev_ms:.2f} ms (idle "
                     f"{100 * max(0.0, 1 - dev_ms / step_wall_ms):.1f}%), "
                     f"peak {step_peak_gb:.2f} GB, by kind (ms, launches): "
                     + "; ".join(f"{c} {ms:.3f} x{n:.0f}" for c, (ms, n) in
                                 sorted(by_category.items(),
                                        key=lambda kv: -kv[1][0])))
        fields = {k: v for k, v in batch.items()
                  if k in ("text", "image_feature_0", "image_info_0")}
        small = {k: (v[:8] if torch.is_tensor(v) else
                     {kk: vv[:8] for kk, vv in v.items()})
                 for k, v in fields.items()}
        small.update(dataset_name=dataset, dataset_type="val")
        cpu_rel, _, _ = _card_vs_cpu(model, small, "scores")
        check(cpu_rel <= CARD_VS_CPU_RTOL, f"{key} card vs cpu {cpu_rel}")
        _prune_checkpoints(save_dir)
        engine = ServingEngine.from_checkpoint(save_dir,
                                               max_batch_size=SERVE_B)
        requests = [{k: ({kk: vv[i].cpu().numpy() for kk, vv in v.items()}
                         if isinstance(v, dict) else v[i].cpu().numpy())
                     for k, v in fields.items()} for i in range(SERVE_B)]
        engine.predict_many(requests)
        reset_counts()
        t1 = time.perf_counter()
        served = engine.predict_many(requests)
        bucket_ms = 1e3 * (time.perf_counter() - t1)
        per = read_counts()
        check(per == dict(ZERO_COUNTS, flash_attention_fwd=att),
              f"{key} served launches {per}")
        for k in total:
            total[k] += per[k]
        with torch.no_grad():
            model.eval()
            want_s = model({k: (v[:SERVE_B] if torch.is_tensor(v) else
                                {kk: vv[:SERVE_B] for kk, vv in v.items()})
                            for k, v in fields.items()})["scores"].float(
                                ).cpu().numpy()
        got_s = np.stack([o["scores"] for o in served])
        served_rel = float(np.abs(got_s - want_s).max()
                           / np.abs(want_s).max())
        check(served_rel <= CARD_VS_CPU_RTOL, f"{key} served {served_rel}")
        line += (f"; card vs CPU on 8 questions rel {cpu_rel:.2e} (bound "
                 f"{CARD_VS_CPU_RTOL}); served from the run's folder at "
                 f"bucket {SERVE_B}: {bucket_ms:.1f} ms, launches {per} "
                 f"(exact a forward), rel {served_rel:.2e} against the "
                 f"in-memory model; {time.perf_counter() - t0:.1f}s")
        lines.append(line)
        del engine, model, trainer, recorder, batch
        torch.cuda.empty_cache()
    print(f"phase multihead-run: ok multihead (the 2048-wide question over "
          "100 regions x 2048 through fc7, 8 heads of 256, combine 1000 "
          "wide, 3129 answers, f32) and Pythia on Visual Genome (the same "
          "questions under visual_genome's config tree) through mmf_run on "
          f"the caption layout on '{card}':")
    for line in lines:
        print(line)
    return total


# LoRRA, BAN and CNN-LSTM at full width: the configs' batches, 2 updates
# each (LoRRA on VizWiz, the cut depth: 1 update of 128)
LORRA_BAN_UPDATES = 2
LORRA_BAN_B = {"lorra_vqa2": 512, "ban_vqa2": 512, "lorra_vizwiz": 128,
               "lorra_textvqa": 128, "cnn_lstm_hateful_memes": 480}
# the fields each model reads, which a served request carries (LoRRA's
# string context_tokens stay out: neither engine stacks a list of strings)
SERVED_FIELDS = {
    "lorra": ("text", "image_feature_0", "image_info_0", "image_feature_1",
              "image_info_1", "context_feature_0", "context_info_0",
              "order_vectors"),
    "ban": ("text", "image_feature_0"),
    "cnn_lstm": ("text", "image"),
}
LORRA_TEXTVQA_SPLITS = {"train": 256, "val": 128, "test": 128}
CNN_LSTM_SPLITS = {"train": 960, "val": 96, "test": 96}


@contextlib.contextmanager
def _fasttext_stand_in():
    """wiki.en.bin's seeded stand-in for the OCR tokens' vectors (the
    ``fasttext`` package and the file are not on the card's machine)."""
    from mmf_tpu_torch.datasets.processors import processors as P
    from tests.torch_textvqa_layout import FastTextStandIn

    load = P.FastTextProcessor._load_fasttext_model

    def stand_in(self, model_file):
        self.model = FastTextStandIn()

    P.FastTextProcessor._load_fasttext_model = stand_in
    try:
        yield
    finally:
        P.FastTextProcessor._load_fasttext_model = load


def _lorra_ban_case(card, key, root, opts, splits, profile=True,
                    evaluate=True):
    """One ``flagship.LORRA_BAN`` config through mmf_run on the card at
    its batch (``LORRA_BAN_B``): no hand-written kernel launched (the run,
    the served bucket), the losses against the train step alone on the
    same batches, with ``evaluate`` a validation and the report rows, the
    step alone's device time by kind (``profile``), card against CPU on 8
    samples, the run's folder served at bucket 32 against the CPU
    forward. A line of its figures."""
    import glob

    from mmf_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    path, dataset, model_name = flagship.LORRA_BAN[key]
    b = LORRA_BAN_B[key]
    u = 1 if key == "lorra_vizwiz" else LORRA_BAN_UPDATES
    trainer, recorder, launches, run_s = _cli_run(
        os.path.join(root, f"save_{key}"), path, model_name, dataset, u,
        opts + (_evaluated(u) if evaluate else ["run_type=train"])
        + flagship.LORRA_BAN_OVERRIDES[key] + [*LOADER_IN_PROCESS],
        batch_size=b)
    check(launches == ZERO_COUNTS, f"{key} launches {launches}")
    loss_key = [k for k in trainer.meter.meters if k.startswith("train/")
                and not k.endswith("total_loss")]
    check(len(loss_key) == 1, f"{key} losses {loss_key}")
    loss_key = loss_key[0]
    rel, got = _steps_again(trainer, recorder, flagship.lorra_ban_model,
                            flagship.caption_trainer, [loss_key])
    save_dir = trainer.config["env"]["save_dir"]
    ext = "csv" if dataset == "hateful_memes" else "json"
    rows, metric = {}, {}
    for split in ("val", "test") if evaluate else ():
        for f in glob.glob(os.path.join(save_dir, "reports",
                                        f"{dataset}_*_{split}_*.{ext}")):
            with open(f) as fh:
                rows[split] = (len(fh.readlines()) - 1 if ext == "csv"
                               else len(json.load(fh)))
    if evaluate:
        check(rows == {"val": splits["val"], "test": splits["test"]},
              f"{key} report rows {rows}")
        metric = {k: m.global_avg for k, m in
                  recorder.val_meters[0].meters.items()
                  if k.startswith("val/") and "loss" not in k}
    model = trainer.model
    trainer.teardown()
    batch = recorder.batches[0]
    line = (f"  {key}: mmf_run of {path}, B={b}: {u} update(s), {loss_key} "
            f"{[round(x, 6) for x in got[loss_key]]} equal to the train "
            f"step's on the same batches (max rel {rel:.3g}, bound "
            f"{RUN_LOSS_RTOL}); launches: none; "
            + (("val " + ", ".join(f"{k} {v:.4f}" for k, v in metric.items())
                + f"; report rows {rows}") if evaluate else
               "no evaluation (VizWiz's run evaluates LoRRA's copies)")
            + f"; run {run_s:.1f}s")
    if profile:
        cfg = trainer.config
        step_model = flagship.lorra_ban_model(cfg)
        step_model.load_state_dict(recorder.initial, strict=True)
        state, step = flagship.caption_trainer(step_model, cfg, seed=1,
                                               device=DEV)
        box = [state]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def one_step():
            box[0], rep = step(box[0], batch)
            float(rep["total_loss"])

        one_step()
        t1 = time.perf_counter()
        one_step()
        step_wall_ms = 1e3 * (time.perf_counter() - t1)
        step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reset_counts()
        dev_ms, by_category = _device_ms(one_step, 1)
        check(read_counts() == ZERO_COUNTS, f"{key} step launches")
        del state, step, step_model, box
        line += (f"; the step alone {step_wall_ms:.1f} ms wall, device "
                 f"{dev_ms:.2f} ms (idle "
                 f"{100 * max(0.0, 1 - dev_ms / step_wall_ms):.1f}%), peak "
                 f"{step_peak_gb:.2f} GB, by kind (ms, launches): "
                 + "; ".join(f"{c} {ms:.3f} x{n:.0f}" for c, (ms, n) in
                             sorted(by_category.items(),
                                    key=lambda kv: -kv[1][0])))
    fields = {k: v for k, v in batch.items()
              if k in SERVED_FIELDS[model_name]}
    small = {k: (v[:8] if torch.is_tensor(v) else
                 {kk: vv[:8] for kk, vv in v.items()})
             for k, v in fields.items()}
    small.update(dataset_name=dataset, dataset_type="val")
    cpu_rel, _, _ = _card_vs_cpu(model, small, "scores")
    check(cpu_rel <= CARD_VS_CPU_RTOL, f"{key} card vs cpu {cpu_rel}")
    _prune_checkpoints(save_dir)
    engine = ServingEngine.from_checkpoint(save_dir, max_batch_size=SERVE_B)
    requests = [{k: ({kk: vv[i].cpu().numpy() for kk, vv in v.items()}
                     if isinstance(v, dict) else v[i].cpu().numpy())
                 for k, v in fields.items()} for i in range(SERVE_B)]
    engine.predict_many(requests)
    reset_counts()
    t1 = time.perf_counter()
    served = engine.predict_many(requests)
    bucket_ms = 1e3 * (time.perf_counter() - t1)
    per = read_counts()
    check(per == ZERO_COUNTS, f"{key} served launches {per}")
    cpu = copy.deepcopy(model).to("cpu").eval()
    with torch.no_grad():
        want = cpu(train_state._to_device(
            {k: (v[:SERVE_B] if torch.is_tensor(v) else
                 {kk: vv[:SERVE_B] for kk, vv in v.items()})
             for k, v in fields.items()}, torch.device("cpu")))[
                 "scores"].float().numpy()
    got_s = np.stack([o["scores"] for o in served])
    served_rel = float(np.abs(got_s - want).max() / np.abs(want).max())
    check(np.isfinite(got_s).all() and served_rel <= CARD_VS_CPU_RTOL,
          f"{key} served {served_rel}")
    line += (f"; card vs CPU on 8 samples rel {cpu_rel:.2e} (bound "
             f"{CARD_VS_CPU_RTOL}); served from the run's folder at bucket "
             f"{SERVE_B}: {bucket_ms:.1f} ms, launches: none, rel "
             f"{served_rel:.2e} against the CPU forward; "
             f"{time.perf_counter() - t0:.1f}s on '{card}'")
    del engine, model, trainer, recorder, batch, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return line


def phase_lorra_ban_run(card, root):
    """LoRRA (B=512: two feature sets, fc7 and the ResNet stand-in, and
    the OCR context of 50 FastText vectors with order vectors; the soft
    copy's 3129 + 50 answers) and BAN (B=512: a GRU of 1280, 4 glimpses of
    k 3 over 100 regions x 14 words) on VQA2, and LoRRA on VizWiz at the
    cut depth, through mmf_run on the caption layout (its questions' OCR
    tokens, its VizWiz copy)."""
    from mmf_tpu_torch.common.registry import registry

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    lines = []
    with _fasttext_stand_in():
        for key in ("lorra_vqa2", "ban_vqa2", "lorra_vizwiz"):
            dataset = flagship.LORRA_BAN[key][1]
            opts = _features_opts(root, dataset)
            if key == "lorra_vqa2":  # the second set stands for ResNet's
                opts = [f"env.data_dir={root}"] + [
                    f"dataset_config.vqa2.features.{split}=['coco/defaults/"
                    f"features/{folder},coco/defaults/features/{folder}']"
                    for split, folder in (("train", "trainval2014"),
                                          ("val", "trainval2014"),
                                          ("test", "test2015"))]
            lines.append(_lorra_ban_case(card, key, root, opts,
                                         CAPTION_SPLITS,
                                         profile=key != "lorra_vizwiz",
                                         evaluate=key == "lorra_vizwiz"))
    print("phase lorra-ban-run: ok LoRRA (the combine and classifier 5000 "
          "wide, the question 2048, the context branch's sigmoid attention "
          "over 50 OCR tokens) and BAN at full width through mmf_run, f32, "
          "no hand-written kernel on these paths:")
    for line in lines:
        print(line)
    return dict(ZERO_COUNTS)


def phase_lorra_textvqa(card):
    """LoRRA on TextVQA (B=128) through mmf_run on a TextVQA layout of its
    own, with ``flagship.LORRA_BAN_OVERRIDES`` (the soft-copy answers)."""
    from mmf_tpu_torch.common.registry import registry
    from tests.torch_textvqa_layout import layout_opts, write_layout

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lorra_textvqa_")
    try:
        t0 = time.perf_counter()
        write_layout(tmp, n_train=LORRA_TEXTVQA_SPLITS["train"],
                     n_val=LORRA_TEXTVQA_SPLITS["val"],
                     n_test=LORRA_TEXTVQA_SPLITS["test"], n_images=64)
        layout_s = time.perf_counter() - t0
        with _fasttext_stand_in():
            line = _lorra_ban_case(card, "lorra_textvqa", tmp,
                                   layout_opts(tmp), LORRA_TEXTVQA_SPLITS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase lorra-textvqa: ok LoRRA on TextVQA at full width (5000 "
          f"answers + 50 OCR copies; layout written in {layout_s:.1f}s):")
    print(line)
    return dict(ZERO_COUNTS)


def phase_cnn_lstm_run(card):
    """CNN-LSTM on Hateful Memes (B=480, 224 px memes through six
    ConvNets, the bidirectional LSTM of 50) through mmf_run on a Hateful
    Memes layout of its own; its vocabulary size from the layout's
    (``flagship.text_vocab_size``)."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import Configuration
    from tests.torch_hm_layout import layout_opts, write_layout

    registry.register_callback("chip_smoke_recorder")(_StepRecorder)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cnn_lstm_")
    key = "cnn_lstm_hateful_memes"
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        t0 = time.perf_counter()
        write_layout(tmp, n_train=CNN_LSTM_SPLITS["train"],
                     n_val=CNN_LSTM_SPLITS["val"],
                     n_test=CNN_LSTM_SPLITS["test"], n_images=32)
        layout_s = time.perf_counter() - t0
        path, dataset, model = flagship.LORRA_BAN[key]
        opts = layout_opts(tmp, False)
        words = flagship.text_vocab_size(Configuration(
            [f"config={path}", f"model={model}", f"dataset={dataset}"]
            + opts).get_config())
        # the convolutions in f32, as JAX computes them (cuDNN's default
        # rounds their inputs to TF32: 9.5e-4 from the CPU's forward)
        torch.backends.cudnn.allow_tf32 = False
        line = _lorra_ban_case(
            card, key, tmp,
            opts + [f"model_config.cnn_lstm.text_vocab_size={words}"],
            CNN_LSTM_SPLITS)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase cnn-lstm-run: ok CNN-LSTM on Hateful Memes at full width "
          f"({words} words; cuDNN's convolutions in f32, TF32 off; layout "
          f"written in {layout_s:.1f}s):")
    print(line)
    return dict(ZERO_COUNTS)


def phase_ln_bwd_shapes(card, record):
    """K4-bwd at every (rows, hidden, dtype, residual) the main paths'
    optimizer steps ran it at (``LnBwdRecord``), each checked and timed
    by ``_ln_bwd_shape_case``; the phases and their steps' calls beside
    it."""
    g = torch.Generator(device=DEV).manual_seed(18)
    shapes = record.shapes()
    check(shapes, "no K4-bwd call was recorded on the main paths")
    rows = {}
    for key in sorted(shapes, key=lambda k: (k[1], k[2], k[0], k[3])):
        r = _ln_bwd_shape_case(g, *key)
        r["steps"] = [{"phase": ph, "steps": n, "calls_a_step": c}
                      for ph, n, c in shapes[key]]
        rows[r["form"]] = r
    print(f"phase ln-bwd-shapes: ok K4-bwd at the {len(rows)} shapes the "
          "main paths' optimizer steps ran it at, each against its plain "
          f"backward (dx {LN_DX_REL[torch.float32]} f32 / "
          f"{LN_DX_REL[torch.bfloat16]} bf16 and f16, dscale and dbias "
          f"{LN_PARAM_REL} of the largest entry), bit-equal across two "
          "calls, device ms over rotating input sets beside F.layer_norm's "
          "backward, the byte bound and host us a call, and K4 (the "
          f"forward) beside F.layer_norm, on '{card}' (phase: steps x calls "
          "a step):")
    for form, r in rows.items():
        print(f"  {form}: max_abs_err {r['max_abs_err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, F.layer_norm backward "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']} (kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.0f}%), host "
              f"{r['host_us']:.1f} us; K4 forward {r['K4']['ms']:.4f} "
              f"(F.layer_norm {r['K4']['library_ms']:.4f}, bound "
              f"{r['K4']['bound_ms']:.4f}); " + ", ".join(
                  f"{s['phase']}: {s['steps']} x {s['calls_a_step']}"
                  for s in r["steps"]))
    return rows


SOURCES = {  # name -> (route, source, the TPU kernel it replaces)
    "flash_attention_fwd": ("cuda",
                            "mmf_tpu_torch/ops/csrc/flash_attention_fwd.cu",
                            "mmf_tpu/ops/attention.py:114"),
    "flash_attention_fwd_stats": (
        "cuda", "mmf_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "mmf_tpu/ops/attention.py:114"),
    "flash_attention_fwd_raw": (
        "cuda", "mmf_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "mmf_tpu/ops/attention.py:168"),
    "flash_attention_bwd_dq": (
        "cuda", "mmf_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "mmf_tpu/ops/attention.py:372"),
    "flash_attention_bwd_dkv": (
        "cuda", "mmf_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "mmf_tpu/ops/attention.py:419"),
    "layer_norm": ("triton", "mmf_tpu_torch/ops/layernorm_triton.py",
                   "mmf_tpu/ops/layernorm.py:81"),
    # JAX's backward is the VJP of _ln_reference (no Pallas kernel)
    "layer_norm_bwd": ("cuda", "mmf_tpu_torch/ops/csrc/layer_norm_bwd.cu",
                       "mmf_tpu/ops/layernorm.py:157"),
    "int8_dequant_gemm": ("cuda", "mmf_tpu_torch/ops/csrc/int8_gemm.cu",
                          "mmf_tpu/ops/quant.py:71"),
}


LIBRARY = {  # name -> the PyTorch call timed as its library_ms
    "flash_attention_fwd": "F.scaled_dot_product_attention",
    "flash_attention_fwd_stats": (
        "aten._scaled_dot_product_efficient_attention with "
        "compute_log_sumexp (output and the rows' m + log l)"),
    "flash_attention_fwd_raw": (
        "none: no PyTorch call returns the unnormalized state (K1-raw's "
        "ms is device_ms)"),
    "flash_attention_bwd_dq": (
        "F.scaled_dot_product_attention backward: dq, dk, dv together "
        "(K2 + K3 combined); K2, K3 and it timed by device_ms, CUDA "
        "events over back-to-back calls beside them"),
    "flash_attention_bwd_dkv": (
        "F.scaled_dot_product_attention backward: dq, dk, dv together "
        "(K2 + K3 combined); K2, K3 and it timed by device_ms, CUDA "
        "events over back-to-back calls beside them"),
    "layer_norm": ("F.layer_norm after the residual add, weights in bf16 "
                   "(device_ms over rotating input sets, as K4's ms); "
                   "every form under 'forms'"),
    "layer_norm_bwd": ("F.layer_norm's backward (dx, dweight, dbias) after "
                       "the residual add, weights in bf16 (device_ms over "
                       "rotating input sets, as K4-bwd's ms); plain_vjp_ms "
                       "is the backward before K4-bwd, autograd's VJP of "
                       "the plain forward; every form under 'forms'"),
    "int8_dequant_gemm": ("torch._int_mm on the same operands: the int32 "
                          "product alone, no dequantising epilogue (K5's "
                          "times are device_ms: calls queued behind a "
                          "spin kernel)"),
}


# K4-bwd's shapes on the main paths, recorded from the build to the last
# training phase (main)
LN_BWD_RECORD = LnBwdRecord()


# each phase's seconds, in order (timed), summed in a line before the
# kernels' JSON line
PHASE_SECONDS = {}


def timed(fn, *args):
    """``fn(*args)``, and a line with the phase's seconds; K4-bwd's calls
    on the way are filed under the phase (``LN_BWD_RECORD``)."""
    name = fn.__name__[len("phase_"):]
    LN_BWD_RECORD.set_phase(name)
    t0 = time.perf_counter()
    gc.collect()  # what the last phase left in reference cycles
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        print(f"phase-seconds {name}: {PHASE_SECONDS[name]:.1f}",
              flush=True)


def main():
    card = card_line()
    LN_BWD_RECORD.start()
    timed(phase_build, card)
    results = timed(phase_kernels, card)
    served, serving = timed(phase_serving, card)
    trained, training = timed(phase_training, card)
    mmbt = timed(phase_mmbt, card)
    vb_int8, k5_vb_ms = timed(phase_vb_int8, card, serving)
    pretrained = timed(phase_pretrain, card)
    served_ckpt = timed(phase_serve_ckpt, card, training)
    mmf_run = timed(phase_mmf_run, card, training)
    vilbert_rows = timed(phase_vilbert_kernels, card)
    vilbert = [timed(phase_vilbert_serving, card),
               timed(phase_vilbert_training, card),
               timed(phase_vilbert_runs, card)]
    vilt_att, vilt_raw, vilt_ln, vilt_ln_bwd = timed(phase_vilt_kernels,
                                                     card)
    vilt = [timed(phase_vilt_serving, card), timed(phase_vilt_training, card),
            timed(phase_vilt_run, card)]
    mmft_att = timed(phase_mmft_kernels, card)
    vilt.append(timed(phase_mmft_run, card))
    hm_att, hm_raw = timed(phase_hm_kernels, card)
    hm = [timed(phase_hm_mmbt_run, card), timed(phase_hm_baselines, card)]
    m4c_att, m4c_raw = timed(phase_m4c_kernels, card)
    m4c_run, textvqa_served = timed(phase_m4c_run, card)
    hm.append(m4c_run)
    family_root = None
    try:
        family, captioner_served, family_root = timed(phase_m4c_family, card)
        served_m4c, decode_rows = timed(phase_m4c_serve, card, {
            "textvqa": textvqa_served, "textcaps": captioner_served})
    finally:
        shutil.rmtree(textvqa_served[0], ignore_errors=True)
        if family_root is not None:
            shutil.rmtree(family_root, ignore_errors=True)
    hm += [family, served_m4c]
    vl3_att, vl3_raw, vl3_ln = timed(phase_vl3_kernels, card)
    hm.append(timed(phase_vl3_runs, card))
    caption_root = timed(phase_caption_layout, card)
    try:
        hm.append(timed(phase_butd_run, card, caption_root))
        hm.append(timed(phase_pythia_run, card, caption_root))
        hm.append(timed(phase_multihead_run, card, caption_root))
        hm.append(timed(phase_lorra_ban_run, card, caption_root))
    finally:
        shutil.rmtree(caption_root, ignore_errors=True)
    hm.append(timed(phase_m4c_coco_joint, card))
    pythia2_att = timed(phase_pythia2_kernels, card)
    hm.append(timed(phase_mmf_bert_run, card))
    hm.append(timed(phase_lorra_textvqa, card))
    hm.append(timed(phase_cnn_lstm_run, card))
    LN_BWD_RECORD.stop()
    results["layer_norm_bwd"]["recorded_shapes"] = timed(
        phase_ln_bwd_shapes, card, LN_BWD_RECORD)
    # K1 at the served M4C decode's buckets
    results["flash_attention_fwd"]["m4c_served_decode"] = decode_rows
    results["int8_dequant_gemm"]["vb_int8_forward_ms"] = k5_vb_ms
    # the attention kernels at ViLBERT's shapes (D = 128, Sq != Skv)
    short = {"flash_attention_fwd": "K1", "flash_attention_fwd_stats":
             "K1-stats", "flash_attention_bwd_dq": "K2",
             "flash_attention_bwd_dkv": "K3"}
    for name, kid in short.items():
        lib = "K2+K3" if kid in ("K2", "K3") else kid
        results[name]["vilbert_shapes"] = {
            shape: {"shape": r["shape"],
                    "max_abs_err": r["max_abs_err"][kid],
                    "ms": r["ms"][kid], "host_us": r["host_us"][kid],
                    "plain_ms": r["plain_ms"][lib],
                    "bound_ms": r["bound_ms"][kid],
                    "bound_by": r["bound_by"][kid],
                    "library_ms": r["library_ms"][lib]}
            for shape, r in vilbert_rows.items()}
        # and in f32 at ViLT's [64, 12, 617, 64]
        results[name]["vilt_shape"] = {
            "shape": vilt_att["shape"], "dtype": "float32",
            "max_abs_err": vilt_att["max_abs_err"][kid],
            "ms": vilt_att["ms"][kid], "host_us": vilt_att["host_us"][kid],
            "plain_ms": vilt_att["plain_ms"][lib],
            "bound_ms": vilt_att["bound_ms"][kid],
            "bound_by": vilt_att["bound_by"][kid],
            "fma_bound_ms": vilt_att["fma_bound_ms"][kid],
            "library_ms": vilt_att["library_ms"][lib]}
        # and at Hateful Memes': MMBT's bf16 [32, 12, 131, 64], the
        # baselines' f32 [64, 12, 128, 64]
        results[name]["hateful_memes_shapes"] = {
            label: {"shape": r["shape"],
                    "dtype": "bfloat16" if label == "mmbt" else "float32",
                    "max_abs_err": r["max_abs_err"][kid],
                    "ms": r["ms"][kid], "host_us": r["host_us"][kid],
                    "plain_ms": r["plain_ms"][lib],
                    "bound_ms": r["bound_ms"][kid],
                    "bound_by": r["bound_by"][kid],
                    "library_ms": r["library_ms"][lib]}
            for label, r in hm_att.items()}
        # and in f32 at M4C's: TextBert, the training pass, the prefill
        # and the cached decode
        results[name]["m4c_shapes"] = {
            case: {"shape": r["shape"], "dtype": "float32",
                   "max_abs_err": r["max_abs_err"][kid],
                   "ms": r["ms"][kid], "host_us": r["host_us"][kid],
                   "plain_ms": r["plain_ms"][lib],
                   "bound_ms": r["bound_ms"][kid],
                   "bound_by": r["bound_by"][kid],
                   "fma_bound_ms": r["fma_bound_ms"][kid],
                   "library_ms": r["library_ms"][lib]}
            for case, r in m4c_att.items()}
        # and in bf16 at MMFT's [64, 12, 114, 64]
        results[name]["mmft_shape"] = {
            "shape": mmft_att["shape"], "dtype": "bfloat16",
            "max_abs_err": mmft_att["max_abs_err"][kid],
            "ms": mmft_att["ms"][kid], "host_us": mmft_att["host_us"][kid],
            "plain_ms": mmft_att["plain_ms"][lib],
            "bound_ms": mmft_att["bound_ms"][kid],
            "bound_by": mmft_att["bound_by"][kid],
            "library_ms": mmft_att["library_ms"][lib]}
    # and in f32 at UNITER's, VinVL's and LXMERT's
    for name, kid in short.items():
        lib = "K2+K3" if kid in ("K2", "K3") else kid
        results[name]["vl3_shapes"] = {
            label: {"shape": r["shape"], "dtype": "float32",
                    "max_abs_err": r["max_abs_err"][kid],
                    "ms": r["ms"][kid], "host_us": r["host_us"][kid],
                    "plain_ms": r["plain_ms"][lib],
                    "bound_ms": r["bound_ms"][kid],
                    "bound_by": r["bound_by"][kid],
                    "fma_bound_ms": r["fma_bound_ms"][kid],
                    "library_ms": r["library_ms"][lib]}
            for label, r in vl3_att.items()}
    # and in f32 at mmf_bert's (D = 96) and multihead's (D = 256)
    for name, kid in short.items():
        lib = "K2+K3" if kid in ("K2", "K3") else kid
        results[name]["pythia2_shapes"] = {
            label: {"shape": r["shape"], "dtype": "float32",
                    "max_abs_err": r["max_abs_err"][kid],
                    "ms": r["ms"][kid], "host_us": r["host_us"][kid],
                    "plain_ms": r["plain_ms"][lib],
                    "bound_ms": r["bound_ms"][kid],
                    "bound_by": r["bound_by"][kid],
                    "fma_bound_ms": r["fma_bound_ms"][kid],
                    "library_ms": r["library_ms"][lib],
                    "library_backend": r["sdpa_backend"]}
            for label, r in pythia2_att.items()}
    results["flash_attention_fwd_raw"]["vl3_shapes"] = {
        label: dict(r, shape=vl3_att[label]["shape"], dtype="float32")
        for label, r in vl3_raw.items()}
    for name, kid in (("layer_norm", "K4"), ("layer_norm_bwd", "K4-bwd")):
        results[name]["vl3_forms"] = {
            f"float32 [{r['rows']}, {HIDDEN}] residual ({label})": r[kid]
            for label, r in vl3_ln.items()}
    results["flash_attention_fwd_raw"]["vilt_shape"] = dict(
        vilt_raw, shape=vilt_att["shape"], dtype="float32")
    results["flash_attention_fwd_raw"]["hateful_memes_shapes"] = {
        label: dict(r, shape=hm_att[label]["shape"],
                    dtype="bfloat16" if label == "mmbt" else "float32")
        for label, r in hm_raw.items()}
    results["flash_attention_fwd_raw"]["m4c_shapes"] = {
        case: dict(r, shape=m4c_att[case]["shape"], dtype="float32")
        for case, r in m4c_raw.items()}
    results["layer_norm"]["vilt_form"] = dict(
        vilt_ln, form=f"float32 [{VILT_ROWS}, {HIDDEN}] no residual")
    results["layer_norm_bwd"]["vilt_form"] = dict(
        vilt_ln_bwd, form=f"float32 [{VILT_ROWS}, {HIDDEN}] no residual")
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            # launches on the paths that run the kernel: serving (K1
            # inference form, K4), training and pretraining (K1 stats
            # form, K2, K3, K4, K4-bwd), MMBT-grid at batch 1 (K1, K4, K5
            # under int8), VisualBERT under int8 (K1, K4, K5), the
            # served checkpoint (K1, K4; K5 under int8), mmf_run (the
            # training path's kernels, and K1 and K4 in evaluation),
            # ViLBERT's serving, training, mmf_run and mmf_serve, ViLT's
            # serving, training, pretraining, mmf_run and mmf_serve,
            # MMFT's mmf_run and mmf_serve, the Hateful Memes runs
            # (MMBT and the baselines), M4C's mmf_run on TextVQA, the rest
            # of the M4C family's (the captioner's compared steps
            # included), the served M4C checkpoints, and UNITER's,
            # LXMERT's and VinVL's mmf_run, compared steps and mmf_serve,
            # the joint TextCaps + COCO captioner's run and compared
            # step (BUTD and Pythia run none), multihead's mmf_run and
            # served bucket, mmf_bert's mmf_runs, served bucket and
            # compared steps (LoRRA, BAN and CNN-LSTM run none)
            "launches": (served[name] + trained[name] + mmbt[name]
                         + vb_int8[name] + pretrained[name]
                         + served_ckpt[name] + mmf_run[name]
                         + sum(v[name] for v in vilbert)
                         + sum(v[name] for v in vilt)
                         + sum(v[name] for v in hm)),
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # one PyTorch call computing the same function: LIBRARY says
            # which
            "library_ms": r["library_ms"], "library": LIBRARY[name],
            **{k: r[k] for k in ("events_ms", "library_events_ms", "host_us",
                                 "vb_int8_forward_ms", "plain_vjp_ms",
                                 "forms", "vilbert_shapes", "vilt_shape",
                                 "mmft_shape", "hateful_memes_shapes",
                                 "m4c_shapes", "m4c_served_decode",
                                 "vilt_form", "vl3_shapes", "vl3_forms",
                                 "pythia2_shapes", "recorded_shapes")
               if k in r},
        })
    print("phase-seconds, all: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; total {sum(PHASE_SECONDS.values()):.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
