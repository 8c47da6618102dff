"""The port stands alone: importing it, and running ``mmf_run`` on the
CPU, never imports JAX, the JAX package or what the card's machine
lacks (transformers, PIL, omegaconf, lmdb), and its kernel entry points
refuse CPU tensors instead of quietly running the plain version."""

import json
import os
import subprocess
import sys

import pytest
import torch

SLICE_MODULES = [
    "mmf_tpu_torch",
    "mmf_tpu_torch.common.registry",
    "mmf_tpu_torch.config.omega",
    "mmf_tpu_torch.config.configuration",
    "mmf_tpu_torch.utils.env",
    "mmf_tpu_torch.utils.checkpoint_updater",
    "mmf_tpu_torch.utils.flagship",
    "mmf_tpu_torch.ops._build",
    "mmf_tpu_torch.ops.attention",
    "mmf_tpu_torch.ops.layernorm",
    "mmf_tpu_torch.ops.quant",
    "mmf_tpu_torch.modules.transformer",
    "mmf_tpu_torch.models.base_model",
    "mmf_tpu_torch.models.visual_bert",
    "mmf_tpu_torch.modules.resnet",
    "mmf_tpu_torch.modules.encoders",
    "mmf_tpu_torch.models.mmbt",
    "mmf_tpu_torch.modules.losses",
    "mmf_tpu_torch.modules.optimizers",
    "mmf_tpu_torch.modules.schedulers",
    "mmf_tpu_torch.trainers.core.train_state",
    "mmf_tpu_torch.utils.general",
    "mmf_tpu_torch.utils.modeling",
    "mmf_tpu_torch.serving",
    "mmf_tpu_torch.serving.batcher",
    "mmf_tpu_torch.serving.engine",
    "mmf_tpu_torch.serving.server",
    "mmf_tpu_torch.cli.serve",
    "mmf_tpu_torch.utils.checkpoint",
    "mmf_tpu_torch.utils.distributed",
    "mmf_tpu_torch.utils.inference",
    "mmf_tpu_torch.common.sample",
    "mmf_tpu_torch.common.report",
    "mmf_tpu_torch.common.meter",
    "mmf_tpu_torch.common.test_reporter",
    "mmf_tpu_torch.datasets.loader",
    "mmf_tpu_torch.datasets.multi_datamodule",
    "mmf_tpu_torch.datasets.builders.vqa2.builder",
    "mmf_tpu_torch.datasets.processors.bert_processors",
    "mmf_tpu_torch.modules.metrics",
    "mmf_tpu_torch.trainers.mmf_trainer",
    "mmf_tpu_torch.cli.run",
    "mmf_tpu_torch.cli.predict",
    "mmf_tpu_torch.models.transformers.base",
    "mmf_tpu_torch.models.transformers.heads.heads",
    "mmf_tpu_torch.modules.ot",
    "mmf_tpu_torch.modules.vit",
    "mmf_tpu_torch.models.vilt",
    "mmf_tpu_torch.models.mmf_transformer",
    "mmf_tpu_torch.datasets.databases.image_database",
    "mmf_tpu_torch.datasets.processors.image_processors",
    "mmf_tpu_torch.utils.native.build",
    "mmf_tpu_torch.utils.native.lmdb_shim",
    "mmf_tpu_torch.utils.phoc.build_phoc",
    "mmf_tpu_torch.datasets.databases.readers.feature_readers",
    "mmf_tpu_torch.datasets.processors.processors",
    "mmf_tpu_torch.datasets.builders.textvqa.builder",
    "mmf_tpu_torch.datasets.builders.textvqa.dataset",
    "mmf_tpu_torch.modules.embeddings",
    "mmf_tpu_torch.utils.m4c_evaluators",
    "mmf_tpu_torch.models.m4c",
]

_PROBE = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module(name)
from mmf_tpu_torch.utils.flagship import mmbt_grid, visual_bert
model = visual_bert({{"num_hidden_layers": 1, "hidden_size": 32,
                     "num_attention_heads": 4, "intermediate_size": 64,
                     "visual_embedding_dim": 8, "quant": "int8"}})
model = mmbt_grid({{"quant": "int8", "text_encoder": {{"params": {{
    "num_hidden_layers": 1, "hidden_size": 32, "num_attention_heads": 4,
    "intermediate_size": 64}}}}}})
import tempfile
from tests.torch_vqa2_layout import layout_opts, write_layout
from mmf_tpu_torch.cli.run import run
root = tempfile.mkdtemp()
write_layout(root, n_train=8, n_val=4, n_test=4, n_images=5, regions=4,
             feature_dim=8, num_answers=4, vocab_size=64)
run(["config=projects/visual_bert/configs/vqa2/defaults.yaml",
     "model=visual_bert", "dataset=vqa2", "training.device=cpu",
     "env.save_dir=" + root + "/save", "training.batch_size=4",
     "training.max_updates=2", "training.evaluation_interval=2",
     "training.num_workers=0", "run_type=train_val",
     "dataset_config.vqa2.max_features=4",
     "dataset_config.vqa2.processors.text_processor.params.max_seq_length=8"]
    + layout_opts(root) + [
     "model_config.visual_bert." + kv for kv in (
         "vocab_size=64", "hidden_size=16", "num_hidden_layers=1",
         "num_attention_heads=2", "intermediate_size=32",
         "visual_embedding_dim=8", "max_position_embeddings=16",
         "num_labels=4", "dtype=float32")])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "mmf_tpu", "transformers",
                                    "PIL", "omegaconf", "lmdb"))
print(json.dumps(bad))
"""


def test_port_never_imports_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=SLICE_MODULES)],
        capture_output=True, text=True, env=env, cwd=repo, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no
    result line (never a CPU stand-in for a card run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would really run")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "chip_smoke.py")],
        capture_output=True, text=True, cwd=repo, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_attention_ab_fails_without_a_card():
    """The kernels' A/B timing script, like chip_smoke.py, exits non-zero
    without CUDA and times nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: attention_ab.py would really run")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "attention_ab.py")],
        capture_output=True, text=True, cwd=repo, timeout=120,
    )
    assert proc.returncode != 0
    assert "attention_ab: ok" not in proc.stdout


def test_attention_ab_names_each_other_tree():
    """Each tree the A/B script times beside this checkout gets its own
    arm, named by its directory, never "this"."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import attention_ab
    finally:
        sys.path.remove(repo)
    assert attention_ab.arm_names(
        ["a/parent", "b/parent/", "c/this", "probe"]) == [
        "parent", "parent-2", "this-2", "probe"]


def test_kernel_entries_refuse_cpu_tensors():
    from mmf_tpu_torch.ops import attention, layernorm, quant

    q = torch.zeros(1, 2, 8, 8)
    before = attention.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        attention.flash_attention(q, q, q)
    assert attention.flash_attention.launches == before

    x = torch.zeros(4, 16)
    before = layernorm.layer_norm_kernel.launches
    with pytest.raises(RuntimeError, match="GPU kernel"):
        layernorm.layer_norm_kernel(x, torch.ones(16), torch.zeros(16))
    assert layernorm.layer_norm_kernel.launches == before
    before = layernorm.layer_norm_backward_kernel.launches
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        layernorm.layer_norm_backward_kernel(x, torch.ones(16), x)
    assert layernorm.layer_norm_backward_kernel.launches == before

    x8 = torch.zeros(4, 16, dtype=torch.int8)
    before = quant.dequant_gemm.launches
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        quant.dequant_gemm(x8, x8, torch.ones(4), torch.ones(4), None)
    assert quant.dequant_gemm.launches == before

    # the dispatchers take the plain versions for CPU tensors, and only
    # because the tensors lie on the CPU; no kernel launch is counted
    attention.dot_product_attention(q, q, q)
    layernorm.layer_norm(x, torch.ones(16), torch.zeros(16))
    quant.int8_dense(x, torch.ones(16, 16))
    layernorm.layer_norm_backward(x, None, torch.ones(16), torch.zeros(16),
                                  x, 1e-12)
    assert attention.flash_attention.launches == 0
    assert layernorm.layer_norm_kernel.launches == 0
    assert layernorm.layer_norm_backward_kernel.launches == 0
    assert quant.dequant_gemm.launches == 0
