"""The port stands alone: nothing in `deeperspeed_tpu_torch/` or
`chip_smoke.py` imports JAX, jaxlib, the JAX package or `ml_dtypes`,
and building a CPU serving engine (bf16/fp32 and int8), a dense, an MoE
and a block-sparse GPT-NeoX training engine, a packed GPT-NeoX training
engine under a remat policy, a BERT training engine, a GPT-2 serving
engine and a lean GPT-2 training engine through `train_batch` and the
legacy forward / backward / step loop, saving and loading a checkpoint,
and a training engine with the training-health sentinel, a fault plan,
the batch-size schedule and progressive layer drop, an fp16 engine with
Lamb and the "amp" block, `FP16_Optimizer` / `FP16_UnfusedOptimizer`
steps and an fp16 serving engine, leaves them out of `sys.modules`."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "deeperspeed_tpu", "ml_dtypes")
FILES = sorted((ROOT / "deeperspeed_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom deeperspeed_tpu.runtime import x\n"
                     "def f():\n    import jax.numpy as jnp\n")
    assert [n for n in _imports(probe) if _forbidden(n)] == \
        ["deeperspeed_tpu.runtime", "jax.numpy"]
    assert not _forbidden("deeperspeed_tpu_torch.models")


def test_engine_on_cpu_loads_no_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig, "
        "InferenceEngine\n"
        "m = GPTNeoX(GPTNeoXConfig.tiny(), device='cpu').init_params(0)\n"
        "e = InferenceEngine(m, config={'inference': {'enabled': True, "
        "'page_size': 16, 'num_pages': 16}}, device='cpu')\n"
        "out = e.generate([[1, 2, 3]], max_new_tokens=2)\n"
        "assert len(out[0]) == 2\n"
        "q = InferenceEngine(m, config={'inference': {'enabled': True, "
        "'page_size': 16, 'num_pages': 16, 'kv_cache_dtype': 'int8'}, "
        "'quantization': {'weights': 'int8'}}, device='cpu')\n"
        "assert q.dtypes['weight'] == q.dtypes['kv_cache'] == 'int8'\n"
        "assert len(q.generate([[1, 2, 3]], max_new_tokens=2)[0]) == 2\n"
        "from deeperspeed_tpu_torch import initialize\n"
        "t = GPTNeoX(GPTNeoXConfig.tiny(), device='cpu').init_params(0)\n"
        "eng, *_ = initialize(model=t, config_params={\n"
        "    'train_batch_size': 2, 'gradient_accumulation_steps': 2,\n"
        "    'optimizer': {'type': 'Adam', 'params': {'lr': 1e-3}},\n"
        "    'fp16': {'enabled': True, 'type': 'bfloat16'}})\n"
        "x = torch.randint(0, 512, (2, 1, 16))\n"
        "assert eng.train_batch(batch=(x, x)) > 0 and eng.global_steps == 1\n"
        "m = GPTNeoX(GPTNeoXConfig.tiny(), device='cpu').init_params(0)\n"
        "eng, *_ = initialize(model=m, config_params={\n"
        "    'train_batch_size': 2, 'gradient_accumulation_steps': 2,\n"
        "    'optimizer': {'type': 'Adam', 'params': {'lr': 1e-3}},\n"
        "    'moe': {'num_experts': 4, 'top_k': 2, 'dispatch': 'sort'}})\n"
        "assert eng.train_batch(batch=(x, x)) > 0 and m.config.moe_top_k == 2\n"
        "sp = GPTNeoX(GPTNeoXConfig(vocab_size=512, hidden_size=128,\n"
        "    num_layers=1, num_heads=2), device='cpu').init_params(0)\n"
        "eng, *_ = initialize(model=sp, config_params={\n"
        "    'train_batch_size': 1,\n"
        "    'optimizer': {'type': 'Adam', 'params': {'lr': 1e-3}},\n"
        "    'sparse_attention': {'mode': 'fixed', 'block': 128}})\n"
        "x = torch.randint(0, 512, (1, 1, 256))\n"
        "assert eng.train_batch(batch=(x, x)) > 0\n"
        "assert sp.config.attention_engine == 'sparse'\n"
        "from deeperspeed_tpu_torch import BertConfig, BertForPreTraining\n"
        "bm = BertForPreTraining(BertConfig.tiny(), device='cpu')\n"
        "eng, *_ = initialize(model=bm.init_params(0), config_params={\n"
        "    'train_batch_size': 2,\n"
        "    'optimizer': {'type': 'Adam', 'params': {'lr': 1e-3}}})\n"
        "ids = torch.randint(0, 512, (1, 2, 32))\n"
        "b = {'input_ids': ids, 'token_type_ids': torch.zeros_like(ids),\n"
        "     'attention_mask': torch.ones(1, 2, 32),\n"
        "     'masked_lm_labels': ids, 'next_sentence_label': "
        "torch.zeros(1, 2, dtype=torch.long)}\n"
        "assert eng.train_batch(batch=b) > 0 and eng.global_steps == 1\n"
        "from deeperspeed_tpu_torch.runtime.packing import (\n"
        "    pack_documents, synthetic_doc_mixture)\n"
        "pm = GPTNeoX(GPTNeoXConfig.tiny(), device='cpu').init_params(0)\n"
        "eng, *_ = initialize(model=pm, config_params={\n"
        "    'train_batch_size': 2,\n"
        "    'optimizer': {'type': 'Adam', 'params': {'lr': 1e-3}},\n"
        "    'packing': {'enabled': True},\n"
        "    'activation_checkpointing': {'policy': 'attn_residuals'}})\n"
        "tok, seg = pack_documents(synthetic_doc_mixture(0, 9, 512,\n"
        "    mean_len=40.0, max_len=64), 64)\n"
        "b = (tok[None, :2], tok[None, :2], seg[None, :2])\n"
        "assert eng.train_batch(batch=b) > 0\n"
        "assert pm.config.use_segment_ids and "
        "pm.remat_policy == 'attn_residuals'\n"
        "import tempfile\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    eng.save_checkpoint_async(d)\n"
        "    eng.checkpoint_manager.wait()\n"
        "    assert eng.load_checkpoint(d)[0].endswith('global_step1')\n"
        "from deeperspeed_tpu_torch import GPT2, GPT2Config\n"
        "g = GPT2(GPT2Config.tiny(), device='cpu').init_params(0)\n"
        "ge = InferenceEngine(g, config={'inference': {'enabled': True, "
        "'page_size': 16, 'num_pages': 16, 'max_batch_size': 2}}, "
        "device='cpu')\n"
        "assert len(ge.generate([[1, 2, 3]], max_new_tokens=3)[0]) == 3\n"
        "lean, *_ = initialize(model=g, config_params={\n"
        "    'train_batch_size': 4, 'train_micro_batch_size_per_gpu': 2,\n"
        "    'optimizer': {'type': 'Adam', 'params': {'lr': 1e-3,\n"
        "                  'state_dtype': 'bfloat16'}},\n"
        "    'fp16': {'enabled': True, 'type': 'bfloat16',\n"
        "             'fp16_master_weights_and_grads': True}})\n"
        "gt = torch.randint(0, 256, (2, 2, 16))\n"
        "assert lean.train_batch(batch=(gt, gt)) > 0\n"
        "for i in range(2):\n"
        "    lean.backward(lean((gt[i], gt[i])))\n"
        "assert lean.step() > 0 and lean.global_steps == 2\n"
        "h = GPTNeoX(GPTNeoXConfig.tiny(), device='cpu').init_params(0)\n"
        "eng, *_ = initialize(model=h, config_params={\n"
        "    'train_batch_size': 2,\n"
        "    'optimizer': {'type': 'Adam', 'params': {'lr': 1e-3}},\n"
        "    'training_health': {'enabled': True, 'policy': 'skip_batch',\n"
        "        'fault_injection': {'faults': [\n"
        "            {'kind': 'nan_grads', 'step': 1}]}},\n"
        "    'batch_size_schedule': {'enabled': True},\n"
        "    'progressive_layer_drop': {'enabled': True}})\n"
        "x = torch.randint(0, 512, (1, 2, 16))\n"
        "for _ in range(2):\n"
        "    assert eng.train_batch(batch=(x, x)) > 0\n"
        "assert eng.global_steps == 1 and eng.sentinel.quarantined == 1\n"
        "f = GPTNeoX(GPTNeoXConfig.tiny(), device='cpu').init_params(0)\n"
        "eng, *_ = initialize(model=f, config_params={\n"
        "    'train_batch_size': 2, 'amp': {'enabled': True},\n"
        "    'optimizer': {'type': 'Lamb', 'params': {'lr': 1e-3}},\n"
        "    'fp16': {'enabled': True, 'initial_scale_power': 8}})\n"
        "assert eng.train_batch(batch=(x, x)) > 0\n"
        "assert eng._config.amp_enabled and eng.compute_dtype == "
        "torch.float16\n"
        "from deeperspeed_tpu_torch.ops.adam.fused_adam import FusedAdam\n"
        "from deeperspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb\n"
        "from deeperspeed_tpu_torch.runtime.fp16 import (FP16_Optimizer,\n"
        "    FP16_UnfusedOptimizer)\n"
        "for W, B in ((FP16_Optimizer, FusedAdam),\n"
        "             (FP16_UnfusedOptimizer, FusedLamb)):\n"
        "    w = torch.ones(4, 4, dtype=torch.float16)\n"
        "    o = W(B(lr=1e-2), dynamic_loss_scale=True)\n"
        "    st = o.init_state({'w': w})\n"
        "    st, info = o.step(st, {'w': torch.ones(4, 4)})\n"
        "    assert info.overflow is False or info.overflow is True\n"
        "fe = InferenceEngine(GPTNeoX(GPTNeoXConfig.tiny(param_dtype=\n"
        "    torch.float16), device='cpu').init_params(0), config={\n"
        "    'inference': {'enabled': True, 'page_size': 16, "
        "'num_pages': 16}}, device='cpu')\n"
        "assert fe.dtypes['kv_cache'] == 'torch.float16'\n"
        "assert len(fe.generate([[1, 2, 3]], max_new_tokens=2)[0]) == 2\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'deeperspeed_tpu', 'ml_dtypes'))\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_alone_without_gpu_fails(tmp_path):
    """chip_smoke.py in a directory with nothing else of the repo and no
    visible GPU exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
