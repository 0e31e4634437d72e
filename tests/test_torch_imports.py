"""The port stands alone: importing it loads no jax and nothing of the
JAX package, its sources name neither, and its entry points never fall
back from CUDA to the CPU on their own."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "quintnet_tpu_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    for m in ("serve.engine", "ops.flash_kernels", "ops.flash_attention",
              "core.config", "core.pytree", "data.datasets",
              "parallel.strategy", "parallel.train_step", "train.trainer",
              "train.metrics", "examples.gpt2_finetune"):
        assert f"quintnet_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'quintnet_tpu'\n"
        "             or n.startswith('quintnet_tpu.'))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("needle", ["import jax", "from jax",
                                    "quintnet_tpu."])
def test_sources_name_no_jax_and_no_jax_package(needle):
    hits = [str(p.relative_to(ROOT)) for p in PKG.rglob("*")
            if p.suffix in (".py", ".cu") and needle in p.read_text()]
    assert hits == []


def test_chip_smoke_imports_no_jax():
    text = (ROOT / "chip_smoke.py").read_text()
    for needle in ("import jax", "from jax", "quintnet_tpu."):
        assert needle not in text


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                           gpt2_params_to_numpy)
    from quintnet_tpu_torch.core.device import resolve_device
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.gpt2 import gpt2_model_spec
    from quintnet_tpu_torch.serve import KVPool, ServeEngine, gpt2_family
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = GPT2Config.tiny(n_layer=1)
    params = gpt2_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(gpt2_family(cfg), params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KVPool(n_layers=1, n_kv_heads=1, head_dim=4, block_size=4,
               num_blocks=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt2_params_from_numpy(gpt2_params_to_numpy(params))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Config.from_dict({}), gpt2_model_spec(cfg))


def test_resolve_device_takes_the_cpu_only_when_asked():
    from quintnet_tpu_torch.core.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
