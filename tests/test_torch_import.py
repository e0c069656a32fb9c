"""The port stands alone: it imports without JAX and nothing of ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import KFACConfig
from repro_torch.data.pipeline import SyntheticAutoencoderData
from repro_torch.models.mlp import MLP
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    mods = list(_modules())
    assert "repro_torch.optimizers.kfac" in mods
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_source_names_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                     re.M)
    hits = [f"{p}: {m.group(0).strip()}" for p in PKG.rglob("*.py")
            for m in pat.finditer(p.read_text())]
    assert not hits, hits


def test_entry_points_refuse_cuda_without_a_card():
    """The entry points default to ``device="cuda"`` and raise, rather than
    fall back to the CPU, when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        MLP([4, 3, 4])
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticAutoencoderData(4, 2, 8)
    mlp = MLP([4, 3, 4], device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        kfac(mlp, KFACConfig(), family="bernoulli")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(mlp, None, None)


def test_serving_entry_points_refuse_cuda_without_a_card():
    """The LM and the serving launcher default to ``device="cuda"`` and
    raise without a card; the serving modules are among those
    ``test_every_module_imports_without_jax`` imports."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mods = list(_modules())
    for m in ("repro_torch.serving.engine", "repro_torch.launch.serve",
              "repro_torch.kernels.flash_decode", "repro_torch.models.lm"):
        assert m in mods
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    with pytest.raises(RuntimeError, match="cuda"):
        LM(get_reduced_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced"])
    rep = serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                      "--max_new", "3"])
    assert len(rep.completed) == 2


def test_train_launcher_refuses_cuda_without_a_card():
    """``launch/train.py`` defaults to ``--device cuda`` and raises without
    a card; with ``--device cpu`` it trains reduced whisper (3 steps)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1"], log=lambda *_: None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "whisper-small", "--reduced", "--steps", "3", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(PKG.parent)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] done: loss" in out.stdout, out.stdout
