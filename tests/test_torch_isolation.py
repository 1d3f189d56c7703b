"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
nor the image libraries, and it never falls back to the CPU by itself."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_helpers import ROOT, SYNTH_INI

PKG = Path(ROOT) / "envidr_tpu_torch"
SCRIPTS = ("chip_smoke.py", "bench_torch.py")
SOURCES = sorted(PKG.rglob("*.py")) + [Path(ROOT) / s for s in SCRIPTS]
FORBIDDEN = ("jax", "jaxlib", "optax", "envidr_tpu", "tools", "imageio", "PIL")
IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")(?![\w])", re.MULTILINE)
NO_CARD = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_import_regex_spares_the_port_itself():
    assert IMPORT_RE.search("from envidr_tpu.ops import x")
    assert IMPORT_RE.search("import jax.numpy as jnp")
    assert not IMPORT_RE.search("from envidr_tpu_torch.ops import scatter")
    assert not IMPORT_RE.search("import envidr_tpu_torch")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_forbidden(path):
    hits = IMPORT_RE.findall(path.read_text())
    assert not hits, f"{path}: imports {hits}"


def test_importing_every_module_loads_no_forbidden_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "import envidr_tpu_torch, chip_smoke, bench_torch\n"
        "for m in pkgutil.walk_packages(envidr_tpu_torch.__path__, 'envidr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print('LOADED', len([n for n in sys.modules if n.startswith('envidr_tpu_torch')]))\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED")[1].split()[0]) >= 20


def test_no_device_and_no_card_raises(monkeypatch):
    from envidr_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_trainer_without_card_raises(monkeypatch):
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = load_options(SYNTH_INI, num_levels=2, log2_hashmap_size=10, hidden_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(opt, network_config(opt))


def test_chip_smoke_without_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=NO_CARD,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_bench_torch_without_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, env=NO_CARD,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repo (and told a card exists), it cannot run."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in NO_CARD.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_env_sphere_generator_without_card_raises(monkeypatch):
    """The env-sphere set is made on the card unless the CPU is asked for."""
    from envidr_tpu_torch.data.env_dataset import generate_env_sphere
    from envidr_tpu_torch.render.pbr import PrefilteredEnv, procedural_envmap
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_env_sphere("val", 1, size=8, env_res=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PrefilteredEnv(procedural_envmap(0, 4, 8))


def test_sphere_mode_modules_read_no_untracked_file():
    """The sphere path's sources name no generated dataset: the card run
    generates the env-sphere set in memory and reads only tracked files."""
    for rel in ("data/env_dataset.py", "render/pbr.py", "render/sphere.py",
                "geometry/lighting.py", "data/hdri.py"):
        text = (PKG / rel).read_text()
        assert "env_sphere_synth" not in text, rel
