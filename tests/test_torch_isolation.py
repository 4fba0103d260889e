"""The PyTorch port (selfrec_tpu_torch) and chip_smoke.py stand alone: they
import neither JAX nor the JAX package, and the registry, device and kernel
wrapper refuse what this slice does not port instead of falling back."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import selfrec_tpu_torch
from selfrec_tpu_torch import device as device_lib
from selfrec_tpu_torch.models import MODEL_REGISTRY, get_model_class
from selfrec_tpu_torch.ops import dense_dual

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "selfrec_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "selfrec_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="selfrec_tpu_torch.") if not m.name.endswith("__main__"))


def _port_sources():
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_importing_every_module_loads_no_jax():
    mods = _port_modules() + ["selfrec_tpu_torch.__main__"]
    assert "selfrec_tpu_torch.ops.dense_dual" in mods
    code = (
        "import sys, importlib, importlib.util, runpy\n"
        f"for m in {mods!r}:\n"
        "    if m.endswith('__main__'):\n"
        "        importlib.util.find_spec(m)\n"
        "    else:\n"
        "        importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(_port_sources()))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_registry_lists_every_model_and_refuses_unported():
    from selfrec_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    assert get_model_class("SimGCL").__name__ == "SimGCL"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model_class("LightGCN")
    with pytest.raises(KeyError):
        get_model_class("NoSuchModel")


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_lib.resolve_device(None)
    with pytest.raises(RuntimeError):
        device_lib.resolve_device("cuda")
    assert device_lib.resolve_device("cpu") == torch.device("cpu")


def test_dual_matmul_wrapper_checks_and_counts_only_launches():
    b = torch.ones((4, 5), dtype=torch.int8)
    xu = torch.ones((4, 8), dtype=torch.int8)
    xi = torch.ones((5, 8), dtype=torch.int8)
    before = dense_dual.dual_matmul.launches
    ou, oi = dense_dual.dual_matmul(b, xu, xi)
    assert dense_dual.dual_matmul.launches == before  # CPU: plain version
    assert ou.dtype == torch.int32 and torch.all(ou == 5)
    assert oi.dtype == torch.int32 and torch.all(oi == 4)
    with pytest.raises(TypeError, match="ROADMAP"):
        dense_dual.dual_matmul(b, xu.float(), xi)
    with pytest.raises(ValueError):
        dense_dual.dual_matmul(b, xi, xu)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA (this machine) the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_dir_is_ignored_by_git():
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    rel = os.path.relpath(dense_dual.build_dir(), REPO).split(os.sep)[0]
    assert f"/{rel}/" in ignored


@pytest.mark.cuda
def test_dual_kernel_matches_plain_on_the_card():
    """On the card's machine, which has no JAX for tests/conftest.py:
    ``python -m pytest --noconftest -m cuda tests/test_torch_isolation.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for u, i, d in [(70, 90, 64), (517, 1029, 192), (1000, 1337, 64)]:
        b = (torch.rand((u, i), generator=gen, device="cuda") < 0.3).to(torch.int8)
        xu = torch.randint(-127, 128, (u, d), generator=gen, device="cuda",
                           dtype=torch.int8)
        xi = torch.randint(-127, 128, (i, d), generator=gen, device="cuda",
                           dtype=torch.int8)
        before = dense_dual.dual_matmul.launches
        ou, oi = dense_dual.dual_matmul(b, xu, xi)
        torch.cuda.synchronize()
        assert dense_dual.dual_matmul.launches == before + 1
        pu, pi = dense_dual.dual_matmul_plain(b, xu, xi)
        assert torch.equal(ou, pu) and torch.equal(oi, pi)
