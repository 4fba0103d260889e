"""Build of the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
:func:`build_dir` (listed in .gitignore), and loaded with ctypes by the
module that wraps it. A library is cached by the hash of its source and
flags. :func:`build_all` starts one ``nvcc`` per source at once, so a fresh
checkout builds in the time of the slowest file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCES = ("dense_dual.cu", "ell_gather.cu", "rank_topk.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600


def build_dir() -> str:
    """Where compiled kernels go: ``$SELFREC_TPU_TORCH_BUILD`` or the
    ``build/kernels`` directory beside the package (listed in .gitignore)."""
    default = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "kernels")
    return os.environ.get("SELFREC_TPU_TORCH_BUILD", default)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _target(source: str) -> Tuple[str, str]:
    """(source path, library path) for one file of ``csrc/``."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return src, os.path.join(build_dir(), f"lib{stem}_{digest}.so")


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together; return {source: library path}. nvcc's output, with ptxas's
    register and spill report, is kept beside each library as ``.log``.
    Raises, naming the file and quoting nvcc, if any build fails."""
    os.makedirs(build_dir(), exist_ok=True)
    paths: Dict[str, str] = {}
    running = []
    for source in sources:
        src, so_path = _target(source)
        paths[source] = so_path
        if os.path.exists(so_path):
            continue
        tmp = f"{so_path}.tmp{os.getpid()}"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((src, so_path, tmp, proc))
    failures = []
    for src, so_path, tmp, proc in running:
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"nvcc timed out on {src}:\n{log}")
            continue
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src}:\n{log}")
            continue
        with open(so_path[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, so_path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build(source: str) -> str:
    """Library path of one source of ``csrc/``, compiling it if needed."""
    return build_all([source])[source]


def hopper_library(device, ready: set, load, what: str):
    """``load()``'s kernel library for ``device``, after checking once per
    device (``ready`` holds those that passed) that it is an sm_90 card,
    which the kernels are built for; raises otherwise."""
    if device.index not in ready:
        import torch

        cap = torch.cuda.get_device_capability(device)
        if tuple(cap) != (9, 0):
            raise RuntimeError(f"{what}'s kernel is built for sm_90a (Hopper); device "
                               f"{device} is sm_{cap[0]}{cap[1]}")
    lib = load()
    ready.add(device.index)
    return lib
