"""Multi-process start-up (counterpart of
``selfrec_tpu/parallel/distributed.py`` and ``session.py:18-25``).

The port runs one process per device. A launcher such as

    torchrun --nproc-per-node 2 -m selfrec_tpu_torch --conf conf.yaml \\
        --set distributed=true --set mesh.model=2

starts them and sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK`` (and ``LOCAL_WORLD_SIZE``); the model's
constructor calls :func:`maybe_initialize`, which reads them and calls
``init_process_group`` once, over ``nccl`` for a CUDA device and ``gloo``
for the CPU. The device of a rank is ``cuda:LOCAL_RANK``. A node that runs
more ranks than it has cards (``LOCAL_WORLD_SIZE`` above the device count)
shares them out, ``cuda:(LOCAL_RANK mod count)``, and takes ``gloo``: NCCL
refuses two ranks on one card. Every collective gets the timeout
``SELFREC_TPU_DIST_TIMEOUT_S`` (default 300 s), so a lost peer fails the
run instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def wants_distributed(conf) -> bool:
    return bool(conf is not None and conf.get("distributed"))


def timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("SELFREC_TPU_DIST_TIMEOUT_S", "300")))


def shares_cards(device: torch.device) -> bool:
    """Whether this node runs more ranks than it has cards."""
    return (device.type == "cuda"
            and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > torch.cuda.device_count())


def rank_device(device: torch.device) -> torch.device:
    """``cuda:LOCAL_RANK`` (mod the device count) for a CUDA ``device``
    without an index inside a process group; ``device`` itself otherwise."""
    if (device.type == "cuda" and device.index is None and dist.is_initialized()
            and "LOCAL_RANK" in os.environ):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return device


def maybe_initialize(conf=None, device: Optional[torch.device] = None) -> bool:
    """``init_process_group`` once when ``conf`` has ``distributed: true``,
    printing :func:`process_info`. Returns True when the run has more than
    one process. Raises, naming them, when torchrun's variables are
    missing."""
    if not dist.is_initialized() and wants_distributed(conf):
        missing = [k for k in ENV_KEYS if k not in os.environ]
        if missing:
            raise RuntimeError(
                "distributed: true needs the launcher's environment (torchrun "
                f"sets it); missing {', '.join(missing)}")
        device = torch.device("cuda" if device is None else device)
        backend = "nccl" if device.type == "cuda" and not shares_cards(device) else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://", timeout=timeout(),
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
        print(process_info(rank_device(device)), flush=True)
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def process_info(device=None) -> str:
    if not dist.is_initialized():
        return f"process 0/1, device {device}, no process group"
    return (f"process {dist.get_rank()}/{dist.get_world_size()}, device {device}, "
            f"backend {dist.get_backend()}")
