"""Dataset file IO.

File formats match the reference exactly (reference/data/loader.py:22-66):
  graph:      one interaction per line, ``user item weight`` space-separated
  sequential: one sequence per line, ``seqid:item item item ...``
  social:     one relation per line, ``user1 user2 [weight]``

Loading is vectorised with numpy where it matters; semantics (ordering,
duplicate handling) are identical to the reference's line-by-line parse.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple


def load_graph_data(path: str) -> List[Tuple[str, str, float]]:
    """Load interaction triples. Reference: data/loader.py:23-32.

    Uses the native C++ mmap loader (selfrec_tpu_torch/native/loader.cpp) when the
    toolchain is available — identical first-seen token semantics — and the
    pure-Python parse otherwise (or with SELFREC_TPU_NO_NATIVE=1)."""
    mapped = load_graph_mapped(path)
    if mapped is not None:
        src, dst, w, src_names, dst_names = mapped
        return list(
            zip(
                (src_names[i] for i in src),
                (dst_names[i] for i in dst),
                w.astype(float),
            )
        )
    return _load_graph_data_py(path)


def load_graph_mapped(path: str):
    """Native fast path: (src_ids, dst_ids, weights, src_names, dst_names)
    or None when the native library is unavailable."""
    try:
        from selfrec_tpu_torch import native
    except ImportError:  # pragma: no cover
        return None
    return native.load_graph_mapped(path)


def _load_graph_data_py(path: str) -> List[Tuple[str, str, float]]:
    data: List[Tuple[str, str, float]] = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2 or not parts[0]:
                continue
            weight = float(parts[2]) if len(parts) > 2 else 1.0
            data.append((parts[0], parts[1], weight))
    return data


def load_sequential_data(path: str) -> Dict[str, List[str]]:
    """Load ``seqid:item item ...`` sequences. Reference: data/loader.py:34-41."""
    data: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            seq_id, _, items = line.partition(":")
            data[seq_id] = items.split()
    return data


def load_social_data(path: str) -> List[Tuple[str, str, float]]:
    """Load social relations. Reference: data/loader.py:52-66."""
    data: List[Tuple[str, str, float]] = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2 or not parts[0]:
                continue
            weight = float(parts[2]) if len(parts) > 2 else 1.0
            data.append((parts[0], parts[1], weight))
    return data


def load_data_set(path: str, rec_type: str):
    """Dispatch on model type, mirroring FileIO.load_data_set."""
    if rec_type == "graph":
        return load_graph_data(path)
    if rec_type == "sequential":
        return load_sequential_data(path)
    raise ValueError(f"Unknown rec_type: {rec_type!r}")


def write_file(directory: str, filename: str, content: Sequence[str], op: str = "w") -> str:
    """Write result artifacts; same layout as reference data/loader.py:10-15."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, filename)
    with open(path, op) as f:
        f.writelines(content)
    return path
