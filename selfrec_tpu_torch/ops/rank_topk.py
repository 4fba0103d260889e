"""Full-catalog masked top-k of the eval: each test user's best ``k`` items
by f32 dot product over the whole catalog, rated items set to
``MASK_VALUE``, in ``lax.top_k``'s order (value descending, ties by the
lowest item id).

Replaces no TPU kernel: the JAX package ranks with an XLA dot, a select
against the resident rated incidence and ``lax.top_k``
(``selfrec_tpu/ops/ranking.py`` ``_topk_all_blocks_dense``), and the port
ran the same three library calls per block of users
(:func:`selfrec_tpu_torch.ops.ranking._topk_all_blocks_dense`). Both
versions here run one two-stage algorithm and never hold the whole score
matrix:

1. the catalog is cut into contiguous item slices, and each slice keeps
   each user's best ``k`` (value, item) pairs;
2. a user's ``slices × k`` candidates are merged into its top-``k``.

A pair is ranked by one int64 key (:func:`sort_keys`), so every order is
total and the answer does not depend on the slices. Given the test users'
ground truth (``gt``: a CSR, items ascending within each user), the merge
also tests its answer: ``hits[r, q]`` is true exactly where ``ids[r, q]``
is a ground-truth item of test user r. :func:`hits_plain` is the same
test in plain torch, which the eval's other routes run on their ids.

The eval's CPU path takes :func:`rank_topk_plain`, at any k. For CUDA
tensors :func:`rank_topk` launches the two hand-written kernels of
``csrc/rank_topk.cu`` (``rank_partial`` and ``rank_merge``; that file
states their design and bound on an H100) or raises; it takes no other
device. ``rank_topk.launches`` counts its calls, each one launch of both
kernels.

Spans (:mod:`selfrec_tpu_torch.utils.trace`): host span ``rank.fused``
around each call on the card; device spans ``rank.score`` (the operand
copies and ``rank_partial``) and ``rank.topk`` (``rank_merge``, its
ground-truth test included).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from selfrec_tpu_torch.ops import cuda_build
from selfrec_tpu_torch.utils import trace

MASK_VALUE = -1e9  # reference masks rated items with -10e8; the kernel's MASK_VALUE
K_MAX = 128        # largest k the kernels keep on chip
BM = BN = 128      # test users a CTA, items a tile (the kernel's)
BK = 16            # the kernel's contraction chunk: D is padded to a multiple
CTAS_PER_SM = 2    # rank_partial's occupancy (__launch_bounds__)
MAX_SLICES = 32    # rank_merge holds one slice's head a lane
PLAIN_SLICES = 4   # the plain version's slice count; any count gives the same answer
PLAIN_BLOCK = 1024  # the plain version's users a block, which bounds its memory
_lib = None
_lib_lock = threading.Lock()
_ready = set()  # devices that passed the capability check with the library loaded


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build("rank_topk.cu"))
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.selfrec_rank_partial.restype = ctypes.c_int
            lib.selfrec_rank_partial.argtypes = [p, p, p, ll, p, i, i, i, ll, ll, i, i, i, p, p]
            lib.selfrec_rank_merge.restype = ctypes.c_int
            lib.selfrec_rank_merge.argtypes = [p, i, i, i, p, p, p, p, p, p]
            _lib = lib
    return _lib


def sort_keys(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One int64 key a (value, id) pair, descending in ``lax.top_k``'s
    order: the f32 value's bits mapped to a signed integer of the same
    total order (-0.0 below +0.0, as XLA's top-k compares) in the high
    word, the complement of the id in the low word. Distinct ids give
    distinct keys; ``ids`` broadcasts against ``values``."""
    bits = values.float().contiguous().view(torch.int32).to(torch.int64)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (order << 32) | (0xFFFFFFFF - ids)


def key_values(keys: torch.Tensor) -> torch.Tensor:
    """The f32 values of :func:`sort_keys`'s keys, bit for bit."""
    order = (keys >> 32).to(torch.int32)
    return torch.where(order < 0, order ^ 0x7FFFFFFF, order).view(torch.float32)


def key_ids(keys: torch.Tensor) -> torch.Tensor:
    """The int64 ids of :func:`sort_keys`'s keys."""
    return 0xFFFFFFFF - (keys & 0xFFFFFFFF)


def hits_plain(ids: torch.Tensor, gt_offsets: torch.Tensor, gt_items: torch.Tensor
               ) -> torch.Tensor:
    """``rank_merge``'s epilogue in plain torch: (n, k) bool, true where
    ``ids[r, q]`` is in ``gt_items[gt_offsets[r]:gt_offsets[r + 1]]``, by
    membership of (row, id) keys among the ground truth's."""
    if ids.numel() == 0 or gt_items.numel() == 0:
        return torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    span = int(max(ids.max(), gt_items.max())) + 1
    rows = torch.arange(ids.shape[0], device=ids.device)
    gt_keys = rows.repeat_interleave(gt_offsets.diff()) * span + gt_items
    return torch.isin(rows[:, None] * span + ids, gt_keys)


def rank_topk_plain(user_emb: torch.Tensor, item_emb: torch.Tensor, rated: torch.Tensor,
                    uids: torch.Tensor, k: int, slices: int = PLAIN_SLICES, gt=None):
    """The kernels' function in plain torch, by the same two stages over
    ``slices`` equal slices (the last shorter), users in blocks: each
    slice's f32 scores, rated items set to ``MASK_VALUE``, the slice's best
    ``k`` keys; then the best ``k`` of a user's candidates. Returns
    (scores (n, k) f32, ids (n, k) int64), descending, ties by the lowest
    id; with ``gt`` = (offsets (n + 1,) int64, items int32), each user's
    ground truth ascending, also ``hits`` (n, k) bool (:func:`hits_plain`).
    Any k."""
    if gt is not None:
        _check_gt(gt, uids)
    n_items = item_emb.shape[0]
    width = -(-n_items // slices)
    idx = torch.arange(n_items, device=item_emb.device, dtype=torch.int64)
    scores, ids = [], []
    for lo in range(0, uids.shape[0], PLAIN_BLOCK):
        u = uids[lo:lo + PLAIN_BLOCK]
        ue = user_emb[u]
        cands = []
        for s0 in range(0, n_items, width):
            s1 = min(n_items, s0 + width)
            block = torch.where(rated[u, s0:s1] != 0, MASK_VALUE, ue @ item_emb[s0:s1].T)
            keys = sort_keys(block, idx[s0:s1])
            cands.append(torch.topk(keys, min(k, s1 - s0), dim=1).values)
        top = torch.topk(torch.cat(cands, dim=1), k, dim=1).values
        scores.append(key_values(top))
        ids.append(key_ids(top))
    if scores:
        scores, ids = torch.cat(scores), torch.cat(ids)
    else:
        scores = torch.empty((0, k), dtype=torch.float32, device=user_emb.device)
        ids = torch.empty((0, k), dtype=torch.int64, device=user_emb.device)
    return (scores, ids) if gt is None else (scores, ids, hits_plain(ids, *gt))


def _check(user_emb, item_emb, rated, uids, k):
    for name, t in (("user_emb", user_emb), ("item_emb", item_emb)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"rank_topk takes f32 {name} (rows, D), got {t.dtype} "
                            f"{tuple(t.shape)}")
    if rated.dtype != torch.int8 or rated.dim() != 2:
        raise TypeError(f"rank_topk takes an int8 rated incidence (users, items), got "
                        f"{rated.dtype} {tuple(rated.shape)}")
    if uids.dtype != torch.int64 or uids.dim() != 1:
        raise TypeError(f"rank_topk takes int64 test user ids (n,), got {uids.dtype} "
                        f"{tuple(uids.shape)}")
    if user_emb.shape[1] != item_emb.shape[1]:
        raise ValueError(f"user and item embeddings differ in width: "
                         f"{user_emb.shape[1]} and {item_emb.shape[1]}")
    if tuple(rated.shape) != (user_emb.shape[0], item_emb.shape[0]):
        raise ValueError(f"rated {tuple(rated.shape)} is not (users, items) = "
                         f"({user_emb.shape[0]}, {item_emb.shape[0]})")
    if not 1 <= k <= min(K_MAX, item_emb.shape[0]):
        raise ValueError(f"rank_topk takes 1 <= k <= min({K_MAX}, items = "
                         f"{item_emb.shape[0]}), got k={k}")
    if not (user_emb.device == item_emb.device == rated.device == uids.device):
        raise ValueError("rank_topk operands lie on different devices")
    if not all(t.is_contiguous() for t in (user_emb, item_emb, rated, uids)):
        raise ValueError("rank_topk needs contiguous operands")


def _check_gt(gt, uids):
    offsets, items = gt
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise TypeError(f"rank_topk takes int64 ground-truth offsets (n + 1,), got "
                        f"{offsets.dtype} {tuple(offsets.shape)}")
    if items.dtype != torch.int32 or items.dim() != 1:
        raise TypeError(f"rank_topk takes int32 ground-truth items, got {items.dtype} "
                        f"{tuple(items.shape)}")
    if offsets.shape[0] != uids.shape[0] + 1:
        raise ValueError(f"ground-truth offsets of {offsets.shape[0]} rows for "
                         f"{uids.shape[0]} test users")
    if not offsets.device == items.device == uids.device:
        raise ValueError("rank_topk: the ground truth lies on another device than the users")
    if not (offsets.is_contiguous() and items.is_contiguous()):
        raise ValueError("rank_topk needs a contiguous ground truth")


def slice_plan(n: int, n_items: int, device) -> Tuple[int, int]:
    """(tiles_per_slice, slices) of ``rank_partial``'s grid: the most slices
    of whole item tiles whose CTAs still fit the card's resident slots at
    once (each slice pays its first tiles' candidates again), at least one,
    at most ``MAX_SLICES``, none empty."""
    n_tiles = -(-n_items // BN)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fit = CTAS_PER_SM * sms // -(-n // BM)
    tiles_per_slice = -(-n_tiles // max(1, min(MAX_SLICES, n_tiles, fit)))
    return tiles_per_slice, -(-n_tiles // tiles_per_slice)


def _operand(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """x.T zero-padded to (rows, cols): the kernel's D-major operand."""
    out = torch.zeros((rows, cols), dtype=torch.float32, device=x.device)
    out[:x.shape[1], :x.shape[0]] = x.T
    return out


def rank_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, rated: torch.Tensor,
              uids: torch.Tensor, k: int, gt=None):
    """Each test user's top ``k`` items: ``user_emb[uids]`` (f32, (users,
    D)) against every row of ``item_emb`` (f32, (items, D)), items with
    ``rated[uids[r], item] != 0`` (int8) at ``MASK_VALUE``. Returns
    (scores (n, k) f32, ids (n, k) int64), descending, ties by the lowest
    id. ``uids`` must index rows of ``rated`` (not checked: that would
    read them back from the card). With ``gt`` = (offsets (n + 1,) int64,
    items int32) on the same device, test user r's ground truth being
    ``items[offsets[r]:offsets[r + 1]]`` ascending (not checked either),
    ``rank_merge`` tests its answer and the call returns (scores, ids,
    hits), ``hits`` (n, k) bool; scores and ids are the same either way.

    Launches ``rank_partial`` and ``rank_merge`` (sm_90a) or raises; the
    CPU's version is :func:`rank_topk_plain`."""
    _check(user_emb, item_emb, rated, uids, k)
    if gt is not None:
        _check_gt(gt, uids)
    device = user_emb.device
    if device.type != "cuda":
        raise RuntimeError(f"rank_topk: no kernel for device {device} (the CPU takes "
                           f"rank_topk_plain)")
    lib = cuda_build.hopper_library(device, _ready, _load, "rank_topk")
    n, d = uids.shape[0], user_emb.shape[1]
    n_items = item_emb.shape[0]
    scores = torch.empty((n, k), dtype=torch.float32, device=device)
    ids = torch.empty((n, k), dtype=torch.int64, device=device)
    hits = None if gt is None else torch.empty((n, k), dtype=torch.uint8, device=device)
    out = (scores, ids) if gt is None else (scores, ids, hits.view(torch.bool))
    if n == 0:
        return out
    tiles_per_slice, slices = slice_plan(n, n_items, device)
    dp, n_pad, i_pad = -(-d // BK) * BK, -(-n // BM) * BM, -(-n_items // BN) * BN
    keys = torch.empty((n, slices, k), dtype=torch.int64, device=device)
    with trace.span("rank.fused"), torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        with trace.device_span("rank.score", device):
            ut = _operand(user_emb.index_select(0, uids), dp, n_pad)
            it = _operand(item_emb, dp, i_pad)
            rc = lib.selfrec_rank_partial(
                ut.data_ptr(), it.data_ptr(), rated.data_ptr(), rated.stride(0),
                uids.data_ptr(), n, n_items, dp, n_pad, i_pad, k, tiles_per_slice, slices,
                keys.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"rank_partial kernel launch failed: error {rc}")
        gt_ptrs = (None, None, None) if gt is None else (
            gt[0].data_ptr(), gt[1].data_ptr(), hits.data_ptr())
        with trace.device_span("rank.topk", device):
            rc = lib.selfrec_rank_merge(keys.data_ptr(), n, slices, k, scores.data_ptr(),
                                        ids.data_ptr(), *gt_ptrs, stream)
        if rc != 0:
            raise RuntimeError(f"rank_merge kernel launch failed: error {rc}")
    rank_topk.launches += 1
    return out


rank_topk.launches = 0
