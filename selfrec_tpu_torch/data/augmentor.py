"""Graph and sequence augmentation (a copy of
``selfrec_tpu/data/augmentor.py``).

Produces dropped interaction matrices for contrastive view construction with
the same semantics as the reference ``GraphAugmentor``
(reference/data/augmentor.py:6-40): ``node_dropout`` zeroes the rows and
columns of uniformly chosen users/items; ``edge_dropout`` keeps a uniform
(1-rate) subset of the nonzeros. Implemented with vectorised numpy on the
edge arrays rather than the reference's ``random.sample`` loops; dropped
views feed ``Interaction.convert_to_laplacian_mat`` exactly as the reference
does (model/graph/SGL.py:89-96).

Steady-state per-step augmentation (SimGCL noise etc.) lives on device in
:mod:`selfrec_tpu_torch.ops`; this module is only for per-epoch view rebuilds.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def node_dropout(sp_adj: sp.spmatrix, drop_rate: float, rng: np.random.Generator) -> sp.csr_matrix:
    n_users, n_items = sp_adj.get_shape()
    row_idx, col_idx = sp_adj.nonzero()
    drop_users = rng.choice(n_users, size=int(n_users * drop_rate), replace=False)
    drop_items = rng.choice(n_items, size=int(n_items * drop_rate), replace=False)
    user_keep = np.ones(n_users, dtype=bool)
    item_keep = np.ones(n_items, dtype=bool)
    user_keep[drop_users] = False
    item_keep[drop_items] = False
    keep = user_keep[row_idx] & item_keep[col_idx]
    vals = np.ones(keep.sum(), dtype=np.float32)
    return sp.csr_matrix(
        (vals, (row_idx[keep], col_idx[keep])), shape=(n_users, n_items), dtype=np.float32
    )


def edge_dropout(sp_adj: sp.spmatrix, drop_rate: float, rng: np.random.Generator) -> sp.csr_matrix:
    shape = sp_adj.get_shape()
    row_idx, col_idx = sp_adj.nonzero()
    edge_count = len(row_idx)
    keep_idx = rng.choice(edge_count, size=int(edge_count * (1 - drop_rate)), replace=False)
    vals = np.ones(len(keep_idx), dtype=np.float32)
    return sp.csr_matrix(
        (vals, (row_idx[keep_idx], col_idx[keep_idx])), shape=shape, dtype=np.float32
    )


class GraphAugmentor:
    """Class-surface parity with the reference ``GraphAugmentor``
    (reference/data/augmentor.py:6-40). Static methods take an
    explicit rng for determinism (the reference uses the global RNG)."""

    @staticmethod
    def node_dropout(sp_adj, drop_rate, rng=None):
        rng = rng or np.random.default_rng()
        return node_dropout(sp_adj, drop_rate, rng)

    @staticmethod
    def edge_dropout(sp_adj, drop_rate, rng=None):
        rng = rng or np.random.default_rng()
        return edge_dropout(sp_adj, drop_rate, rng)


class SequenceAugmentor:
    """Host numpy sequence augmentations with reference semantics
    (reference/data/augmentor.py:43-74). The training hot path uses
    the vectorised on-device versions in ops/seq_sampling.py; these
    exist for the public augmentor surface and as a cross-check."""

    @staticmethod
    def item_crop(seq, seq_len, crop_ratio, rng=None):
        rng = rng or np.random.default_rng()
        augmented_seq = np.zeros_like(seq)
        augmented_pos = np.zeros_like(seq)
        aug_len = []
        for i in range(len(seq)):
            span = int(seq_len[i] * crop_ratio)
            start = int(rng.integers(0, max(seq_len[i] - span, 1)))
            crop_len = span + 1
            augmented_seq[i, :crop_len] = seq[i, start : start + crop_len]
            augmented_pos[i, :crop_len] = np.arange(1, crop_len + 1)
            aug_len.append(crop_len)
        return augmented_seq, augmented_pos, aug_len

    @staticmethod
    def item_reorder(seq, seq_len, reorder_ratio, rng=None):
        rng = rng or np.random.default_rng()
        augmented_seq = seq.copy()
        for i in range(len(seq)):
            span = int(seq_len[i] * reorder_ratio)
            start = int(rng.integers(0, max(seq_len[i] - span, 1)))
            rng.shuffle(augmented_seq[i, start : start + span + 1])
        return augmented_seq

    @staticmethod
    def item_mask(seq, seq_len, mask_ratio, mask_idx, rng=None):
        rng = rng or np.random.default_rng()
        augmented_seq = seq.copy()
        for i in range(len(seq)):
            k = int(seq_len[i] * mask_ratio)
            if k > 0:
                to_mask = rng.choice(seq_len[i], size=k, replace=False)
                augmented_seq[i, to_mask] = mask_idx
        return augmented_seq
