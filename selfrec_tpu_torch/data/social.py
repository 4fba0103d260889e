"""Social relation dataset (counterpart of ``selfrec_tpu/data/social.py``).

Parity with the reference ``Relation`` (reference/data/social.py:7-87):
relations whose endpoints are unseen in training are pruned (social.py:18-24),
``get_social_mat`` builds the user-user CSR (social.py:31-38), and the
"bidirectional" matrix reproduces the reference's ``S.multiply(S)``
(social.py:40-43: the elementwise square, NOT S⊙Sᵀ; kept verbatim for
parity, with the intended S⊙Sᵀ available as ``get_mutual_social_mat``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from selfrec_tpu_torch.data.graph import normalize_graph_mat


class Relation:
    def __init__(self, conf, relation: List[Tuple[str, str, float]], user: Dict[str, int]):
        self.config = conf
        self.user = user
        self.relation = [
            pair for pair in relation if pair[0] in self.user and pair[1] in self.user
        ]
        self.followees: Dict[str, Dict[str, float]] = defaultdict(dict)
        self.followers: Dict[str, Dict[str, float]] = defaultdict(dict)
        for u1, u2, w in self.relation:
            self.followees[u1][u2] = w
            self.followers[u2][u1] = w

    def get_social_mat(self) -> sp.csr_matrix:
        row = np.array([self.user[p[0]] for p in self.relation], dtype=np.int64)
        col = np.array([self.user[p[1]] for p in self.relation], dtype=np.int64)
        vals = np.ones(len(self.relation), dtype=np.float32)
        n = len(self.user)
        return sp.csr_matrix((vals, (row, col)), shape=(n, n), dtype=np.float32)

    def get_birectional_social_mat(self) -> sp.csr_matrix:
        """Reference behaviour verbatim: S.multiply(S) (social.py:40-43)."""
        s = self.get_social_mat()
        return s.multiply(s)

    def get_mutual_social_mat(self) -> sp.csr_matrix:
        """S ⊙ Sᵀ: mutual-follow edges (what the reference name suggests)."""
        s = self.get_social_mat()
        return s.multiply(s.T)

    def convert_to_laplacian_mat(self, adj_mat: sp.spmatrix) -> sp.spmatrix:
        return normalize_graph_mat(adj_mat.tocsr())

    def weight(self, u1: str, u2: str) -> float:
        return self.followees.get(u1, {}).get(u2, 0)

    def get_followers(self, u: str) -> Dict[str, float]:
        return self.followers.get(u, {})

    def get_followees(self, u: str) -> Dict[str, float]:
        return self.followees.get(u, {})

    def has_followee(self, u1: str, u2: str) -> bool:
        return u2 in self.followees.get(u1, {})

    def has_follower(self, u1: str, u2: str) -> bool:
        return u2 in self.followers.get(u1, {})

    def size(self) -> Tuple[int, int]:
        return len(self.followers), len(self.relation)
