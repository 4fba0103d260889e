"""Sequential dataset (a copy of ``selfrec_tpu/data/sequence.py``).

Parity with the reference ``Sequence`` (reference/data/sequence.py:6-54):
item ids start at 1 (0 is the pad token, sequence.py:22), sequences with fewer
than 2 items are dropped (sequence.py:26), and the test target is only the
FIRST item of each test sequence (sequence.py:42-46).

Beyond the reference, sequences are pre-padded once into fixed-shape int32
arrays (right-anchored windows of ``max_len``, the reference's per-batch
layout at util/sampler.py:84-133) so training batches are pure device slices.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


class Sequence:
    def __init__(self, conf, training_data: Dict[str, List[str]], test_data: Dict[str, List[str]]):
        self.config = conf
        self.training_data = training_data
        self.test_data = test_data

        self.item: Dict[str, int] = {}
        self.id2item: Dict[int, str] = {}
        self.seq: Dict[str, int] = {}
        self.id2seq: Dict[int, str] = {}
        self.test_set: Dict[str, Dict[str, float]] = defaultdict(dict)
        self.test_set_item = set()

        self.original_seq: List[Tuple[str, List[int]]] = self._generate_set()
        self.raw_seq_num = len(self.seq)
        self.item_num = len(self.item)

    def _generate_set(self) -> List[Tuple[str, List[int]]]:
        original_sequences = []
        seq_index = 0
        item_index = 1  # 0 reserved for padding
        for seq_name, seq_data in self.training_data.items():
            if len(seq_data) < 2:
                continue
            if seq_name not in self.seq:
                self.seq[seq_name] = seq_index
                self.id2seq[seq_index] = seq_name
                seq_index += 1
            for item in seq_data:
                if item not in self.item:
                    self.item[item] = item_index
                    self.id2item[item_index] = item
                    item_index += 1
            original_sequences.append((seq_name, [self.item[i] for i in seq_data]))
        for seq_name, items in self.test_data.items():
            if seq_name in self.seq and items:
                first_item = items[0]
                self.test_set[seq_name][first_item] = 1
                self.test_set_item.add(first_item)
        return original_sequences

    def get_item_id(self, i: str):
        return self.item.get(i)

    def get_seq_id(self, s: str):
        return self.seq.get(s)

    # -- device-ready padded arrays ------------------------------------------
    def padded_training_arrays(self, max_len: int):
        """Right-anchored training windows, matching util/sampler.py:84-112.

        Returns (seq, pos, y, seq_len): for a raw sequence s of length L the
        input is s[:-1] windowed to the LAST max_len-1 positions (sampler takes
        s[-max_len:-1] when L > max_len), targets y are the next items, pos is
        1..len, everything left-aligned in a (N, max_len) buffer.
        """
        n = len(self.original_seq)
        seq = np.zeros((n, max_len), dtype=np.int32)
        pos = np.zeros((n, max_len), dtype=np.int32)
        y = np.zeros((n, max_len), dtype=np.int32)
        seq_len = np.zeros((n,), dtype=np.int32)
        for row, (_, items) in enumerate(self.original_seq):
            L = len(items)
            start = -max_len if L > max_len else 0
            end = max_len - 1 if L > max_len else L - 1
            seq[row, :end] = items[start:-1]
            pos[row, :end] = np.arange(1, end + 1)
            y[row, :end] = items[start + 1 :] if start else items[1:]
            seq_len[row] = end
        return seq, pos, y, seq_len

    def padded_test_arrays(self, max_len: int):
        """Full-sequence test windows, matching util/sampler.py:114-133."""
        n = len(self.original_seq)
        seq = np.zeros((n, max_len), dtype=np.int32)
        pos = np.zeros((n, max_len), dtype=np.int32)
        seq_len = np.zeros((n,), dtype=np.int32)
        for row, (_, items) in enumerate(self.original_seq):
            L = len(items)
            start = -max_len if L > max_len else 0
            end = max_len if L > max_len else L
            seq[row, :end] = items[start:]
            pos[row, :end] = np.arange(1, end + 1)
            seq_len[row] = end
        return seq, pos, seq_len
