"""``Data`` base: holds conf/training/test references.

Parity with reference/data/data.py:1-6. The array-native fast path
stores the mapped tuple as ``training_data`` (see data/interaction.py).
"""

from __future__ import annotations


class Data:
    def __init__(self, conf, training, test):
        self.config = conf
        self.training_data = training
        self.test_data = test  # may be a validation set
