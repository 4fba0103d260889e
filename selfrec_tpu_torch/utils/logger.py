"""Per-run file logging, artifact-compatible with the reference
(reference/util/logger.py:5-17): one FileHandler per run under
``./log/<name>.log`` with ``%(asctime)s %(levelname)s %(message)s``.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Union


class Log:
    def __init__(self, module: str, filename: str, log_dir: str = "./log/"):
        self.logger = logging.getLogger(module)
        self.logger.setLevel(level=logging.INFO)
        os.makedirs(log_dir, exist_ok=True)
        self.handler = logging.FileHandler(os.path.join(log_dir, f"{filename}.log"))
        self.handler.setLevel(logging.INFO)
        self.handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        # avoid duplicate handlers when multiple runs share a module name
        self.logger.handlers = []
        self.logger.addHandler(self.handler)
        self.logger.propagate = False

    def add(self, text: Union[str, Iterable[str]]) -> None:
        if not isinstance(text, str):
            text = "".join(text)
        self.logger.info(text)
