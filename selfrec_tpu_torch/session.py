"""Session entry point (counterpart of ``selfrec_tpu/session.py``).

Equivalent of the reference ``SELFRec`` dispatcher
(reference/SELFRec.py:4-25): load raw train/test (and social) data once,
construct the model class from the registry on ``device``, run its
pipeline.
"""

from __future__ import annotations

from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.data import io
from selfrec_tpu_torch.device import resolve_device
from selfrec_tpu_torch.models import MODEL_REGISTRY, get_model_class


class SelfRecTorch:
    """``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the CPU."""

    def __init__(self, config: ModelConf, device=None, training_data=None,
                 test_data=None):
        self.config = config
        self.device = resolve_device(device)
        rec_type = config["model"]["type"]
        self.training_data = training_data
        if self.training_data is None and rec_type == "graph":
            # array-native fast path: native loader + Interaction's mapped
            # constructor
            self.training_data = io.load_graph_mapped(config["training.set"])
        if self.training_data is None:
            self.training_data = io.load_data_set(config["training.set"], rec_type)
        self.test_data = test_data
        if self.test_data is None:
            self.test_data = io.load_data_set(config["test.set"], rec_type)
        # the social models' relations (MHCN, SEPT), as session.py:36-38
        self.kwargs = {}
        if config.contain("social.data"):
            self.kwargs["social.data"] = io.load_social_data(config["social.data"])
        print("Reading data and preprocessing...")

    def execute(self):
        cls = get_model_class(self.config["model"]["name"])
        recommender = cls(self.config, self.training_data, self.test_data,
                          device=self.device, **self.kwargs)
        return recommender.execute()


def available_models():
    return sorted(MODEL_REGISTRY)
