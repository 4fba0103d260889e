"""Model registry (counterpart of ``selfrec_tpu/models/__init__.py``).

Lists every model name of the JAX package, with the same names and YAML
config sections; all 18 are ported.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

# name -> (module path, class name, model type)
MODEL_REGISTRY: Dict[str, Tuple[str, str, str]] = {
    "MF": ("selfrec_tpu_torch.models.graph.mf", "MF", "graph"),
    "LightGCN": ("selfrec_tpu_torch.models.graph.lightgcn", "LightGCN", "graph"),
    "DirectAU": ("selfrec_tpu_torch.models.graph.directau", "DirectAU", "graph"),
    "SimGCL": ("selfrec_tpu_torch.models.graph.simgcl", "SimGCL", "graph"),
    "XSimGCL": ("selfrec_tpu_torch.models.graph.xsimgcl", "XSimGCL", "graph"),
    "SGL": ("selfrec_tpu_torch.models.graph.sgl", "SGL", "graph"),
    "NCL": ("selfrec_tpu_torch.models.graph.ncl", "NCL", "graph"),
    "MixGCF": ("selfrec_tpu_torch.models.graph.mixgcf", "MixGCF", "graph"),
    "BUIR": ("selfrec_tpu_torch.models.graph.buir", "BUIR", "graph"),
    "SelfCF": ("selfrec_tpu_torch.models.graph.selfcf", "SelfCF", "graph"),
    "SSL4Rec": ("selfrec_tpu_torch.models.graph.ssl4rec", "SSL4Rec", "graph"),
    "UserKNN": ("selfrec_tpu_torch.models.graph.userknn", "UserKNN", "graph"),
    "ItemKNN": ("selfrec_tpu_torch.models.graph.itemknn", "ItemKNN", "graph"),
    "MHCN": ("selfrec_tpu_torch.models.graph.mhcn", "MHCN", "graph"),
    "SEPT": ("selfrec_tpu_torch.models.graph.sept", "SEPT", "graph"),
    "SASRec": ("selfrec_tpu_torch.models.sequential.sasrec", "SASRec", "sequential"),
    "CL4SRec": ("selfrec_tpu_torch.models.sequential.cl4srec", "CL4SRec", "sequential"),
    "BERT4Rec": ("selfrec_tpu_torch.models.sequential.bert4rec", "BERT4Rec", "sequential"),
}


def get_model_class(name: str):
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {name!r}. Available: {sorted(MODEL_REGISTRY)}")
    module_path, class_name, _ = MODEL_REGISTRY[name]
    return getattr(importlib.import_module(module_path), class_name)
