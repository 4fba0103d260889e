"""selfrec_tpu_torch — the PyTorch/CUDA port of selfrec_tpu.

A second package beside the JAX one, with the same module layout and
names so each module's counterpart is easy to find. Plain tensor code is
PyTorch; the kernels that selfrec_tpu wrote in Pallas for the TPU are
hand-written CUDA C++ for Hopper (``csrc/``), built at first use. The
host layer (config, data, metrics) is a copy, not an import: this package
imports neither ``jax`` nor anything under ``selfrec_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:

    from selfrec_tpu_torch import SelfRecTorch, ModelConf
    SelfRecTorch(ModelConf('conf/SimGCL.yaml')).execute()

or ``python -m selfrec_tpu_torch --conf conf/SimGCL.yaml --device cuda``.
"""

from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.session import SelfRecTorch

__version__ = "0.1.0"

__all__ = ["ModelConf", "SelfRecTorch", "__version__"]
