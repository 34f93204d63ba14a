"""mdbn_tpu_torch: the PyTorch/CUDA port of mdbn_tpu.

The RBM / DBN / MDBN ``train`` / ``transform`` API of ``mdbn_tpu`` on
PyTorch, with the fused CD training run as a hand-written CUDA kernel for
Hopper (``csrc/cd_train.cu``, built at first use). Imports ``torch`` and
never ``jax``; the JAX package stays beside it as the reference.
"""

from .config import (
    DBNConfig,
    MDBNConfig,
    RBMConfig,
    TrainRuntimeConfig,
    load_config,
    save_config,
)
from .models.dbn import DBN
from .models.mdbn import MDBN
from .models.rbm import RBM

__version__ = "0.1.0"

__all__ = [
    "RBM", "DBN", "MDBN",
    "RBMConfig", "DBNConfig", "MDBNConfig", "TrainRuntimeConfig",
    "load_config", "save_config",
]
