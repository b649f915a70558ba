"""sgdnet_tpu_torch — elastic-net GLMs via batched SAGA on PyTorch and CUDA.

The PyTorch port of `sgdnet_tpu`, module for module, for NVIDIA Hopper
GPUs: plain tensor code is torch, and the JAX package's two Pallas kernels
are hand-written CUDA kernels (csrc/, built with nvcc at first use).  This
package imports neither `jax` nor `sgdnet_tpu`.
"""

from sgdnet_tpu_torch.api.fit import SgdnetFit, fit
from sgdnet_tpu_torch.api.predict import predict
from sgdnet_tpu_torch.api.score import score
from sgdnet_tpu_torch.data import load_abalone, load_dataset, load_heart, load_student, load_wine

__version__ = "0.1.0"

__all__ = [
    "fit", "predict", "score", "SgdnetFit",
    "load_dataset", "load_abalone", "load_heart", "load_wine", "load_student",
]
