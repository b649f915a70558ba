"""sgdnet_tpu_torch — elastic-net GLMs via batched SAGA on PyTorch and CUDA.

The PyTorch port of `sgdnet_tpu`, module for module, for NVIDIA Hopper
GPUs: plain tensor code is torch, and every Pallas kernel of the JAX
package is a hand-written CUDA kernel (csrc/, built with nvcc at first
use).  This package imports neither `jax` nor `sgdnet_tpu`.
"""

from sgdnet_tpu_torch.api.fit import SgdnetFit, fit
from sgdnet_tpu_torch.api.predict import predict
from sgdnet_tpu_torch.api.score import score
from sgdnet_tpu_torch.core.layout import LayoutPlan, plan_layout
from sgdnet_tpu_torch.core.sparse import PaddedCSR
from sgdnet_tpu_torch.data import load_abalone, load_dataset, load_heart, load_student, load_wine

__version__ = "0.1.0"

__all__ = [
    "fit", "predict", "score", "SgdnetFit", "PaddedCSR", "cv_fit",
    "plan_layout", "LayoutPlan",
    "load_dataset", "load_abalone", "load_heart", "load_wine", "load_student",
]


def cv_fit(*args, **kwargs):
    """k-fold cross-validation (api/cv.py `cv_fit`, loaded at first call)."""
    from sgdnet_tpu_torch.api.cv import cv_fit as _cv_fit

    return _cv_fit(*args, **kwargs)
