"""The reference's benchmark protocol and the relative comparison with
sklearn, on the port's `fit` (twin of sgdnet_tpu/benchmarks)."""

from sgdnet_tpu_torch.benchmarks.convergence import convergence_curve, run_reference_protocol
from sgdnet_tpu_torch.benchmarks.relative import normalize_curves, run_relative, sklearn_curve

__all__ = [
    "convergence_curve",
    "run_reference_protocol",
    "run_relative",
    "sklearn_curve",
    "normalize_curves",
]
