from sgdnet_tpu_torch.families.families import (
    Binomial,
    Family,
    Gaussian,
    Multinomial,
    MultivariateGaussian,
    Poisson,
    get_family,
    lambda_max_offset,
)

__all__ = [
    "Family",
    "Gaussian",
    "Binomial",
    "Poisson",
    "Multinomial",
    "MultivariateGaussian",
    "get_family",
    "lambda_max_offset",
]
