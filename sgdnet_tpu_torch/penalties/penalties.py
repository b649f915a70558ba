"""Penalty objects on torch tensors (twin of sgdnet_tpu/penalties/penalties.py).

A penalty is a whole-matrix proximal operator applied once per batched
SAGA step:

    w  <-  prox_{gamma * l1}( w * (1 - gamma * l2)  -  gamma * grad_est )
"""

from __future__ import annotations

import torch

from sgdnet_tpu_torch.core.linalg import soft_threshold


class Penalty:
    """Base: pure L2 is handled by the (1 - gamma*l2) decay in the solver."""

    name = "base"

    def prox(self, w: torch.Tensor, threshold) -> torch.Tensor:
        """Proximal operator of the non-smooth part; w is (k, p)."""
        raise NotImplementedError

    def value(self, w: torch.Tensor, pf=None) -> torch.Tensor:
        """The non-smooth objective term P1(w) (without its l1 multiplier),
        with optional (p,) per-feature penalty factors."""
        raise NotImplementedError


class Ridge(Penalty):
    """Pure L2: identity prox."""

    name = "ridge"

    def prox(self, w, threshold):
        return w

    def value(self, w, pf=None):
        return torch.zeros((), dtype=w.dtype, device=w.device)


class ElasticNet(Penalty):
    """Elementwise soft-thresholding."""

    name = "elastic_net"

    def prox(self, w, threshold):
        return soft_threshold(w, threshold)

    def value(self, w, pf=None):
        a = torch.abs(w)
        if pf is not None:
            a = a * pf
        return torch.sum(a)


class GroupLasso(Penalty):
    """Feature-column group prox: each feature's coefficient vector across
    classes is L2-shrunk or zeroed."""

    name = "group_lasso"

    def prox(self, w, threshold):
        norms = torch.sqrt(torch.sum(w * w, dim=0, keepdim=True))  # (1, p)
        factor = torch.clamp(1.0 - threshold / torch.clamp(norms, min=1e-300), min=0.0)
        return w * factor

    def value(self, w, pf=None):
        norms = torch.sqrt(torch.sum(w * w, dim=0))  # (p,)
        if pf is not None:
            norms = norms * pf
        return torch.sum(norms)


def select_penalty(elasticnet_mix: float, family: str, type_multinomial: str = "ungrouped") -> Penalty:
    """Ridge when the mix is 0; group lasso for mgaussian and grouped
    multinomial; elastic net otherwise."""
    if elasticnet_mix == 0.0:
        return Ridge()
    if family == "mgaussian" or (family == "multinomial" and type_multinomial == "grouped"):
        return GroupLasso()
    return ElasticNet()
