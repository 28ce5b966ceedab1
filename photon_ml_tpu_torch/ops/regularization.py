"""L1 / L2 / elastic-net regularization contexts (a copy of
``photon_ml_tpu/ops/regularization.py``, which is host-side Python).

The L2 part is folded analytically into the smooth objective (value,
gradient, Hessian); the L1 part is not part of the smooth objective and is
handled by the OWL-QN optimizer. Elastic net splits the regularization
weight by ``alpha``: L1 gets ``alpha * lambda``, L2 gets
``(1 - alpha) * lambda``.
"""

from __future__ import annotations

import dataclasses
import enum


class RegularizationType(str, enum.Enum):
    NONE = "none"
    L1 = "l1"
    L2 = "l2"
    ELASTIC_NET = "elastic_net"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    reg_type: RegularizationType = RegularizationType.NONE
    # elastic-net mixing in [0,1]: fraction of the weight that is L1.
    alpha: float = 0.5

    def __post_init__(self):
        object.__setattr__(self, "reg_type", RegularizationType(self.reg_type))
        if not (0.0 <= self.alpha <= 1.0):
            raise ValueError(
                f"elastic-net alpha must be in [0,1], got {self.alpha}")

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L1:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return self.alpha * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L2:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return (1.0 - self.alpha) * reg_weight
        return 0.0

    @property
    def needs_owlqn(self) -> bool:
        return self.reg_type in (RegularizationType.L1,
                                 RegularizationType.ELASTIC_NET)


def screening_threshold(rule: str, lam_l1: float, lam_l1_prev: float,
                        slack: float = 0.0) -> float:
    """Sequential screening threshold for a pathwise fixed-effect solver: a
    feature whose data-gradient magnitude at the previous lambda's solution
    falls below the returned value is frozen at zero for the restricted
    solve at ``lam_l1``.

    * ``"strong"``: the sequential strong rule of Tibshirani et al.,
      ``2*l1 - l1_prev`` (unit-slope growth of ``|g_j|`` along the path).
    * ``"safe"``: double the strong rule's guard band,
      ``l1 - 2*(l1_prev - l1)``.

    ``slack`` inflates the threshold by ``slack * (l1_prev - l1)`` to
    over-screen on purpose (0 = the published rules). A non-positive
    return means nothing can be screened at this step."""
    gap = lam_l1_prev - lam_l1
    if rule == "strong":
        base = lam_l1 - gap
    elif rule == "safe":
        base = lam_l1 - 2.0 * gap
    else:
        raise ValueError(f"unknown screening rule {rule!r}; "
                         "known: strong, safe")
    return base + slack * gap


def kkt_slack(lam_l1: float, kkt_tol: float) -> float:
    """Absolute slack for the screened-coordinate KKT test: a frozen
    coordinate with ``|g_j| > lam_l1 + kkt_slack`` is a violator. Relative
    in the L1 weight with a unit floor."""
    return kkt_tol * max(lam_l1, 1.0)
