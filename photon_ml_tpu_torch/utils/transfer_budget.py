"""Host->device transfer budget (counterpart of
``photon_ml_tpu/utils/transfer_budget.py``).

Every streamed upload is charged here before its bytes move, so that a
configured budget makes an oversized or runaway transfer raise on the host
instead of flooding the device. Two limits, both in bytes:

- ``single``: the per-transfer cap (default 64 MB);
- ``total``: the per-process cap. A run that legitimately moves more
  declares it with :func:`waive` or a larger environment budget, so the
  waiver is visible where it is made.

Activation: :func:`set_budget`, or the ``PHOTON_TRANSFER_BUDGET_MB`` /
``PHOTON_TRANSFER_SINGLE_MB`` environment variables (read at first use).
With no budget configured every charge is a no-op.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

__all__ = [
    "TransferBudgetExceeded", "set_budget", "get_budget", "charge",
    "device_put", "waive", "set_activity_hook",
]

# Optional per-charge callback (no args), fired on every charge whether or
# not a budget is configured: a liveness signal for a watchdog that must
# not mistake a fit in the middle of a margin-ladder stream for a stall.
_activity_hook = None


def set_activity_hook(fn) -> None:
    """Install (or with ``None`` clear) a zero-arg callback fired on every
    budget charge, regardless of whether a budget is configured."""
    global _activity_hook
    _activity_hook = fn


class TransferBudgetExceeded(RuntimeError):
    """A sanctioned upload would exceed the process's transfer budget."""


class _Budget:
    def __init__(self, total: float, single: float, label: str = ""):
        self.total = float(total)
        self.single = float(single)
        self.label = label
        self.spent = 0.0
        self._lock = threading.Lock()

    def charge(self, nbytes: int, what: str = "") -> None:
        nbytes = int(nbytes)
        if nbytes > self.single:
            raise TransferBudgetExceeded(
                f"single host->device transfer of {nbytes/1e6:.1f} MB "
                f"exceeds the per-transfer cap {self.single/1e6:.1f} MB"
                f"{' [' + what + ']' if what else ''} — chunk it")
        with self._lock:
            if self.spent + nbytes > self.total:
                raise TransferBudgetExceeded(
                    f"transfer of {nbytes/1e6:.1f} MB would take this "
                    f"process to {(self.spent + nbytes)/1e6:.1f} MB, over "
                    f"the {self.total/1e6:.1f} MB budget"
                    f"{' [' + what + ']' if what else ''} — synthesize on "
                    "device, or waive explicitly (transfer_budget.waive / "
                    "PHOTON_TRANSFER_BUDGET_MB) if this run is meant to "
                    "move bulk data")
            self.spent += nbytes


_budget: Optional[_Budget] = None
_initialized = False


def _ambient() -> Optional[_Budget]:
    """Budget from the environment, if one is set."""
    mb = os.environ.get("PHOTON_TRANSFER_BUDGET_MB")
    if not mb:
        return None
    single = float(os.environ.get("PHOTON_TRANSFER_SINGLE_MB", "64"))
    return _Budget(float(mb) * 1e6, single * 1e6, label="env")


def set_budget(total_mb: Optional[float], single_mb: float = 64.0,
               label: str = "") -> None:
    """Install (or with ``None`` clear) the process transfer budget."""
    global _budget, _initialized
    _initialized = True
    _budget = (None if total_mb is None
               else _Budget(total_mb * 1e6, single_mb * 1e6, label))


def get_budget() -> Optional[_Budget]:
    global _budget, _initialized
    if not _initialized:
        _initialized = True
        _budget = _ambient()
    return _budget


def waive(extra_total_mb: float, reason: str) -> None:
    """Raise the total cap for a run that legitimately moves bulk data. The
    reason is mandatory so the waiver is auditable at the call site; the
    per-transfer cap stays."""
    b = get_budget()
    if b is not None:
        assert reason, "a transfer-budget waiver needs a reason"
        with b._lock:
            b.total += extra_total_mb * 1e6


def charge(nbytes: int, what: str = "") -> None:
    """Account ``nbytes`` of imminent host->device transfer against the
    budget (no-op when none is configured). Call BEFORE the upload."""
    if _activity_hook is not None:
        _activity_hook()
    b = get_budget()
    if b is not None and nbytes:
        b.charge(nbytes, what)


def device_put(x, device, dtype=None, what: str = "") -> torch.Tensor:
    """Budget-accounted copy of a host array to ``device`` as a tensor of
    ``dtype`` (default: the array's). The charged bytes are the bytes moved,
    after the cast. A tensor already on ``device`` with that dtype moves
    nothing and charges nothing; any other host object exposing the array
    protocol (memmaps, memoryviews, CPU tensors) is charged."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        dtype = x.dtype if dtype is None else dtype
        if x.device == device and x.dtype == dtype:
            return x
        charge(x.numel() * torch.empty((), dtype=dtype).element_size(),
               what or "device_put")
        return x.to(device=device, dtype=dtype)
    t = torch.tensor(np.asarray(x))
    if dtype is not None:
        t = t.to(dtype)
    charge(t.numel() * t.element_size(), what or "device_put")
    return t.to(device)
