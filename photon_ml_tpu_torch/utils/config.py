"""Small runtime-config helpers shared by the CLI drivers (counterpart of
``photon_ml_tpu/utils/config.py``)."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# cudaGetErrorString texts of the errors that leave a process's CUDA context
# unusable ("sticky"): every later call on that context fails too, so only
# a new process can use the card again
_STICKY = (
    "an illegal memory access was encountered",  # cudaErrorIllegalAddress
    "unspecified launch failure",  # cudaErrorLaunchFailure
    "device-side assert triggered",  # cudaErrorAssert
    "uncorrectable ECC error",  # cudaErrorECCUncorrectable
    "uncorrectable NVLink error",  # cudaErrorNvlinkUncorrectable
    "an illegal instruction was encountered",  # cudaErrorIllegalInstruction
    "misaligned address",  # cudaErrorMisalignedAddress
    "invalid program counter",  # cudaErrorInvalidPc
    "hardware stack error",  # cudaErrorHardwareStackError
    "the launch timed out and was terminated",  # cudaErrorLaunchTimeout
    "operation not supported on global/shared address space",
    "fallen off the bus",  # Xid 79, reported by the driver
)


def resolve_dtype(name: str) -> torch.dtype:
    """Map a ``--dtype`` flag to a torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def cuda_error(name: str, text: str, where: str = "") -> RuntimeError:
    """The exception torch raises for a failed CUDA call (a
    ``torch.AcceleratorError``, message ``CUDA error: <text>``), for code
    that checks a CUDA runtime status itself: the hand kernels' launch and
    the injected device loss take the same path as torch's own errors."""
    msg = (f"CUDA error: {text}\nSearch for `{name}' in https://docs."
           "nvidia.com/cuda/cuda-runtime-api/group__CUDART__TYPES.html for "
           "more information.")
    if where:
        msg += f"\n{where}"
    # torch before 2.8 raises its CUDA errors as plain RuntimeErrors
    return getattr(torch, "AcceleratorError", RuntimeError)(msg)


def is_device_loss(exc: BaseException) -> bool:
    """True when an exception means the accelerator is lost to this
    process: a sticky CUDA error, after which the context cannot be used
    again in-process, so every driver converts it into an exit-75
    process-boundary retry. A non-sticky CUDA error (an invalid argument)
    and ``torch.OutOfMemoryError`` do not count. One predicate, shared by
    all drivers: refine detection here only.

    A coordinated abort (``resilience.PeerFailure``) counts when ANY
    process of the job reported device loss: every process must take the
    resume-marker exit path together, not only the one whose device died."""
    from photon_ml_tpu_torch.parallel.resilience import PeerFailure

    if isinstance(exc, PeerFailure):
        return exc.device_loss or (exc.__cause__ is not None
                                   and is_device_loss(exc.__cause__))
    if isinstance(exc, torch.OutOfMemoryError) or not isinstance(
            exc, RuntimeError):
        return False
    msg = str(exc)
    return "CUDA error" in msg and any(s in msg for s in _STICKY)
