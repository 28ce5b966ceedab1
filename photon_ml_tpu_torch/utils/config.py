"""Small runtime-config helpers shared by the CLI drivers (counterpart of
``photon_ml_tpu/utils/config.py``)."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_dtype(name: str) -> torch.dtype:
    """Map a ``--dtype`` flag to a torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None
