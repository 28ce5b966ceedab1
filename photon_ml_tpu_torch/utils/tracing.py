"""Profiling hooks (counterpart of ``photon_ml_tpu/utils/tracing.py``).

The drivers' ``--profile-dir`` captures a ``torch.profiler`` trace of
training: host activity always, the card's kernels too when CUDA is in
use, exported as one Chrome-trace JSON file that Perfetto or
``chrome://tracing`` loads. The JAX package's counterpart captures a JAX
profiler trace for TensorBoard. A profiler that fails to start or to
export raises: a profile asked for is never silently missing.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

__all__ = ["profile_trace", "annotate"]


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``trace_dir/profile-pid<pid>.json`` (no-op when ``trace_dir`` is
    falsy). CUDA activity is recorded when CUDA is initialized or
    available."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"profile-pid{os.getpid()}.json")
    with open(path, "w"):  # an unwritable directory raises before the run
        pass
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named range inside an active profile
    (``torch.profiler.record_function``); usable as a context manager."""
    return torch.profiler.record_function(name)
