r"""Optional device tracing.

Port of ``renormalizer_tpu/utils/profiling.py``.  With
``RENO_PROFILE=/path/to/dir`` the wrapped driver (``optimize_mps``) runs
under ``torch.profiler`` with CPU and CUDA activity, and the trace is
exported as a Chrome trace (viewable in Perfetto or chrome://tracing) to
``dir/tag/trace.json``.  Nothing happens when the variable is unset.
"""

import contextlib
import logging
import os

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def maybe_profile(tag: str = ""):
    trace_dir = os.environ.get("RENO_PROFILE")
    if not trace_dir:
        yield
        return
    path = os.path.join(trace_dir, tag) if tag else trace_dir
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info(f"capturing a device trace to {path}")
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
