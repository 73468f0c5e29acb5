r"""Tracing of the port: spans, counters, host waits and the device trace.

Port of ``renormalizer_tpu/utils/profiling.py``, with the port's own tracer.

**Spans.**  ``with span("eig"): ...`` times one layer of the program on the
host clock (``time.perf_counter_ns``) while :data:`TRACING` is true, and
appends ``(name, parent, start_ns, end_ns)`` to :data:`SPANS` when it closes
(``parent`` is the name of the innermost span open when it opened, or None).
With tracing off, :func:`span` tests one flag and returns a shared no-op: it
allocates nothing.  A span makes no device sync and no CUDA event, and is
not a ``torch.profiler`` range.  :data:`TRACING` is a module attribute:
readers switch it with ``setattr`` and read :data:`SPANS` when they want
them; :func:`maybe_profile` switches it on for its own call.

**Clock anchors.**  While tracing and while a ``torch.profiler`` records, a
span that opens at depth 0 or 1 (``dmrg.solve``, ``tdvp.step`` and their
``dmrg.sweep`` or ``tdvp.visit`` children) first emits one zero-length
``record_function`` named :data:`ANCHOR` and notes the host clock inside it
in :data:`ANCHORS`.  The k-th entry of :data:`ANCHORS` is the k-th
:data:`ANCHOR` event of the profile: a reader pairs them to map span times
onto the profile's clock (:func:`anchor_offsets_us`).

**Counters.**  :data:`COUNTERS` holds every counter of the port, named
``layer.what``, whether tracing is on or off; an increment is one dict
update.  Readers take :func:`snapshot` before and :func:`delta` after.

**Host waits.**  While tracing, from the opening of an outermost span to its
close, each host wait on the device is counted as ``waits.<span>`` under the
innermost open span: torch's synchronizing calls through its sync debug mode
(``torch.cuda.set_sync_debug_mode("warn")``, whose warnings a hook counts
and swallows; :data:`COUNT_WAITS` false leaves the mode alone), and through
:func:`count_wait` at the call site the waits the mode does not report: the
port's own ``Event.synchronize`` calls, and cuSOLVER's read of its host
workspace inside ``torch.linalg.eigh`` and ``torch.linalg.svd`` of a CUDA
matrix (one per matrix).  ``torch.cuda.synchronize`` and waits inside other
library calls are not seen.  The mode and the warnings state are restored
when the outermost span closes.

**Device trace.**  With ``RENO_PROFILE=/path/to/dir`` the wrapped entry points
(``optimize_mps``, ``optimize_ttns``, ``Mps.evolve``) run under
``torch.profiler`` with CPU and CUDA activity and with tracing on, and the
trace is exported as a Chrome trace (Perfetto, chrome://tracing) to
``dir/tag/trace.json``, the spans added as complete events on the profile's
timeline.  A later call of the same entry point replaces the file.  Nothing
happens when the variable is unset, or inside another profiler.
"""

import collections
import contextlib
import json
import logging
import os
import time
import warnings

import torch

logger = logging.getLogger(__name__)

TRACING = False
COUNT_WAITS = True
ANCHOR = "reno.clock"
SPAN_TID = 999999999  # the spans' own track in an exported trace

SPANS = []
ANCHORS = []
COUNTERS = collections.Counter()

_STACK = []  # names of the open spans, innermost last
_SYNC_WARNING = "called a synchronizing CUDA operation"


def snapshot() -> dict:
    """The counters as they stand."""
    return dict(COUNTERS)


def delta(before: dict) -> collections.Counter:
    """Each counter's growth since ``before`` (a :func:`snapshot`)."""
    return collections.Counter({k: v - before.get(k, 0) for k, v in COUNTERS.items()
                                if v != before.get(k, 0)})


def clear():
    """Forget the recorded spans and anchors."""
    SPANS.clear()
    ANCHORS.clear()


def count_wait(n: int = 1):
    """Count ``n`` host waits that torch's sync debug mode does not see
    under the innermost open span."""
    if TRACING and _STACK:
        COUNTERS["waits." + _STACK[-1]] += n


class _WaitHook:
    """Torch's sync debug mode at "warn", with each of its warnings counted
    under the innermost open span and swallowed."""

    def __init__(self):
        self._mode = torch.cuda.get_sync_debug_mode()
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        shown = warnings.showwarning
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        # torch says once per process that the mode is a prototype
        warnings.filterwarnings("ignore", message="Synchronization debug mode")

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(_SYNC_WARNING):
                if _STACK:
                    COUNTERS["waits." + _STACK[-1]] += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")

    def remove(self):
        torch.cuda.set_sync_debug_mode(self._mode)
        self._warnings.__exit__(None, None, None)


def _anchor():
    with torch.autograd.profiler.record_function(ANCHOR):
        ANCHORS.append(time.perf_counter_ns())


class _Span:
    __slots__ = ("name", "parent", "start", "hook")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        depth = len(_STACK)
        self.parent = _STACK[-1] if depth else None
        self.hook = (_WaitHook() if depth == 0 and COUNT_WAITS
                     and torch.cuda.is_initialized() else None)
        if depth <= 1 and torch.autograd.profiler._is_profiler_enabled:
            _anchor()
        _STACK.append(self.name)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _STACK.pop()
        SPANS.append((self.name, self.parent, self.start, end))
        if self.hook is not None:
            self.hook.remove()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager that records ``name``'s span while tracing."""
    if not TRACING:
        return _NO_SPAN
    return _Span(name)


def anchor_offsets_us(event_mids_us, anchors_ns=None):
    """Offsets (profile clock minus span clock, in microseconds) of the
    anchors, from the midpoints of the profile's :data:`ANCHOR` events in
    order; None unless both sides hold the same number of anchors."""
    anchors_ns = ANCHORS if anchors_ns is None else anchors_ns
    if not anchors_ns or len(event_mids_us) != len(anchors_ns):
        return None
    return [mid - a / 1e3 for mid, a in zip(sorted(event_mids_us), anchors_ns)]


def _add_spans(path, spans, anchors):
    """Write ``spans`` into the Chrome trace at ``path`` as complete events
    on the profile's timeline, each shifted by the anchor nearest its start."""
    with open(path) as f:
        trace = json.load(f)
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("name") == ANCHOR and e.get("ph") == "X"),
                    key=lambda e: e["ts"])
    offsets = anchor_offsets_us([e["ts"] + e.get("dur", 0) / 2 for e in events], anchors)
    if offsets is None:
        logger.warning(f"{len(events)} clock anchors in the profile, {len(anchors)} "
                       "recorded: the spans are left out of the trace")
        return
    pid, tid = events[0]["pid"], SPAN_TID
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "reno spans"}}]
    for name, parent, start, end in spans:
        k = min(range(len(anchors)), key=lambda i: abs(anchors[i] - start))
        out.append({"ph": "X", "cat": "reno_span", "name": name, "pid": pid, "tid": tid,
                    "ts": start / 1e3 + offsets[k], "dur": (end - start) / 1e3,
                    "args": {"parent": parent}})
    trace["traceEvents"].extend(out)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def maybe_profile(tag: str = ""):
    global TRACING
    trace_dir = os.environ.get("RENO_PROFILE")
    if not trace_dir or torch.autograd.profiler._is_profiler_enabled:
        yield
        return
    path = os.path.join(trace_dir, tag) if tag else trace_dir
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info(f"capturing a device trace to {path}")
    was, first, first_anchor = TRACING, len(SPANS), len(ANCHORS)
    TRACING = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        TRACING = was
        spans, anchors = SPANS[first:], ANCHORS[first_anchor:]
        if not was:
            # recorded for this trace only
            del SPANS[first:], ANCHORS[first_anchor:]
    os.makedirs(path, exist_ok=True)
    file = os.path.join(path, "trace.json")
    prof.export_chrome_trace(file)
    _add_spans(file, spans, anchors)
