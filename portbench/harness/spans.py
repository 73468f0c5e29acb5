"""The program's own spans and counters, read against the device trace.

The program (``renormalizer_tpu_torch.utils.profiling``) records spans
``(name, parent, start_ns, end_ns)`` on its host clock while its ``TRACING``
flag is on.  While a profiler records, a span that opens at depth 0 or 1
first emits a zero-length ``reno.clock`` operator and notes its own clock
inside it (an anchor).  :func:`install` turns the flag on for the traced
window and notes the counters; :func:`idle_by_span` pairs the k-th anchor
with the k-th ``reno.clock`` top-level event of the profile, moves the
device's idle gaps onto the span clock by the offset of the nearest anchor,
and splits each gap by the innermost open span.  A program without the
tracer, or a run without device time, reads as None.
"""

import bisect
import math
import statistics
import sys

ANCHOR = "reno.clock"


def _tracer():
    from renormalizer_tpu_torch.utils import profiling

    if not all(hasattr(profiling, a) for a in ("TRACING", "SPANS", "ANCHORS", "COUNTERS")):
        return None
    return profiling


def install(probe):
    """Tracing on until ``probe.restore()``, the spans cleared and the
    counters noted; once per probe."""
    if "spans" in probe.state:
        return
    tracer = probe.state["spans"] = _tracer()
    if tracer is None:
        return
    tracer.clear()
    probe.patch(tracer, "TRACING", True)
    probe.state["spans.counters"] = tracer.snapshot()


def _device_time(probe):
    return bool(probe.trace.kernels)


def counter_delta(probe):
    """The growth of the program's counters over the window, or None."""
    tracer = probe.state.get("spans")
    if tracer is None or not _device_time(probe):
        return None
    return tracer.delta(probe.state["spans.counters"])


def segments(spans):
    """The union of properly nested spans as ordered pieces ``(start, end,
    innermost, outermost)``: each piece lies in the innermost span open
    there and in the outermost span that holds it."""
    out, stack = [], []  # stack: (end, name) of the open spans
    cursor, root = None, None

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name, root))

    for name, _, start, end in sorted(spans, key=lambda s: (s[2], -s[3])):
        while stack and stack[-1][0] <= start:
            top_end, top_name = stack.pop()
            emit(cursor, top_end, top_name)
            cursor = top_end
        if stack:
            emit(cursor, start, stack[-1][1])
        else:
            root = name
        cursor = start
        stack.append((end, name))
    while stack:
        top_end, top_name = stack.pop()
        emit(cursor, top_end, top_name)
        cursor = top_end
    return out


def idle_gaps(busy):
    """The complement of the ordered busy intervals: the gaps between them,
    with an open gap before the first and after the last."""
    edges = [-math.inf] + [t for interval in busy for t in interval] + [math.inf]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def to_span_clock(t_us, anchor_us, offsets_us):
    """A time of the profile (us) on the span clock (ns), by the offset of
    the anchor nearest to it (``anchor_us``: the anchors on the profile's
    clock, in order)."""
    if math.isinf(t_us):
        return t_us
    i = bisect.bisect_left(anchor_us, t_us)
    if i == len(anchor_us) or (i > 0 and t_us - anchor_us[i - 1] < anchor_us[i] - t_us):
        i -= 1
    return (t_us - offsets_us[i]) * 1e3


def split_gaps(gaps_ns, pieces):
    """Seconds of each ``(outermost, innermost)`` pair of span names that
    the gaps overlap; both lists ordered and each without overlaps."""
    out, j = {}, 0
    for a, b in gaps_ns:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            start, end, name, root = pieces[k]
            overlap = min(b, end) - max(a, start)
            if overlap > 0:
                out[(root, name)] = out.get((root, name), 0.0) + overlap / 1e9
            k += 1
    return out


def anchor_offsets(probe, anchors_ns):
    """Each anchor's offset (profile clock minus span clock, us) and its
    time on the profile's clock; None unless the profile holds as many
    anchor events as the program recorded."""
    events = sorted((start, end) for start, end, name in getattr(probe.trace, "_top", ())
                    if name == ANCHOR)
    if not anchors_ns or len(events) != len(anchors_ns):
        return None
    mids = [(start + end) / 2 for start, end in events]
    return [m - a / 1e3 for m, a in zip(mids, anchors_ns)], mids


def idle_by_span(probe):
    """Device-idle seconds of the traced window by ``(outermost,
    innermost)`` span name; None without the tracer, device time, spans or
    paired anchors.  Computed once per probe."""
    if "spans.idle" not in probe.state:
        probe.state["spans.idle"] = _idle_by_span(probe)
    return probe.state["spans.idle"]


def _idle_by_span(probe):
    tracer = probe.state.get("spans")
    if tracer is None or not _device_time(probe) or not tracer.SPANS:
        return None
    anchors = list(tracer.ANCHORS)
    paired = anchor_offsets(probe, anchors)
    if paired is None:
        print(f"[portbench] spans: {len(anchors)} anchors recorded, the profile's "
              "do not pair with them", file=sys.stderr, flush=True)
        return None
    offsets, mids = paired
    gaps = [(to_span_clock(a, mids, offsets), to_span_clock(b, mids, offsets))
            for a, b in idle_gaps(probe.trace.busy_intervals())]
    idle = split_gaps(gaps, segments(tracer.SPANS))
    window_idle = probe.window_s - probe.trace.busy_s()
    steps = [abs(b - a) for a, b in zip(offsets, offsets[1:])] or [0.0]
    waits = sorted((k, n) for k, n in counter_delta(probe).items() if k.startswith("waits."))
    print(f"[portbench] spans: {len(tracer.SPANS)} spans, {len(anchors)} anchors over "
          f"{(mids[-1] - mids[0]) / 1e6:.3f} s, anchor offset spread "
          f"{max(offsets) - min(offsets):.3f} us (median {statistics.median(offsets):.3f}, "
          f"largest step between neighbours {max(steps):.3f}); idle inside spans "
          f"{sum(idle.values()):.6f} s of the window's {window_idle:.6f} s; host waits "
          f"{dict(waits)}",
          file=sys.stderr, flush=True)
    return idle


def idle_per_unit(probe, root, names=None, exclude=()):
    """Idle seconds per unit under the outermost span ``root`` whose
    innermost span is in ``names`` (None: any) and not in ``exclude``."""
    idle = idle_by_span(probe)
    if idle is None:
        return None
    return sum(s for (r, name), s in idle.items()
               if r == root and (names is None or name in names)
               and name not in exclude) / probe.units
