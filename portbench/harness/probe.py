"""What a traced run gives the per-layer metric readers.

A reader (``metrics/<name>.py``) may define ``install(probe)``, called before
the traced window, to wrap a name the program calls (``probe.patch``) or to
note a counter's start (``probe.state``), and defines ``read(probe)``, called
after it, which returns the metric's value or ``None`` where it found nothing
to read.  ``probe.trace`` is the reduced ``torch.profiler`` record of the
window (:class:`Trace`), ``probe.units`` the units in it and
``probe.window_s`` their summed seconds.
"""

import bisect
import collections

# runtime calls in which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


class Probe:
    def __init__(self):
        self.state = {}
        self.units = 0
        self.window_s = 0.0
        self.trace = None
        self.harness_syncs = 0  # the harness's own device syncs in the window
        self._patches = []

    def patch(self, owner, name, new):
        """Replace ``owner.name`` by ``new`` until :meth:`restore`."""
        self._patches.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def restore(self):
        while self._patches:
            owner, name, old = self._patches.pop()
            setattr(owner, name, old)


class Trace:
    """Device kernels, host runtime calls and top-level host operators of a
    ``torch.profiler`` run, times in microseconds of the profiler's clock."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.kernels = []   # (name, start, end) of every device operation
        self.syncs = 0      # host waits on the device (SYNC_CALLS)
        top = []            # (start, end, name) of top-level host operators
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                self.kernels.append((e.name, start, end))
            elif e.name in SYNC_CALLS:
                self.syncs += 1
            elif e.cpu_parent is None:
                top.append((start, end, e.name))
        top.sort()
        self._top = top
        self._top_starts = [t[0] for t in top]

    def busy_intervals(self):
        """The union of the device operations' intervals, in order."""
        merged = []
        for _, start, end in sorted(self.kernels, key=lambda k: k[1]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_s(self):
        return sum(end - start for start, end in self.busy_intervals()) / 1e6

    def seconds_where(self, pick):
        """Device seconds of the operations whose name ``pick`` accepts."""
        return sum(end - start for name, start, end in self.kernels if pick(name)) / 1e6

    def device_ops(self, top=10):
        per = collections.Counter()
        for name, start, end in self.kernels:
            per[name] += (end - start) / 1e6
        return [[name, s] for name, s in per.most_common(top)]

    def _host_at(self, t):
        i = bisect.bisect_right(self._top_starts, t) - 1
        if i >= 0 and self._top[i][1] >= t:
            return self._top[i][2]
        return "host outside any operator"

    def idle_gaps(self, top=10):
        """Idle device time between operations, by the top-level host
        operator running at each gap's midpoint."""
        per = collections.Counter()
        busy = self.busy_intervals()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            per[self._host_at((a + b) / 2)] += (b - a) / 1e6
        return [[name, s] for name, s in per.most_common(top)]
