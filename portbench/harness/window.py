"""The measured window: whole units of work, back to back, until their summed
time reaches the run's seconds.  The window is the exact sum of the units'
times, each taken by the host clock between two device syncs."""

import time


def run(unit, seconds, sync, max_units=None, whole=1, before=None, after=None,
        clock=time.perf_counter):
    """Run ``unit(i)`` for i = 0, 1, ... until the units' summed time reaches
    ``seconds`` and their number is a multiple of ``whole`` (or until
    ``max_units`` units ran).  ``before(i)``/``after(i)`` run outside the
    timed part.  Returns each unit's seconds."""
    times = []
    while ((sum(times) < seconds or len(times) % whole)
           and (max_units is None or len(times) < max_units)):
        i = len(times)
        if before is not None:
            before(i)
        sync()
        t0 = clock()
        unit(i)
        sync()
        times.append(clock() - t0)
        if after is not None:
            after(i)
    return times
