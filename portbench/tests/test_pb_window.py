"""The measured window: whole units, and a window that is their exact sum."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import window  # noqa: E402


class Clock:
    """A clock that each unit advances by its own duration."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_whole_units_until_the_seconds_are_reached():
    clock = Clock()
    durations = [0.375, 0.25, 0.5, 0.125, 0.625]
    seen = []

    def unit(i):
        seen.append(i)
        clock.now += durations[i]

    times = window.run(unit, 1.0, sync=lambda: None, clock=clock)
    # 0.375 + 0.25 < 1.0, + 0.5 reaches it: three whole units, no part of a fourth
    assert seen == [0, 1, 2]
    assert times == durations[:3]
    assert sum(times) == 1.125


def test_max_units_and_untimed_hooks():
    clock = Clock()
    order = []

    def unit(i):
        order.append(("unit", i))
        clock.now += 1.0

    def before(i):
        order.append(("before", i))
        clock.now += 100.0  # outside the window

    times = window.run(unit, 50.0, sync=lambda: None, max_units=2, before=before,
                       after=lambda i: order.append(("after", i)), clock=clock)
    assert times == [1.0, 1.0]
    assert order == [("before", 0), ("unit", 0), ("after", 0),
                     ("before", 1), ("unit", 1), ("after", 1)]


def test_each_unit_is_timed_between_two_syncs():
    calls = []
    window.run(lambda i: calls.append("unit"), 1e-9, sync=lambda: calls.append("sync"),
               max_units=1)
    assert calls == ["sync", "unit", "sync"]


def test_the_window_holds_whole_rounds():
    clock = Clock()

    def unit(i):
        clock.now += 1.0

    # 2.5 s are reached after 3 units; rounds of 2 make it 4
    assert window.run(unit, 2.5, sync=lambda: None, whole=2, clock=clock) == [1.0] * 4
