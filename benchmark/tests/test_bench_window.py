"""The whole-unit window: at least one unit, never part of one."""

import pytest

from benchlib.window import end_to_end_value, run_window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def units_of(clock, durations):
    it = iter(durations)

    def unit():
        clock.t += next(it)
        return {"work": 12}
    return unit


@pytest.mark.parametrize("seconds,durations,n", [
    (50.0, [21.6, 21.7, 21.6], 2),   # a third would end at 65 s
    (45.0, [21.6, 21.7, 21.6], 2),   # the second ends at 43.3 s, within 45
    (43.0, [21.6, 21.7, 21.6], 1),   # judged by the first: the second would end at 43.2
    (1.0, [21.6, 21.7], 1),          # always one, however short the window
    (50.0, [16.5, 16.5, 16.6, 16.5], 3),
])
def test_whole_units(seconds, durations, n):
    clock = Clock()
    units, elapsed = run_window(units_of(clock, durations), seconds, clock)
    assert len(units) == n
    assert elapsed == pytest.approx(sum(durations[:n]))
    assert [u["seconds"] for u in units] == pytest.approx(durations[:n])


def test_values_count_whole_units_only():
    clock = Clock()
    units, elapsed = run_window(units_of(clock, [20.0, 22.0, 30.0]), 50.0, clock)
    assert end_to_end_value("work_per_s", units, elapsed) == pytest.approx(24 / 42.0)
    assert end_to_end_value("s_per_unit", units, elapsed) == pytest.approx(21.0)
    with pytest.raises(ValueError):
        end_to_end_value("tokens", units, elapsed)
