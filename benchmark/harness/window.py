"""The measured window: whole calls, back to back, from one client.

Calls start until `seconds` have passed since the window opened; the call
in flight then finishes inside the window. A rate is the work of all the
calls that finished over all their time, so no call is cut in two and no
time is left out.
"""

from __future__ import annotations

import time
from typing import Callable, List


class Window:
    """Runs `call(i)` for i = 0, 1, ... until `seconds` have passed since
    the first started; each call must end with its work done (a device
    synchronisation). Records each call's start and end on the host clock."""

    def __init__(self, seconds: float, clock: Callable[[], float] = time.perf_counter):
        if seconds <= 0:
            raise ValueError(f"a window lasts more than 0 s, got {seconds}")
        self.seconds = float(seconds)
        self.clock = clock
        self.spans: List[tuple] = []

    def run(self, call: Callable[[int], None]) -> None:
        t0 = self.clock()
        i = 0
        while True:
            start = self.clock()
            call(i)
            end = self.clock()
            self.spans.append((start, end))
            i += 1
            if end - t0 >= self.seconds:
                return

    @property
    def calls(self) -> int:
        return len(self.spans)

    @property
    def elapsed(self) -> float:
        """From the first call's start to the last call's end."""
        return self.spans[-1][1] - self.spans[0][0] if self.spans else 0.0


def seconds_per_unit(elapsed: float, units: float) -> float:
    """All the window's time over all the units its calls finished."""
    if units <= 0:
        raise ValueError("a window that finished no work has no rate")
    return elapsed / units


def units_per_second(elapsed: float, units: float) -> float:
    if elapsed <= 0:
        raise ValueError("a window of no time has no rate")
    return units / elapsed
