"""Host-side scalar schedules and the named beta-schedule presets.

Counterpart of the JAX package's ``train/schedules.py``: ConstantSchedule,
LinearSchedule, the 25 named presets of the original reference ('a'..'z',
no 't') and the ``warmupN`` ramp. A schedule returns a Python float, which
the train step takes as its beta.
"""
import numpy as np


class ConstantSchedule:
    def __init__(self, value):
        self.value = value

    def __call__(self, x):
        return float(self.value)


class LinearSchedule:
    """Clamped linear ramp from (start_x, start_y) to (end_x, end_y),
    descending ramps included."""

    def __init__(self, start_y, end_y, start_x, end_x):
        self.min_y = min(start_y, end_y)
        self.max_y = max(start_y, end_y)
        self.start_x = start_x
        self.start_y = start_y
        self.coef = (end_y - start_y) / (end_x - start_x)

    def __call__(self, x):
        return float(np.clip((x - self.start_x) * self.coef + self.start_y,
                             self.min_y, self.max_y))


# Named presets: (start_y, end_y, start_x, end_x) per schedule letter, from
# the original reference's table (there is deliberately no 't').
_PRESETS = {
    "a": (0.001, 1, 60000, 200000),
    "b": (0.001, 0.1, 60000, 200000),
    "c": (0.001, 0.01, 60000, 200000),
    "d": (0.001, 10, 60000, 200000),
    "e": (0.001, 0.1, 60000, 120000),
    "f": (0.001, 1, 60000, 120000),
    "g": (0.001, 0.3, 60000, 120000),
    "h": (0.001, 0.3, 30000, 60000),
    "i": (0.001, 1, 30000, 60000),
    "j": (0.001, 3, 30000, 60000),
    "k": (0.001, 10, 30000, 60000),
    "l": (0.001, 30, 30000, 60000),
    "m": (0.001, 3, 60000, 120000),
    "n": (0.001, 10, 60000, 120000),
    "o": (0.001, 30, 60000, 120000),
    "p": (0.001, 100, 60000, 120000),
    "q": (0.001, 10, 60000, 240000),
    "r": (0.001, 30, 60000, 600000),
    "s": (0.001, 3, 60000, 240000),
    "u": (3, 30, 60000, 120000),
    "v": (3, 30, 30000, 60000),
    "w": (1e-2, 1, 20000, 40000),
    "x": (7, 15, 250000, 750000),
    "y": (7, 20, 250000, 750000),
    "z": (7, 30, 250000, 750000),
}


def get_beta_schedule(schedule, beta):
    """A constant ``beta`` when ``schedule`` is None, a named preset, or
    ``warmupN``: a linear ramp 0 -> beta (1 if None) over the first N
    steps. N is read with ``int`` as the JAX package reads it, so
    ``warmup2_000`` is 2000 steps; a suffix that is no positive integer
    raises ``ValueError``."""
    if schedule is None and beta is not None:
        return ConstantSchedule(beta)
    if schedule in _PRESETS:
        return LinearSchedule(*_PRESETS[schedule])
    if schedule is not None and schedule.startswith("warmup"):
        try:
            steps = int(schedule[len("warmup"):])
        except ValueError:
            steps = 0
        if steps > 0:
            return LinearSchedule(0.0, beta if beta is not None else 1.0,
                                  0, steps)
    raise ValueError(
        f"Wrong beta schedule. Schedule={schedule}, beta={beta}")
