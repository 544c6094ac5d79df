"""Load predictors (copy of ``dynamo_tpu.planner.predictors``): last value,
windowed mean and linear-trend extrapolation, one adjustment interval
ahead.
"""

from __future__ import annotations

from collections import deque


class ConstantPredictor:
    """Next value = last observed value."""

    def __init__(self, **_):
        self._last = 0.0

    def observe(self, value: float) -> None:
        self._last = float(value)

    def predict(self) -> float:
        return self._last


class MovingAveragePredictor:
    """Next value = mean of the last ``window`` observations."""

    def __init__(self, window: int = 8, **_):
        self._values: deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        self._values.append(float(value))

    def predict(self) -> float:
        return sum(self._values) / len(self._values) if self._values else 0.0


class LinearTrendPredictor:
    """Least-squares linear extrapolation one step ahead over the window
    (clamped at zero). Reacts to ramps the averaging predictors lag on."""

    def __init__(self, window: int = 8, **_):
        self._values: deque[float] = deque(maxlen=max(2, window))

    def observe(self, value: float) -> None:
        self._values.append(float(value))

    def predict(self) -> float:
        n = len(self._values)
        if n == 0:
            return 0.0
        if n == 1:
            return self._values[0]
        xs = range(n)
        mean_x = (n - 1) / 2
        mean_y = sum(self._values) / n
        denom = sum((x - mean_x) ** 2 for x in xs)
        slope = sum((x - mean_x) * (y - mean_y)
                    for x, y in zip(xs, self._values)) / denom
        return max(0.0, mean_y + slope * (n - mean_x))


PREDICTORS = {
    "constant": ConstantPredictor,
    "moving_average": MovingAveragePredictor,
    "linear": LinearTrendPredictor,
}


def make_predictor(name: str, **kw):
    if name not in PREDICTORS:
        raise ValueError(f"unknown predictor {name!r}; have {sorted(PREDICTORS)}")
    return PREDICTORS[name](**kw)
