"""Statistics over all the statements of a window."""

from __future__ import annotations

import statistics


def percentile(values, q: int) -> float | None:
    """The ``q``-th percentile (1..99) of all ``values``, interpolated
    between order statistics (``statistics.quantiles``, inclusive);
    ``None`` for an empty list."""
    values = list(values)
    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100,
                                      method="inclusive")[q - 1])

