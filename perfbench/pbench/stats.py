"""Percentiles as the benchmark defines them: nearest rank over every value
given (``sorted(v)[ceil(q/100 n) - 1]``), so a tail is a served request's
own number, never an interpolation between two."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def pct(values: Sequence[float], q: float) -> Optional[float]:
    v = sorted(values)
    if not v:
        return None
    return float(v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)])
