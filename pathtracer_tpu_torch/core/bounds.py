"""1-D interval type for wavelength ranges (counterpart of `core/bounds.py`)."""

from __future__ import annotations

from typing import NamedTuple


class Bounds1D(NamedTuple):
    lower: float
    upper: float

    @property
    def span(self):
        return self.upper - self.lower


# Visible-spectrum wavelength ranges in nanometres.
BOUNDED_VISIBLE_RANGE = Bounds1D(380.0, 780.0)
EXTENDED_VISIBLE_RANGE = Bounds1D(370.0, 790.0)
