"""Margin-softmax heads and step-keyed schedules of the port."""

from .projections import PROJECTION_NAMES, MarginProjection, margin_ce  # noqa: F401
from . import schedules  # noqa: F401
