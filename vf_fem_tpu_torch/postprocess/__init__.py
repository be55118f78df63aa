from . import base, fluid, solid
from .base import (
    BaseDerivedStateHistoryMeasure,
    BaseDerivedStateMeasure,
    BaseStateHistoryMeasure,
    BaseStateMeasure,
    TimeSeries,
    TimeSeriesStats,
)
