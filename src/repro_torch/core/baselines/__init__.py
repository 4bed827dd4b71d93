"""Measurement baselines of the port: ground truth on the card."""
from .directprobe import MeasuredPeak, measured_peak

__all__ = ["MeasuredPeak", "measured_peak"]
