"""Step factories of the port (serving steps; training comes later)."""
from .train_step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
