"""The benchmark's plain reference (NumPy only; imports nothing of the
program)."""
from .replay import Replay, count_differing, weighted_total  # noqa: F401
