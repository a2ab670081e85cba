"""Requests of a traffic mix.  A mix is a data file,
``hgbench/traffic/<mix>.json``: its ``driver`` names the kind of request
(``hgbench/drivers/<driver>.py``) and its ``times`` object says how each
request's timepoints are drawn.  ``times.pick`` names the sampler,
``hgbench/samplers/<pick>.py``, which defines ``requests(times, tmax,
rng)``: endless requests over a history whose last event is at ``tmax``,
each a list of distinct timepoints.

The same seed and stream give the same requests.
"""
from __future__ import annotations

from types import ModuleType
from typing import Iterator

import numpy as np

WINDOW, WARMUP = 0, 1      # the streams: the measured requests, the warm-up


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of one seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def requests(sampler: ModuleType, mix: dict, tmax: int, seed: int,
             stream: int = WINDOW) -> Iterator[list[int]]:
    """Endless requests of ``mix``, drawn by its ``sampler``."""
    return sampler.requests(mix["times"], tmax, rng_for(seed, stream))
