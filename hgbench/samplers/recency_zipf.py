"""One timepoint a request, skewed to recent times: the draw of the
program's snapshot-serving mode (``launch/serve.py --mode snapshots``),
copied.  ``distinct`` seeded times over the history, then a zipf(``zipf``)
rank from the newest for each request; rank 1 is the second newest time,
as in the original.

Mix keys (``times``): ``zipf``, ``distinct``.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

BLOCK = 1024               # ranks drawn at a time


def requests(spec: dict, tmax: int, rng: np.random.Generator
             ) -> Iterator[list[int]]:
    distinct = np.sort(rng.integers(0, tmax + 1, spec["distinct"]))
    top = distinct.size - 1
    while True:
        ranks = rng.zipf(spec["zipf"], BLOCK)
        for t in distinct[top - np.minimum(ranks, top)].tolist():
            yield [int(t)]
