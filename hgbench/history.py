"""A generated history: plain arrays of events in the order a generator
makes them.

The set-up hands them to the program's ``GraphHistoryBuilder``
(``hgbench/program.py``) and the reference replays them itself
(``hgbench/reference/``); neither side sees what the other made of them.
Each generator is a file of its own, ``hgbench/generators/<name>.py``,
found by the name a configuration gives under ``history.generator``: it
defines ``generate(params, seed) -> History``, ``params`` being the
configuration's ``history`` object.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ADD_NODE, ADD_EDGE, DEL_EDGE, TRANSIENT_EDGE, SET_NODE_ATTR = range(5)


@dataclasses.dataclass
class History:
    """Events in generation order (times never decrease).

    ``a``: the node id (``ADD_NODE``, ``SET_NODE_ATTR``), the first end
    (``ADD_EDGE``, ``TRANSIENT_EDGE``) or the edge number (``DEL_EDGE``:
    edges are numbered by their ``ADD_EDGE`` / ``TRANSIENT_EDGE`` event, in
    order).  ``b``: the second end, or the attribute column.  ``value``:
    the attribute's value, NaN elsewhere."""
    time: np.ndarray     # int64[M]
    kind: np.ndarray     # int8[M]
    a: np.ndarray        # int64[M]
    b: np.ndarray        # int64[M]
    value: np.ndarray    # float32[M]
    n_attrs: int

    def __len__(self) -> int:
        return int(self.time.shape[0])


def event_times(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` sorted uniform integer times in ``[0, 10 n)``, as the
    program's generators draw them."""
    return np.sort(rng.integers(0, n * 10, n).astype(np.int64))
