"""Core of the paper's contribution: DeltaGraph + GraphPool.

Public surface of the port so far:

* :class:`~repro_torch.core.events.GraphHistoryBuilder` — ingest activity
* :class:`~repro_torch.core.deltagraph.DeltaGraph` — the hierarchical index
* :class:`~repro_torch.core.graphpool.GraphPool` — overlaid in-memory
  snapshots

The manager façade, materialization advisor and temporal engine are not
ported yet.
"""
from .deltagraph import DeltaGraph  # noqa: F401
from .errors import (AttrOptionsError, DocumentError, ExecutionError,  # noqa: F401
                     QueryError, TimeExpressionError, UnknownAttributeError,
                     UnknownOperatorError)
from .events import (EventList, GraphHistoryBuilder, GraphUniverse,  # noqa: F401
                     MaterializedState, apply_events, replay)
from .graphpool import GraphPool  # noqa: F401
from .query import AttrOptions, TimeExpression, parse_attr_options  # noqa: F401
