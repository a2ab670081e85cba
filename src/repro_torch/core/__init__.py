"""Core of the paper's contribution: DeltaGraph + GraphPool.

Public surface:

* :class:`~repro_torch.core.events.GraphHistoryBuilder` — ingest activity
* :class:`~repro_torch.core.deltagraph.DeltaGraph` — the hierarchical index
* :class:`~repro_torch.core.graphpool.GraphPool` — overlaid in-memory
  snapshots
* :class:`~repro_torch.core.manager.GraphManager` — the paper's API façade
  (``device=``, default ``"cuda"``, for the temporal engine)
* :class:`~repro_torch.core.materialize.MaterializationAdvisor` —
  workload-aware memory materialization + the snapshot LRU cache
* :class:`~repro_torch.core.temporal.TemporalEngine` — incremental
  evolutionary queries over snapshot intervals (``GraphManager.evolve``),
  and :class:`~repro_torch.core.temporal.SnapshotBatchLoader`
"""
from .deltagraph import DeltaGraph  # noqa: F401
from .errors import (AttrOptionsError, DocumentError, ExecutionError,  # noqa: F401
                     QueryError, TimeExpressionError, UnknownAttributeError,
                     UnknownOperatorError)
from .events import (EventList, GraphHistoryBuilder, GraphUniverse,  # noqa: F401
                     MaterializedState, apply_events, replay)
from .graphpool import GraphPool  # noqa: F401
from .manager import GraphManager, HistGraph  # noqa: F401
from .materialize import (Advice, AdvisorConfig, MaterializationAdvisor,  # noqa: F401
                          SnapshotCache, WorkloadStats)
from .query import AttrOptions, TimeExpression, parse_attr_options  # noqa: F401
from .temporal import (EvolveOp, EvolveResult, PregelFold,  # noqa: F401
                       SnapshotBatchLoader, StepDelta, TemporalEngine)
