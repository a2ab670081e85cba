"""Declarative query API: serializable GraphQuery documents, one compiler
onto the retrieval-plan IR, and the request-serving execution service.

Public surface:

* :class:`~repro_torch.api.document.GraphQuery` — the versioned,
  JSON-serializable query document (the wire protocol);
* :class:`~repro_torch.api.document.Q` — the fluent builder
  (``Q.at(t).attrs("+node:all").build()``);
* :class:`~repro_torch.api.compiler.QueryCompiler` — lowers every document kind
  onto the plan IR / batched executor / temporal engine;
* :class:`~repro_torch.api.service.QueryService` — executes documents (and
  merges co-batched point documents into one Steiner plan), producing
  :class:`~repro_torch.api.service.QueryResult` envelopes with execution stats;
* the typed error taxonomy re-exported from :mod:`repro_torch.core.errors`.

Reach the service through ``GraphManager.query``; every legacy
``GraphManager`` entry point is a thin shim over it.
"""
from ..core.errors import (AttrOptionsError, DocumentError,  # noqa: F401
                           ExecutionError, QueryError, TimeExpressionError,
                           UnknownAttributeError, UnknownOperatorError)
from .compiler import CompiledQuery, QueryCompiler  # noqa: F401
from .document import SCHEMA_VERSION, GraphQuery, Q  # noqa: F401
from .service import QueryResult, QueryService  # noqa: F401
