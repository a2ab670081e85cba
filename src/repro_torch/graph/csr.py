"""CSR / edge-index utilities over the dense slot universe.

The union graph lives as flat ``edge_src``/``edge_dst`` arrays (universe
order, append-only).  Any snapshot is that array pair + a boolean edge
mask; CSR is built on demand for traversal APIs and host-side analytics,
while the device analytics (:mod:`repro_torch.graph.algorithms`) operate
directly on (edge_index, mask) through scatters — the scatter path *is*
the system.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSR:
    indptr: np.ndarray   # int64[N+1]
    indices: np.ndarray  # int32[nnz] neighbor node slots
    edge_ids: np.ndarray # int32[nnz] edge slots (for attr lookup)

    @property
    def num_nodes(self) -> int:
        return self.indptr.size - 1

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def edge_slots(self, u: int) -> np.ndarray:
        return self.edge_ids[self.indptr[u]:self.indptr[u + 1]]


def build_csr(edge_src: np.ndarray, edge_dst: np.ndarray,
              num_nodes: int, edge_mask: np.ndarray | None = None,
              directed: np.ndarray | None = None) -> CSR:
    """CSR over the masked edge set; undirected edges appear both ways."""
    if edge_mask is None:
        edge_mask = np.ones(edge_src.shape, bool)
    eid = np.nonzero(edge_mask)[0].astype(np.int32)
    s, d = edge_src[eid], edge_dst[eid]
    if directed is None:
        directed = np.zeros(edge_src.shape, bool)
    bidir = ~directed[eid]
    # forward rows + reversed rows for undirected edges
    rows = np.concatenate([s, d[bidir]])
    cols = np.concatenate([d, s[bidir]])
    ids = np.concatenate([eid, eid[bidir]])
    order = np.argsort(rows, kind="stable")
    rows, cols, ids = rows[order], cols[order], ids[order]
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(indptr, cols.astype(np.int32), ids.astype(np.int32))


def degrees(edge_src: np.ndarray, edge_dst: np.ndarray, num_nodes: int,
            edge_mask: np.ndarray, directed: np.ndarray) -> np.ndarray:
    deg = np.zeros(num_nodes, np.int64)
    eid = np.nonzero(edge_mask)[0]
    np.add.at(deg, edge_src[eid], 1)
    bid = eid[~directed[eid]]
    np.add.at(deg, edge_dst[bid], 1)
    return deg
