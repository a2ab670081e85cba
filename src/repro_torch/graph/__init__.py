"""Graph analytics over snapshot bitmaps: CSR utilities
(:mod:`~repro_torch.graph.csr`), masked PageRank, degrees, components and
their fixpoint solvers (:mod:`~repro_torch.graph.algorithms`), and the
Pregel-style vertex program (:mod:`~repro_torch.graph.pregel`)."""
