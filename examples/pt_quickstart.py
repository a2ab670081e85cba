"""Quickstart, in torch: build a historical graph, index it, query snapshots
— via the declarative GraphQuery builder (`Q`), the wire-protocol form of
every query, and the legacy method surface it shims.  The port of
``examples/quickstart.py``; it prints the same lines.

Run:  PYTHONPATH=src python examples/pt_quickstart.py [--device cpu]

``--device`` defaults to the card, which must be present; it is the
``GraphManager``'s (its temporal engine's) device.  Snapshot retrieval
through the query service runs on the host, as in the reference.  The
steps below are functions, so that another manager can take the tour.
"""
import argparse

from repro_torch.api import Q
from repro_torch.core import GraphManager, TimeExpression
from repro_torch.core.events import GraphHistoryBuilder
from repro_torch.kernels.policy import resolve_device


def build_history():
    """Step 1: an evolving collaboration network; ``(universe, events)``."""
    b = GraphHistoryBuilder()
    for person in ("ada", "grace", "edsger", "barbara", "donald"):
        b.add_node(person, t=1960, attrs={"papers": 0.0})
    b.add_edge("ada", "grace", t=1962)
    b.add_edge("grace", "edsger", t=1965)
    b.set_node_attr("grace", "papers", 12.0, t=1966)
    b.add_edge("barbara", "donald", t=1968)
    b.delete_edge("ada", "grace", t=1970)
    b.add_edge("ada", "donald", t=1972)
    b.transient_edge("edsger", "donald", t=1971)   # a one-off "message"
    return b.finalize()


def make_manager(universe, events, device="cuda") -> GraphManager:
    """Step 2: the DeltaGraph index + GraphPool."""
    return GraphManager(universe, events, L=4, k=2, diff_fn="balanced",
                        device=device)


def tour(gm: GraphManager, universe, log=print) -> None:
    """Steps 3-8 on ``gm``, built over :func:`build_history`'s
    ``universe``; each result goes to ``log``."""
    # -- 3. singlepoint retrieval (the paper's GetHistGraph) ---------------
    # the legacy method surface still works; it is a thin shim over the
    # declarative query service (gm.query), used directly in step 4
    h1966 = gm.get_hist_graph(1966, "+node:papers")
    log("1966 nodes:", sorted(h1966.get_nodes()))
    log("1966 grace neighbors:", h1966.get_neighbors("grace"))
    log("1966 grace.papers =", h1966.node_attr("grace", "papers"))

    # -- 4. declarative queries: build a document, run it, read the stats --
    doc = Q.at(1966).attrs("+node:papers").build()
    log("as a wire document:", doc.to_json())
    res = gm.query.run(doc)
    log(f"same snapshot via the document: {res.value.node_mask.sum()} "
        f"nodes, stats={ {k: res.stats[k] for k in ('kv_gets', 'cache_hits')} }")

    # -- 5. multipoint retrieval (one Steiner-tree plan) -------------------
    for h in gm.get_hist_graphs([1963, 1969, 1973]):
        log(f"{h.time}: {h.num_nodes()} nodes / {h.num_edges()} edges")
    # ... or declaratively; co-batched documents merge into ONE plan
    results = gm.query.run_batch([Q.at(1963).build(),
                                  Q.at(1969, 1973).build()])
    log("multipoint merged", results[0].stats["merged_docs"],
        "documents into one plan")

    # -- 6. TimeExpression: edges valid in 1969 but not 1973 ---------------
    tex = TimeExpression.parse("t0 & ~t1", [1969, 1973])
    with gm.get_hist_graph_expr(tex) as g:     # HistGraph: a context manager
        log("edges in 1969 but gone by 1973:", g.num_edges())
    # equivalent document: Q.expr("t0 & ~t1", [1969, 1973]).build()

    # -- 7. interval query picks up the transient --------------------------
    res = gm.get_hist_graph_interval(1970, 1973)   # = Q.between(1970, 1973)
    log("elements added in [1970, 1973):",
        {k: v.tolist() for k, v in res.items() if len(v)})

    # -- 8. live updates keep the index fresh (§6) -------------------------
    upd = GraphHistoryBuilder()
    upd.universe = universe          # same id space, new events
    upd._seq = 10_000
    upd.add_node("alan", 1975)
    upd.add_edge("alan", "donald", 1976)
    _, new_events = upd.finalize()
    gm.update(new_events)
    h1976 = gm.get_hist_graph(1976)
    log("1976 after live update:", h1976.num_nodes(), "nodes,",
        h1976.num_edges(), "edges")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a card must be present) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    universe, events = build_history()
    gm = make_manager(universe, events, dev)
    try:
        tour(gm, universe)
    finally:
        gm.close()


if __name__ == "__main__":
    main()
