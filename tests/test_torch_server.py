"""The port's query server and wire front ends against the JAX package's,
on the CPU.

Both packages build a ``GraphManager`` over one seeded history (carried
into the port with ``interop``) and serve the same NDJSON lines.  Held
equal, wall times aside:

* one session over a real socket to each package's ``QueryServer``: every
  envelope, errors and control frames included;
* the stdin loop (``run_query_documents``) against the reference's, and
  against the port's own socket server;
* ``serve --mode query`` (``serve_query``): its stdout, line for line,
  unsharded and through four in-thread shard workers;
* concurrent sessions: every envelope answers its own request, with the
  CRCs of a direct execution; co-batching merges across clients;
* admission: deadline and overload shedding with zero KV gets, lease
  grants, backpressure, release and reclaim on disconnect.

Mirrors ``tests/test_server.py``.  No test here spawns a process.
"""
import json
import socket
import threading
import time

import numpy as np
import pytest

from repro.core import GraphManager as JGraphManager
from repro.data.generators import churn_network as j_churn_network
from repro.launch import serve as jserve
from repro.launch.server import QueryServer as JQueryServer

from repro_torch.api.document import Q
from repro_torch.api.scheduler import BatchingScheduler
from repro_torch.core import EventList, GraphManager
from repro_torch.interop import build_universe, event_arrays, universe_arrays
from repro_torch.launch import serve
from repro_torch.launch.server import QueryServer

CPU = "cpu"


@pytest.fixture(scope="module")
def history():
    juni, jev = j_churn_network(n_initial_edges=100, n_events=2000, seed=7)
    return ((build_universe(universe_arrays(juni)),
             EventList(**event_arrays(jev))), (juni, jev))


@pytest.fixture()
def gm(history):
    (uni, ev), _ = history
    g = GraphManager(uni, ev, L=64, k=2, diff_fn="intersection", device=CPU)
    yield g
    g.close()


@pytest.fixture()
def jgm(history):
    _, (juni, jev) = history
    g = JGraphManager(juni, jev, L=64, k=2, diff_fn="intersection")
    yield g
    g.close()


class Client:
    """One NDJSON session over a real socket."""

    def __init__(self, srv) -> None:
        self.sock = socket.create_connection((srv.host, srv.port))
        self.f = self.sock.makefile("rw", encoding="utf-8", newline="\n")

    def send(self, obj) -> None:
        self.f.write((obj if isinstance(obj, str) else json.dumps(obj))
                     + "\n")
        self.f.flush()

    def recv(self) -> dict:
        line = self.f.readline()
        assert line, "server closed the connection"
        return json.loads(line)

    def rpc(self, obj) -> dict:
        self.send(obj)
        return self.recv()

    def close(self) -> None:
        for h in (self.f, self.sock):
            try:
                h.close()
            except OSError:
                pass


_TIMING = ("wall_s", "queue_ms", "exec_ms", "wait_ms")


def _strip(d):
    """An envelope without its clock readings."""
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in _TIMING}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


LINES = [json.dumps(d) if not isinstance(d, str) else d for d in (
    {"kind": "snapshot", "t": 80, "id": "a"},
    "garbage",
    {"kind": "snapshot", "t": 50, "bogus_field": 1, "id": 42},
    {"kind": "multipoint", "times": [80, 160, 400]},
    {"kind": "interval", "ts": 10, "te": 400},
    {"kind": "snapshot", "t": 300, "attrs": "+node:all"},
    {"kind": "multipoint", "times": [100, 200], "reply": "lease",
     "id": "L"},
    {"release": "all", "id": "R"},
    {"release": [999], "id": "r"},
)]


def _session(server_cls, manager, lines):
    with server_cls(manager, window_ms=1.0, workers=1) as srv:
        c = Client(srv)
        out = [c.rpc(line) for line in lines]
        c.close()
    return out


def test_socket_session_matches_reference(gm, jgm):
    got = _session(QueryServer, gm, LINES)
    want = _session(JQueryServer, jgm, LINES)
    assert [_strip(e) for e in got] == [_strip(e) for e in want]
    assert [e["ok"] for e in got] == [True, False, False, True, True, True,
                                      True, True, True]


@pytest.mark.parametrize("batch", [1, 4, 8])
def test_stdin_loop_matches_reference_and_socket(gm, jgm, batch):
    got = [json.loads(s)
           for s in serve.run_query_documents(gm, LINES, batch=batch)]
    want = [json.loads(s)
            for s in jserve.run_query_documents(jgm, LINES, batch=batch)]
    assert [_strip(e) for e in got] == [_strip(e) for e in want]
    sock = _session(QueryServer, gm, LINES)    # same pool: new lease gids
    for a, b in zip(got, sock):
        assert a["ok"] == b["ok"]
        if a["ok"] and "result" in a:
            assert a["result"].get("points") == b["result"].get("points")
            assert len(a["result"].get("lease", ())) == \
                len(b["result"].get("lease", ()))
        elif not a["ok"]:
            assert a["error"]["kind"] == b["error"]["kind"]


def _stdout_envelopes(text: str) -> list[dict]:
    return [_strip(json.loads(line)) for line in text.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("shards", [1, 4])
def test_serve_query_matches_reference(tmp_path, capsys, shards):
    """``serve --mode query`` on one NDJSON input: the port's stdout
    equals the reference's, envelope for envelope (with shards, the
    stats are left out: a hedge fires on the clock and its duplicate
    fetches count as KV gets)."""
    path = tmp_path / "docs.ndjson"
    path.write_text("\n".join(LINES[:6]) + "\n")
    serve.serve_query(2000, 4, str(path), shards=shards, device=CPU)
    got = _stdout_envelopes(capsys.readouterr().out)
    jserve.serve_query(2000, 4, str(path), shards=shards)
    want = _stdout_envelopes(capsys.readouterr().out)
    if shards > 1:
        assert any(e.get("stats", {}).get("shard_shards") for e in got)
        for env in got + want:
            env.pop("stats", None)
    assert len(got) == 6 and got == want


def test_serve_query_cli_defaults_to_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve._build_query_gm(400, 0, "v2", "mem", None, 8.0, 0.0, 1)


def test_concurrent_envelopes_match_direct_execution(gm):
    times = [60, 120, 180, 240, 300, 360]
    direct = {t: gm.query.run(Q.at(t).build()).to_dict()["result"]
              for t in times}
    with QueryServer(gm, window_ms=10.0, workers=3) as srv:
        out = {}

        def run(cid):
            c = Client(srv)
            mine = list(np.roll(times, cid))
            for i, t in enumerate(mine):
                c.send({"kind": "snapshot", "t": int(t),
                        "id": f"{cid}:{i}:{t}"})
            out[cid] = [c.recv() for _ in mine]
            c.close()

        ths = [threading.Thread(target=run, args=(cid,)) for cid in range(5)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in ths)
    for cid, envs in out.items():
        for i, env in enumerate(envs):
            assert env["ok"], env
            _, slot, t = env["id"].split(":")
            assert int(slot) == i
            assert env["result"] == direct[int(t)]


def test_cobatch_across_clients(gm):
    with QueryServer(gm, window_ms=25.0, workers=2) as srv:
        results = {}
        barrier = threading.Barrier(4)

        def run(cid):
            c = Client(srv)
            docs = [{"kind": "snapshot", "t": 100 + 50 * i,
                     "id": f"c{cid}-{i}"} for i in range(3)]
            barrier.wait()
            for d in docs:
                c.send(d)
            results[cid] = [c.recv() for _ in docs]
            c.close()

        ths = [threading.Thread(target=run, args=(cid,)) for cid in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30)
        stats = srv.scheduler.snapshot_stats()
    for cid, envs in results.items():
        assert [e["id"] for e in envs] == [f"c{cid}-{i}" for i in range(3)]
        assert all(e["ok"] for e in envs)
    assert stats["co_batched_docs"] > 3 and stats["max_group"] > 3


def test_deadlines_shed_before_execution(gm):
    with QueryServer(gm, window_ms=1.0, workers=1) as srv:
        c = Client(srv)
        g0 = gm.store.stats.gets
        env = c.rpc({"kind": "snapshot", "t": 500, "deadline_ms": 0.0001,
                     "id": "dl"})
        assert env["ok"] is False and env["error"]["kind"] == "deadline"
        assert env["id"] == "dl" and gm.store.stats.gets == g0
        assert srv.scheduler.counters["shed_deadline"] == 1
        assert c.rpc({"kind": "snapshot", "t": 500})["ok"]
        c.close()
    with QueryServer(gm, window_ms=1.0, workers=1,
                     admit_horizon_ms=0.0) as srv:
        srv.scheduler.cost_rate.value = 1.0
        c = Client(srv)
        g0 = gm.store.stats.gets
        env = c.rpc({"kind": "snapshot", "t": 700, "deadline_ms": 50.0})
        assert env["ok"] is False and env["error"]["kind"] == "deadline"
        assert "plan cost" in env["error"]["message"]
        assert gm.store.stats.gets == g0
        c.close()


def test_admission_control_sheds_overload(gm):
    sched = BatchingScheduler(gm.query, window_ms=500.0, workers=1,
                              admit_horizon_ms=0.7)
    try:
        futs = [sched.submit(Q.at(100 + i).build()) for i in range(10)]
        results = [f.result(timeout=30) for f in futs]
    finally:
        sched.close()
    shed = [r for r in results if not r.ok]
    okd = [r for r in results if r.ok]
    assert okd and shed
    assert all(r.error.code == "overloaded" for r in shed)
    assert sched.counters["shed_overload"] == len(shed)
    assert all(r.ok for r in results[:len(okd)])
    closed = BatchingScheduler(gm.query, window_ms=1.0, workers=1)
    closed.close()
    res = closed.submit(Q.at(50).build()).result(timeout=5)
    assert res.ok is False and res.error.code == "overloaded"


def test_leases_backpressure_and_reclaim(gm):
    n0 = gm.pool.num_active()
    with QueryServer(gm, window_ms=1.0, workers=1, session_lease_mb=0.0001,
                     backpressure_grace_s=0.01) as srv:
        c = Client(srv)
        grant = c.rpc({"kind": "snapshot", "t": 150, "reply": "lease",
                       "id": "L1"})
        gids = [int(g) for g in grant["result"]["lease"]]
        assert len(gids) == 1 and gm.pool.num_active() == n0 + 1
        bp = c.rpc({"kind": "snapshot", "t": 150, "id": "q"})
        assert bp["ok"] is False and bp["error"]["kind"] == "backpressure"
        ack = c.rpc({"release": gids, "id": "R"})
        assert ack["ok"] and ack["released"] == gids and ack["held"] == 0
        assert gm.pool.num_active() == n0
        assert c.rpc({"kind": "snapshot", "t": 150})["ok"]
        c.close()
    with QueryServer(gm, window_ms=1.0, workers=1) as srv:
        c = Client(srv)
        assert c.rpc({"kind": "snapshot", "t": 222, "reply": "lease"})["ok"]
        assert gm.pool.num_active() == n0 + 1
        c.close()                       # no release frame
        deadline = time.monotonic() + 10
        while gm.pool.num_active() != n0 and time.monotonic() < deadline:
            time.sleep(0.02)
        st = srv.stats()
    assert gm.pool.num_active() == n0
    assert st["scheduler"]["executed"] >= 1


def test_serve_snapshots_matches_reference(capsys):
    """``serve --mode snapshots``: the advisor's pins, cache hits, store
    and KV counters equal the reference's (the us/q lines are clocks)."""
    serve.serve_snapshots(2000, 16.0, 200, 1.3, device=CPU)
    got = capsys.readouterr().out.splitlines()
    jserve.serve_snapshots(2000, 16.0, 200, 1.3)
    want = capsys.readouterr().out.splitlines()
    counted = ("pins=", "warm-start", "store", "kv")
    pick = (lambda lines: [ln for ln in lines if ln.startswith(counted)])
    assert len(pick(got)) == 4 and pick(got) == pick(want)


def test_serve_ingest_commits_every_event(capsys):
    """``serve --mode ingest``: every live event commits while readers
    query, no document fails, and the summary line closes the output."""
    serve.serve_ingest(1500, 1.0, 2, 256, device=CPU)
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("INGEST_SUMMARY ")
    summary = json.loads(last.split(" ", 1)[1])
    assert summary["committed_events"] == 1500 - 300
    assert summary["docs_failed"] == 0 and summary["docs_served"] > 0
    assert summary["rollovers"] >= 1
