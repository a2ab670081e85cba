"""The port's sharded host retrieval against the JAX package's, on the CPU,
with shard servers in threads (the process transport is in
``tests/test_torch_replica.py``).

A seeded history from the JAX package's generator is carried into the port
(``interop``); both packages build a partitioned ``GraphManager`` over it.
Held equal:

* ``ShardedRetriever.retrieve`` — masks and attributes, bit for bit —
  against the reference's retriever, the unsharded path and ``replay``,
  over partitioners × storage partitions × workers; the partition
  assignment, before and after a worker dies;
* the query service with ``enable_sharding``: envelopes equal the
  reference's, wall times aside;
* the failure cases: a transient fault requeues once, a permanent one
  raises after its retries and moves only the dead worker's partitions, a
  straggler is hedged on a distinct replica, an unreachable replica fails
  over inside the attempt;
* ``runtime/fault.py`` and ``runtime/replica.py``: retry, hedging,
  rendezvous ranking, replica routing, elastic replan, heartbeats, on the
  same scripted inputs;
* ``runtime/rpc.py``: frames byte-identical, and each package's client
  talks to the other's server.

Mirrors ``tests/test_{sharded,fault,rpc}.py`` and the in-process cases of
``tests/test_replica.py``.
"""
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from repro.core import GraphManager as JGraphManager
from repro.core.query import parse_attr_options as j_parse_attr_options
from repro.data.generators import random_history as j_random_history
from repro.runtime import fault as jfault
from repro.runtime import replica as jreplica
from repro.runtime import rpc as jrpc
from repro.runtime.shard import ShardedRetriever as JShardedRetriever
from repro.runtime.shard import ShardExecutionError as JShardExecutionError
from repro.api import GraphQuery as JGraphQuery

from repro_torch.api import GraphQuery
from repro_torch.core import EventList, GraphManager, replay
from repro_torch.core.query import NO_ATTRS, parse_attr_options
from repro_torch.interop import build_universe, event_arrays, universe_arrays
from repro_torch.runtime import fault, replica, rpc
from repro_torch.runtime.shard import (InThreadTransport, ShardedRetriever,
                                       ShardExecutionError)

CPU = "cpu"
ATTRS = "+node:all+edge:all"


def carry(juni, jev):
    """A JAX-package history as the port's universe and events."""
    return (build_universe(universe_arrays(juni)),
            EventList(**event_arrays(jev)))


def _pair(seed: int, P: int, fn: str = "mod_hash", n: int | None = None):
    """``((uni, ev, gm), (juni, jev, jgm))``: both packages' partitioned
    managers over one seeded history."""
    n = n if n is not None else int(np.random.default_rng(seed)
                                    .integers(60, 140))
    juni, jev = j_random_history(n, seed)
    uni, ev = carry(juni, jev)
    kw = dict(L=16, k=2, cache_bytes=0, prefetch_workers=0,
              num_partitions=P, partition_fn=fn)
    return ((uni, ev, GraphManager(uni, ev, device=CPU, **kw)),
            (juni, jev, JGraphManager(juni, jev, **kw)))


def _times(ev, seed: int, n: int = 5) -> list[int]:
    tmax = int(ev.time[-1]) if len(ev) else 0
    rng = np.random.default_rng(seed + 1)
    return sorted({int(t) for t in rng.integers(0, tmax + 2, n)} | {tmax})


def _same_state(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
               for f in ("node_mask", "edge_mask", "node_attrs",
                         "edge_attrs"))


def _check(uni, ev, gm, out, times, ref=None, attrs=False) -> None:
    """``out`` equals ``replay``, the unsharded path (with attributes when
    ``attrs``) and, when given, the reference retriever's ``ref``."""
    opts = parse_attr_options(ATTRS, uni) if attrs else NO_ATTRS
    oracle = gm.dg.get_snapshots(times, opts, pool=gm.pool)
    for t in times:
        truth = replay(uni, ev, t)
        assert np.array_equal(out[t].node_mask, truth.node_mask), t
        assert np.array_equal(out[t].edge_mask, truth.edge_mask), t
        assert oracle[t].equal(out[t]), t
        if ref is not None:
            assert _same_state(out[t], ref[t]), t


# ---------------------------------------------------------------------------
# differential: port == reference == unsharded == replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,P,W", [("mod_hash", 4, 4), ("mod_hash", 3, 5),
                                    ("mod_hash", 8, 3),
                                    ("word_cyclic", 4, 2),
                                    ("word_cyclic", 6, 6),
                                    ("word_cyclic", 2, 1)])
@pytest.mark.parametrize("seed", [3, 11])
def test_sharded_bit_identical_to_reference(fn, P, W, seed):
    (uni, ev, gm), (juni, jev, jgm) = _pair(seed, P, fn)
    times = _times(ev, seed)
    with ShardedRetriever(gm, W, hedge_delay_s=0.0) as sr, \
            JShardedRetriever(jgm, W, hedge_delay_s=0.0) as jsr:
        assert sr.assignment(P) == jsr.assignment(P)
        out = sr.retrieve(times, parse_attr_options(ATTRS, uni))
        ref = jsr.retrieve(times, j_parse_attr_options(ATTRS, juni))
        assert sr.last_stats["shards"] == jsr.last_stats["shards"]
    _check(uni, ev, gm, out, times, ref, attrs=True)
    gm.close()
    jgm.close()


def _strip_wall(d):
    if isinstance(d, dict):
        return {k: _strip_wall(v) for k, v in d.items() if k != "wall_s"}
    if isinstance(d, list):
        return [_strip_wall(v) for v in d]
    return d


@pytest.mark.parametrize("workers", [4, 2])
def test_query_service_envelopes_match_reference(workers):
    (uni, ev, gm), (juni, jev, jgm) = _pair(5, 4)
    tmax = int(ev.time[-1])
    docs = [{"kind": "snapshot", "t": tmax // 2},
            {"kind": "snapshot", "t": tmax, "attrs": ATTRS},
            {"kind": "multipoint", "times": [0, tmax // 3, tmax]},
            {"kind": "interval", "ts": tmax // 4, "te": tmax // 2}]
    # no hedging: a hedge fires on the clock, and its count is in the stats
    gm.enable_sharding(workers, max_hedges=0)
    jgm.enable_sharding(workers, max_hedges=0)
    for doc in docs:
        text = json.dumps(doc)
        got = gm.query.run(GraphQuery.from_json(text)).to_dict()
        want = jgm.query.run(JGraphQuery.from_json(text)).to_dict()
        assert _strip_wall(got) == _strip_wall(want), doc
    assert gm.sharded.last_stats["shards"] >= 1
    out = gm.get_snapshots(_times(ev, 5))
    for t in _times(ev, 5):
        truth = replay(uni, ev, t)
        assert np.array_equal(out[t].node_mask, truth.node_mask)
        assert np.array_equal(out[t].edge_mask, truth.edge_mask)
    gm.disable_sharding()
    assert gm.sharded is None
    gm.close()
    jgm.close()


def test_single_worker_degenerates_to_host_path():
    (uni, ev, gm), (_, _, jgm) = _pair(9, 4)
    times = _times(ev, 9)
    with ShardedRetriever(gm, 1) as sr:
        out = sr.retrieve(times)
        assert sr.last_stats["shards"] == 1
        assert sr.last_stats["hedges"] == 0
        assert sr.last_stats["requeues"] == 0
        assert sr.last_stats["transport"] == "thread"
    for t in times:
        truth = replay(uni, ev, t)
        assert np.array_equal(out[t].node_mask, truth.node_mask)
    gm.close()
    jgm.close()


# ---------------------------------------------------------------------------
# fault behaviours through the retriever
# ---------------------------------------------------------------------------

def _victim_hook(once: bool):
    """A shard hook failing the first worker it sees: once, or always."""
    victim = []
    failed = threading.Event()

    def hook(worker, parts):
        if not victim:
            victim.append(worker)
        if worker == victim[0] and not (once and failed.is_set()):
            failed.set()
            raise IOError("injected shard fault")
    return hook, victim


def test_transient_worker_failure_requeues_like_reference():
    (uni, ev, gm), (juni, jev, jgm) = _pair(31, 6)
    times = _times(ev, 31)
    kw = dict(io_retries=1, task_retries=1, hedge_delay_s=0.0)
    hook, _ = _victim_hook(once=True)
    jhook, _ = _victim_hook(once=True)
    with ShardedRetriever(gm, 3, shard_hook=hook, **kw) as sr, \
            JShardedRetriever(jgm, 3, shard_hook=jhook, **kw) as jsr:
        out = sr.retrieve(times)
        ref = jsr.retrieve(times)
        assert sr.requeues_total == jsr.requeues_total == 1
    _check(uni, ev, gm, out, times, ref)
    gm.close()
    jgm.close()


def test_permanent_worker_failure_raises_like_reference():
    (uni, ev, gm), (juni, jev, jgm) = _pair(32, 8)
    times = _times(ev, 32)
    kw = dict(io_retries=1, task_retries=1, hedge_delay_s=0.0, max_hedges=0)
    hook, victim = _victim_hook(once=False)
    jhook, jvictim = _victim_hook(once=False)
    with ShardedRetriever(gm, 3, shard_hook=hook, **kw) as sr, \
            JShardedRetriever(jgm, 3, shard_hook=jhook, **kw) as jsr:
        assert len(sr.assignment(gm.dg.P)) > 1
        with pytest.raises(ShardExecutionError):
            sr.retrieve(times)
        with pytest.raises(JShardExecutionError):
            jsr.retrieve(times)
        # the failed worker reads dead: the next assignment excludes it
        assert victim[0] not in sr.alive_workers()
        assert victim[0] not in sr.assignment(gm.dg.P)
        if victim == jvictim:
            assert sr.assignment(gm.dg.P) == jsr.assignment(gm.dg.P)
    gm.close()
    jgm.close()


def test_dead_worker_moves_only_its_partitions_like_reference():
    (uni, ev, gm), (juni, jev, jgm) = _pair(33, 16)
    names = ["w0", "w1", "w2", "w3"]
    with ShardedRetriever(gm, names) as sr, \
            JShardedRetriever(jgm, names) as jsr:
        before = sr.assignment(16)
        assert before == jsr.assignment(16)
        owner = {p: w for w, ps in before.items() for p in ps}
        dead = next(iter(before))
        sr.heartbeats.mark_dead(dead)
        jsr.heartbeats.mark_dead(dead)
        after = sr.assignment(16)
        assert after == jsr.assignment(16)
        assert dead not in after
        assert sorted(p for ps in after.values() for p in ps) == \
            list(range(16))
        for w, ps in after.items():
            for p in ps:
                if owner[p] != dead:
                    assert owner[p] == w, (p, dead)
        times = _times(ev, 33, 3)
        out = sr.retrieve(times)
        ref = jsr.retrieve(times)
    _check(uni, ev, gm, out, times, ref)
    gm.close()
    jgm.close()


def test_hedged_fetch_beats_straggler():
    (uni, ev, gm), (_, _, jgm) = _pair(34, 6)
    times = _times(ev, 34)
    first = threading.Event()

    def hook(worker, parts):
        # exactly the first attempt overall stalls; its hedge runs fast
        if not first.is_set():
            first.set()
            time.sleep(0.25)

    with ShardedRetriever(gm, 3, hedge_frac=1.0, max_hedges=1,
                          hedge_delay_s=0.01, shard_hook=hook) as sr:
        out = sr.retrieve(times)
        assert sr.hedges_total >= 1
    _check(uni, ev, gm, out, times)
    gm.close()
    jgm.close()


class RecordingTransport(InThreadTransport):
    """In-thread transport logging ``(server, keys)`` per fetch, with a
    one-shot stall on a chosen server."""

    def __init__(self, gm, servers, stall=None, stall_s=0.25):
        super().__init__(gm, servers)
        self.log = []
        self.stall = stall
        self.stall_s = stall_s

    def fetch(self, server, keys, *, min_epoch=0, deadline_s=None):
        with self._lock:
            self.log.append((server, tuple(keys)))
        if server == self.stall:
            time.sleep(self.stall_s)
        return super().fetch(server, keys, min_epoch=min_epoch,
                             deadline_s=deadline_s)


def test_hedge_routes_to_distinct_replica():
    (uni, ev, gm), (_, _, jgm) = _pair(41, 6)
    times = _times(ev, 41)
    tr = RecordingTransport(gm, ["s0", "s1"], stall="s0", stall_s=0.3)
    with ShardedRetriever(gm, 2, transport=tr, replicas=2, hedge_frac=1.0,
                          max_hedges=1, hedge_delay_s=0.01) as sr:
        assert set(sr.assignment(gm.dg.P)) == {"s0", "s1"}
        out = sr.retrieve(times, parse_attr_options(ATTRS, uni))
        assert sr.hedges_total >= 1
        by_keys = {}
        for server, keys in tr.log:
            by_keys.setdefault(keys, set()).add(server)
        rehedged = [srvs for srvs in by_keys.values() if len(srvs) > 1]
        assert rehedged and all(len(s) == 2 for s in rehedged)
        assert sr.failovers_total >= 1
    _check(uni, ev, gm, out, times, attrs=True)
    gm.close()
    jgm.close()


class UnreachableServerTransport(InThreadTransport):
    """In-thread transport where one server always fails with a retryable
    connection error."""

    def __init__(self, gm, servers, dead):
        super().__init__(gm, servers)
        self.dead = dead
        self.dead_hits = 0

    def fetch(self, server, keys, *, min_epoch=0, deadline_s=None):
        if server == self.dead:
            with self._lock:
                self.dead_hits += 1
            raise rpc.RpcConnectionError(f"injected: {server} unreachable")
        return super().fetch(server, keys, min_epoch=min_epoch,
                             deadline_s=deadline_s)


def test_inner_retry_fails_over_to_distinct_replica():
    (uni, ev, gm), (_, _, jgm) = _pair(42, 6)
    times = _times(ev, 42)
    tr = UnreachableServerTransport(gm, ["s0", "s1"], dead="s0")
    with ShardedRetriever(gm, 2, transport=tr, replicas=2, task_retries=0,
                          io_retries=2, max_hedges=0,
                          hedge_delay_s=0.0) as sr:
        out = sr.retrieve(times, parse_attr_options(ATTRS, uni))
        assert tr.dead_hits == 1
        assert sr.requeues_total == 0
    _check(uni, ev, gm, out, times, attrs=True)
    gm.close()
    jgm.close()


# ---------------------------------------------------------------------------
# runtime/fault.py and runtime/replica.py on scripted inputs
# ---------------------------------------------------------------------------

def _retry_trace(mod):
    """What ``retry`` does on four scripted callables."""
    out = {}
    for attempts in (0, -3):
        try:
            mod.retry(lambda: 1, attempts=attempts)
        except ValueError as e:
            out[f"reject{attempts}"] = "attempts" in str(e)
    calls = []

    def keyerr():
        calls.append(1)
        raise KeyError("missing blob")
    with pytest.raises(KeyError):
        mod.retry(keyerr, attempts=5, sleep=lambda s: None)
    out["keyerror_calls"] = len(calls)
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise IOError("transient")
        return "ok"
    out["flaky"] = (mod.retry(flaky, attempts=4, base_delay=0.01,
                              sleep=sleeps.append), len(calls), sleeps)
    sleeps = []

    def dead():
        raise TimeoutError("store timed out")
    with pytest.raises(TimeoutError):
        mod.retry(dead, attempts=3, sleep=sleeps.append)
    out["exhausted_sleeps"] = list(sleeps)
    return out


def test_retry_matches_reference():
    got = _retry_trace(fault)
    assert got == _retry_trace(jfault)
    assert got["keyerror_calls"] == 1
    assert got["flaky"] == ("ok", 3, [0.01, 0.02])
    assert len(got["exhausted_sleeps"]) == 2     # 3 attempts, 2 backoffs


def _straggler_trace(mod, n_tasks, hedge_frac, max_dup, script):
    """Run ``script`` (a string of a = assign, c = complete the oldest
    assigned, f = fail the newest assigned) on a StragglerMitigator and
    record every answer."""
    tasks = [mod.FetchTask(p, f"k{p}", size_est=p + 1)
             for p in range(n_tasks)]
    sm = mod.StragglerMitigator(tasks, hedge_frac=hedge_frac,
                                max_duplicates=max_dup)
    given, trace = [], []
    for op in script:
        if op == "a":
            t = sm.assign()
            trace.append(("a", None if t is None else t.key))
            if t is not None:
                given.append(t.key)
        elif op == "c" and given:
            trace.append(("c", given[0], sm.complete(given.pop(0))))
        elif op == "f" and given:
            trace.append(("f", given[-1], sm.fail(given.pop())))
        trace.append((sm.remaining(), sm.finished(), sm.duplicates))
    return trace


@pytest.mark.parametrize("n_tasks,hedge_frac,max_dup,script", [
    (3, 1.0, 1, "aaa" + "a" * 10),
    (3, 1.0, 2, "aaaacac"),
    (1, 1.0, 0, "aa"),
    (2, 0.0, 1, "acafacfc"),
    (6, 0.5, 1, "aaaacaaafaacccaacc"),
])
def test_straggler_mitigator_matches_reference(n_tasks, hedge_frac, max_dup,
                                               script):
    assert (_straggler_trace(fault, n_tasks, hedge_frac, max_dup, script)
            == _straggler_trace(jfault, n_tasks, hedge_frac, max_dup,
                                script))


@pytest.mark.parametrize("n_workers", [1, 3, 5, 9])
def test_placement_matches_reference(n_workers):
    workers = [f"w{i}" for i in range(n_workers)]
    assert fault.elastic_replan(64, workers) == \
        jfault.elastic_replan(64, workers)
    for p in range(64):
        assert fault.rendezvous_rank(p, workers) == \
            jfault.rendezvous_rank(p, workers)
    for dead in workers[:-1]:
        rest = [w for w in workers if w != dead]
        before, after = (fault.elastic_replan(64, workers),
                         fault.elastic_replan(64, rest))
        assert after == jfault.elastic_replan(64, rest)
        for p, w in before.items():
            if w != dead:
                assert after[p] == w, (dead, p)


@pytest.mark.parametrize("replicas", [1, 2, 3, 7])
def test_replica_manager_matches_reference(replicas):
    servers = [f"s{i}" for i in range(5)]
    rm = replica.ReplicaManager(servers, replicas=replicas)
    jrm = jreplica.ReplicaManager(servers, replicas=replicas)
    for alive in (servers, servers[1:], servers[::2]):
        assert rm.assignment(40, alive) == jrm.assignment(40, alive)
        for p in range(40):
            cands = rm.replicas_of(p, alive)
            assert cands == jrm.replicas_of(p, alive)
            assert rm.primary(p, alive) == jrm.primary(p, alive)
            for k in range(len(cands) + 1):
                tried = set(cands[:k])
                assert rm.route(p, alive, tried) == \
                    jrm.route(p, alive, tried)


def test_heartbeat_boundary_exactly_timeout():
    clock = [0.0]
    hb = fault.HeartbeatTracker(["a"], timeout=5.0, clock=lambda: clock[0])
    clock[0] = 5.0
    assert hb.alive() == ["a"] and hb.dead() == []
    clock[0] = 5.0 + 1e-9
    assert hb.alive() == [] and hb.dead() == ["a"]
    hb.beat("a")
    assert hb.alive() == ["a"]
    hb.mark_dead("a")
    assert hb.dead() == ["a"]
    hb.beat("a")
    assert hb.alive() == ["a"]


# ---------------------------------------------------------------------------
# runtime/rpc.py: one wire format, either package on either end
# ---------------------------------------------------------------------------

def _loop_pair():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    c = socket.create_connection(lst.getsockname())
    s, _ = lst.accept()
    lst.close()
    return c, s


@pytest.mark.parametrize("writer,reader", [(rpc, jrpc), (jrpc, rpc)])
def test_frames_cross_packages(writer, reader):
    blobs = [b"hello", None, b"", b"\x00" * 257, None]
    header = {"r": {"n": 3}, "extra": "é"}
    frame = writer.pack_frame(writer.KIND_RESPONSE, 42, header, blobs)
    assert frame == reader.pack_frame(reader.KIND_RESPONSE, 42, header,
                                      blobs)
    c, s = _loop_pair()
    try:
        c.sendall(frame)
        assert reader.read_frame(s) == (reader.KIND_RESPONSE, 42, header,
                                        blobs)
    finally:
        c.close()
        s.close()


@pytest.mark.parametrize("raw", [
    struct.pack("<I", 5),
    struct.pack("<I", (1 << 30) + 1),
    struct.pack("<I", 13) + struct.pack("<BQI", 7, 1, 0),
    struct.pack("<I", 13) + struct.pack("<BQI", 0, 1, 999),
])
def test_corrupt_frames_are_protocol_errors(raw):
    c, s = _loop_pair()
    try:
        c.sendall(raw)
        with pytest.raises(rpc.RpcProtocolError) as ei:
            rpc.read_frame(s)
        assert ei.value.retryable is False
    finally:
        c.close()
        s.close()


def _handlers():
    def h_echo(args, blobs):
        return {"args": args, "n": len(blobs)}, list(blobs)

    def h_boom_io(args, blobs):
        raise IOError("disk hiccup")

    def h_boom_val(args, blobs):
        raise ValueError("bad argument shape")

    def h_slow(args, blobs):
        time.sleep(float(args.get("s", 1.0)))
        return "late"
    return {"echo": h_echo, "boom_io": h_boom_io, "boom_val": h_boom_val,
            "slow": h_slow}


@pytest.mark.parametrize("server_mod,client_mod", [(rpc, rpc), (jrpc, rpc),
                                                   (rpc, jrpc)])
def test_calls_and_remote_errors_across_packages(server_mod, client_mod):
    with server_mod.RpcServer(_handlers()) as srv:
        cli = client_mod.RpcClient(srv.host, srv.port)
        try:
            for i in range(3):
                res, blobs = cli.call("echo", {"i": i},
                                      blobs=[b"x" * i, None])
                assert res == {"args": {"i": i}, "n": 2}
                assert blobs == [b"x" * i, None]
            assert cli.dials == 1 and srv.requests == 3
            with pytest.raises(client_mod.RemoteCallError) as ei:
                cli.call("boom_val", {})
            assert ei.value.retryable is False
            assert ei.value.remote_type == "ValueError"
            assert "h_boom_val" in ei.value.remote_traceback
            with pytest.raises(client_mod.RemoteCallError) as ei:
                cli.call("boom_io", {})
            assert ei.value.retryable is True
            with pytest.raises(client_mod.RemoteCallError) as ei:
                cli.call("no_such_method", {})
            assert ei.value.remote_type == "KeyError"
        finally:
            cli.close()


def test_deadline_timeout_is_retryable():
    with rpc.RpcServer(_handlers()) as srv:
        cli = rpc.RpcClient(srv.host, srv.port)
        try:
            t0 = time.monotonic()
            with pytest.raises(rpc.RpcTimeout) as ei:
                cli.call("slow", {"s": 5.0}, deadline_s=0.2)
            assert time.monotonic() - t0 < 2.0
            assert ei.value.retryable is True
            assert fault.default_retryable(ei.value)
            res, _ = cli.call("echo", {"ok": 1})
            assert res["args"] == {"ok": 1} and cli.dials >= 2
        finally:
            cli.close()


def test_dial_failure_is_retryable_connection_error():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    cli = rpc.RpcClient("127.0.0.1", port, connect_timeout=0.5)
    try:
        with pytest.raises(rpc.RpcConnectionError) as ei:
            cli.call("echo", {})
        assert ei.value.retryable is True
    finally:
        cli.close()
