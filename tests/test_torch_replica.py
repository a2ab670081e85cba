"""The port's process transport: sharded retrieval through
``repro_torch.launch.shardd`` OS processes, on the CPU.

Every test here spawns shard processes (each child imports torch), so
they share one file and, through the transport's process pool, one fleet.
Held:

* every child is the port's daemon: ``/proc/<pid>/cmdline`` of each pid
  the health RPC reports runs ``repro_torch.launch.shardd``, never the JAX
  package's;
* retrieval through the processes is bit-identical to the JAX package's
  retriever, the unsharded path and ``replay`` over partitioners × P ×
  processes × replicas, masks and attributes;
* ``REPRO_SHARD_TRANSPORT`` / ``REPRO_REPLICAS`` select it through
  ``GraphManager.enable_sharding``;
* SIGKILL of a replica between two queries fails over (the query after
  it is right, ``failovers_total`` moves), a corpse found by the health
  probe is excluded before routing, and an epoch publish invalidates the
  shard caches;
* an unowned fetch carries the worker's traceback and widens ownership;
  ``close`` reaps the children when pooling is off.

Mirrors the process cases of ``tests/test_replica.py``.
"""
import os

import numpy as np
import pytest

from repro.core import GraphManager as JGraphManager
from repro.core.query import parse_attr_options as j_parse_attr_options
from repro.data.generators import random_history as j_random_history
from repro.runtime.shard import ShardedRetriever as JShardedRetriever

from repro_torch.core import EventList, GraphManager, replay
from repro_torch.core.query import NO_ATTRS, parse_attr_options
from repro_torch.interop import build_universe, event_arrays, universe_arrays
from repro_torch.launch.shardd import _encode_keys
from repro_torch.runtime.rpc import RemoteCallError
from repro_torch.runtime.shard import ProcTransport, ShardedRetriever

CPU = "cpu"
ATTRS = "+node:all+edge:all"


def carry(juni, jev):
    """A JAX-package history as the port's universe and events."""
    return (build_universe(universe_arrays(juni)),
            EventList(**event_arrays(jev)))


def _pair(seed, P, fn="mod_hash", n=None, ref=True):
    """The port's partitioned manager over a seeded history, and the JAX
    package's over the same history when ``ref``."""
    n = n if n is not None else int(np.random.default_rng(seed)
                                    .integers(60, 140))
    juni, jev = j_random_history(n, seed)
    uni, ev = carry(juni, jev)
    kw = dict(L=16, k=2, cache_bytes=0, prefetch_workers=0,
              num_partitions=P, partition_fn=fn)
    gm = GraphManager(uni, ev, device=CPU, **kw)
    jgm = JGraphManager(juni, jev, **kw) if ref else None
    return uni, ev, gm, juni, jgm


def _times(ev, seed, n=5):
    tmax = int(ev.time[-1]) if len(ev) else 0
    rng = np.random.default_rng(seed + 1)
    return sorted({int(t) for t in rng.integers(0, tmax + 2, n)} | {tmax})


def _check(uni, ev, gm, out, times, attrs=False):
    opts = parse_attr_options(ATTRS, uni) if attrs else NO_ATTRS
    oracle = gm.dg.get_snapshots(times, opts, pool=gm.pool)
    for t in times:
        truth = replay(uni, ev, t)
        assert np.array_equal(out[t].node_mask, truth.node_mask), t
        assert np.array_equal(out[t].edge_mask, truth.edge_mask), t
        assert oracle[t].equal(out[t]), t


def _cmdline(pid: int) -> list[str]:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().decode().split("\0")


def _assert_port_children(transport):
    for name in transport.servers():
        pid = int(transport.health(name)["pid"])
        argv = _cmdline(pid)
        assert "repro_torch.launch.shardd" in argv, argv
        assert "repro.launch.shardd" not in argv, argv


@pytest.mark.parametrize("fn,P,W,R", [("mod_hash", 4, 2, 2),
                                      ("mod_hash", 5, 3, 2),
                                      ("word_cyclic", 6, 3, 3),
                                      ("word_cyclic", 8, 2, 1)])
def test_proc_transport_bit_identical_to_reference(fn, P, W, R):
    uni, ev, gm, juni, jgm = _pair(51, P, fn)
    times = _times(ev, 51)
    with ShardedRetriever(gm, W, transport="proc", replicas=R,
                          hedge_delay_s=0.05) as sr:
        _assert_port_children(sr.transport)
        out = sr.retrieve(times, parse_attr_options(ATTRS, uni))
        assert sr.last_stats["transport"] == "proc"
        assert sr.last_stats["replicas"] == R
    with JShardedRetriever(jgm, W, hedge_delay_s=0.0) as jsr:
        ref = jsr.retrieve(times, j_parse_attr_options(ATTRS, juni))
    _check(uni, ev, gm, out, times, attrs=True)
    for t in times:
        for f in ("node_mask", "edge_mask", "node_attrs", "edge_attrs"):
            assert np.array_equal(getattr(out[t], f), getattr(ref[t], f),
                                  equal_nan=True), (t, f)
    gm.close()
    jgm.close()


def test_enable_sharding_env_wiring(monkeypatch):
    monkeypatch.setenv("REPRO_SHARD_TRANSPORT", "proc")
    monkeypatch.setenv("REPRO_REPLICAS", "2")
    uni, ev, gm, _, _ = _pair(52, 4, ref=False)
    times = _times(ev, 52, 3)
    gm.enable_sharding(2)
    assert isinstance(gm.sharded.transport, ProcTransport)
    assert gm.sharded.replicas == 2
    _assert_port_children(gm.sharded.transport)
    out = gm.get_snapshots(times)
    _check(uni, ev, gm, out, times)
    gm.disable_sharding()
    gm.close()


def test_kill_between_queries_fails_over():
    """A replica SIGKILL'd after the last health probe: the next query
    finds it dead on its fetch and fails over to the other replica."""
    uni, ev, gm, _, _ = _pair(61, 6, n=120, ref=False)
    times = _times(ev, 61)
    gm.enable_sharding(2, transport="proc", replicas=2, max_hedges=0,
                       health_interval_s=1e9)
    sr = gm.sharded
    out1 = gm.get_snapshots(times)
    _check(uni, ev, gm, out1, times)
    victim = next(iter(sr.assignment(gm.dg.P)))
    pid = sr.transport.kill(victim)
    assert pid > 0
    out2 = gm.get_snapshots(times[::-1])
    _check(uni, ev, gm, out2, times)
    assert sr.failovers_total >= 1
    assert victim not in sr.alive_workers()
    gm.disable_sharding()
    gm.close()


def test_sigkill_at_idle_is_excluded_by_heartbeat():
    uni, ev, gm, _, _ = _pair(62, 6, n=120, ref=False)
    times = _times(ev, 62)
    with ShardedRetriever(gm, 2, transport="proc", replicas=2,
                          hedge_delay_s=0.05) as sr:
        out1 = sr.retrieve(times, parse_attr_options(ATTRS, uni))
        _check(uni, ev, gm, out1, times, attrs=True)
        victim = next(iter(sr.assignment(gm.dg.P)))
        sr.transport.kill(victim)
        sr.probe_health(force=True)
        assert victim not in sr.alive_workers()
        r0 = sr.requeues_total
        out2 = sr.retrieve(times, parse_attr_options(ATTRS, uni))
        assert sr.requeues_total == r0
        assert victim not in sr.assignment(gm.dg.P)
    _check(uni, ev, gm, out2, times, attrs=True)
    gm.close()


def test_epoch_publish_invalidates_shard_caches():
    juni, jev = j_random_history(160, 71)
    uni, ev = carry(juni, jev)
    cut = len(ev) - 40
    gm = GraphManager(uni, ev[:cut], L=16, k=2, cache_bytes=0,
                      prefetch_workers=0, num_partitions=4,
                      partition_fn="mod_hash", device=CPU)
    with ShardedRetriever(gm, 2, transport="proc", replicas=2,
                          hedge_delay_s=0.05) as sr:
        tr = sr.transport
        t_old = int(ev.time[cut - 1])
        out1 = sr.retrieve([t_old])
        truth_old = replay(uni, ev[:cut], t_old)
        assert np.array_equal(out1[t_old].node_mask, truth_old.node_mask)
        before = {s: tr.server_stats(s) for s in tr.servers()}
        gm.update(ev[cut:])
        after = {s: tr.server_stats(s) for s in tr.servers()}
        for s in tr.servers():
            assert after[s]["invalidations"] > before[s]["invalidations"], s
            assert after[s]["epoch"] > before[s]["epoch"]
        times = sorted({t_old, int(ev.time[-1])})
        out2 = sr.retrieve(times)
        for t in times:
            truth = replay(uni, ev, t)
            assert np.array_equal(out2[t].node_mask, truth.node_mask), t
            assert np.array_equal(out2[t].edge_mask, truth.edge_mask), t
    gm.close()


def test_unowned_fetch_carries_remote_traceback_and_widens():
    uni, ev, gm, _, _ = _pair(83, 6, ref=False)
    tr = ProcTransport(gm, 3, replicas=1)
    try:
        h = tr._by_name[tr.servers()[0]]
        with pytest.raises(RemoteCallError) as ei:
            h.client.call("fetch", {"k": _encode_keys([(999, 0, "s")]),
                                    "min_epoch": 0})
        assert ei.value.retryable is False
        assert ei.value.remote_type == "ValueError"
        assert "unowned partition" in str(ei.value)
        assert "h_fetch" in ei.value.remote_traceback
        key = next(iter(gm.store.keys()))
        outsider = next(s for s in tr.servers() if key[0] not in tr._owned[s])
        want = gm.store.get(key)
        assert tr.fetch(outsider, [key]) == [want]
        assert key[0] in tr._owned[outsider]
        assert tr.fetch(outsider, [key]) == [want]
        assert tr.fetch(outsider, [(999, 0, "s")]) == [None]
    finally:
        tr.close()
        gm.close()


def test_close_reaps_processes_when_pooling_disabled(monkeypatch):
    monkeypatch.setenv("REPRO_SHARDD_POOL", "0")
    uni, ev, gm, _, _ = _pair(91, 4, ref=False)
    tr = ProcTransport(gm, 2, replicas=2)
    handles = list(tr._by_name.values())
    assert all(h.alive() for h in handles)
    _assert_port_children(tr)
    tr.close()
    for h in handles:
        assert h.proc.poll() is not None, h.pid
        assert not os.path.exists(f"/proc/{h.pid}/cmdline") or \
            h.proc.returncode is not None
    gm.close()
