"""Concurrent NDJSON query server with SLOs (the serving front end).

``QueryServer`` is a socket server in front of one
:class:`~repro_torch.core.manager.GraphManager`: a threaded accept loop, one
session per connection, newline-delimited JSON framing reusing the
:class:`~repro_torch.api.document.GraphQuery` request /
:class:`~repro_torch.api.service.QueryResult` envelope wire forms.  Every
parsed document is submitted to a shared
:class:`~repro_torch.api.scheduler.BatchingScheduler`, which holds arrivals in
a small batching window and merges co-plannable documents **across
clients** into one Steiner plan; responses are demultiplexed back to
their sessions through per-request futures and written in each session's
request order.

Per-session machinery lives in :class:`SessionCore`, which is
transport-agnostic: the socket session drives it from a connection, and
``serve.py --mode query``'s stdin fallback drives the *same* code path
from a line iterator (:func:`run_session_lines`) — there is one parse /
control / lease / envelope implementation, not a parallel flush loop.

SLO surface (see :mod:`repro_torch.api.scheduler` for admission/deadlines):

* **Leases** — a document with ``reply: "lease"`` overlays its retrieved
  snapshot(s) in the GraphPool and returns lease gids; the client reads
  them via follow-up queries or releases them with a control frame
  ``{"release": [gid, ...]}`` (or ``{"release": "all"}``).  Leases are
  per-session :class:`~repro_torch.core.manager.HistGraph` handles and are
  auto-reclaimed when the session disconnects.

* **Backpressure** — each session has a lease byte budget tied to the
  pool/store budgets (advisor GraphPool budget, else the TieredKV hot
  tier, else a default).  A session over budget first *stops being read*
  for a bounded grace period (the socket's receive buffer fills — real
  transport backpressure), then sheds query documents with typed
  ``backpressure`` envelopes until leases are released; control frames
  keep flowing so releases always get through (no deadlock).
"""
from __future__ import annotations

import json
import queue
import socket
import threading
import time
from typing import TYPE_CHECKING, Any, Iterable, Iterator

from ..api.document import GraphQuery
from ..api.scheduler import BatchingScheduler
from ..core.errors import BackpressureError
from ..core.query import AttrOptions

if TYPE_CHECKING:  # pragma: no cover
    from ..api.service import QueryResult
    from ..core.manager import GraphManager, HistGraph


def _default_session_budget(gm: "GraphManager") -> int:
    """Session lease byte budget tied to the existing byte budgets: a
    slice of the advisor's GraphPool budget when enabled, else of the
    TieredKV hot tier, else 16 MiB."""
    if gm.advisor is not None:
        return max(int(gm.advisor.cfg.budget_bytes) // 4, 1 << 20)
    hot = getattr(gm.store, "hot_bytes", None)
    if hot:
        return max(int(hot) // 4, 1 << 20)
    return 16 << 20


class SessionCore:
    """Transport-agnostic per-client protocol state: line parsing,
    control frames, GraphPool lease accounting, backpressure checks, and
    envelope rendering.  One instance per client session (socket or
    stdin)."""

    def __init__(self, gm: "GraphManager", scheduler: BatchingScheduler,
                 *, lease_budget_bytes: int | None = None,
                 pool_lock: threading.RLock | None = None) -> None:
        self.gm = gm
        self.scheduler = scheduler
        self.lease_budget = (lease_budget_bytes
                             if lease_budget_bytes is not None
                             else _default_session_budget(gm))
        self.pool_lock = pool_lock or threading.RLock()
        self.leases: dict[int, "HistGraph"] = {}
        self.lease_bytes = 0
        self._lease_lock = threading.Lock()
        self.backpressure_sheds = 0

    # ------------------------------------------------------------ parsing
    def parse_line(self, line: str):
        """One wire line → ``None`` (blank), a ``("control", dict)``
        frame, a ``("doc", GraphQuery, raw_id)``, or an
        ``("err", QueryResult, raw_id)`` for malformed input."""
        from ..api.service import QueryService
        line = line.strip()
        if not line:
            return None
        raw_id = None
        try:
            d = json.loads(line)
        except json.JSONDecodeError as e:
            from ..core.errors import DocumentError
            err = DocumentError(f"invalid JSON: {e.msg}", position=e.pos)
            return ("err", QueryService._error_result(None, err), None)
        if isinstance(d, dict):
            if "release" in d:
                return ("control", d)
            rid = d.get("id")
            if isinstance(rid, (str, int)) and not isinstance(rid, bool):
                raw_id = rid
        try:
            doc = GraphQuery.from_dict(d)
        except Exception as e:
            return ("err", QueryService._error_result(None, e), raw_id)
        return ("doc", doc, raw_id)

    # ------------------------------------------------------- backpressure
    def over_budget(self) -> bool:
        return self.lease_bytes > self.lease_budget

    def shed_backpressure(self, doc: GraphQuery) -> "QueryResult":
        self.backpressure_sheds += 1
        return self.scheduler.service._error_result(doc, BackpressureError(
            f"session holds {self.lease_bytes} lease bytes over its "
            f"{self.lease_budget}-byte budget; release leases first"))

    # ------------------------------------------------------------- leases
    def _lease_states(self, res: "QueryResult") -> list[tuple[Any, Any]]:
        if res.kind == "multipoint":
            return [(int(t), st) for t, st in res.value.items()]
        t = res.query.t if res.kind == "snapshot" else None
        return [(t, res.value)]

    def attach_leases(self, res: "QueryResult") -> dict:
        """Overlay a lease-reply result in the GraphPool and annotate the
        envelope with the granted gids (``result.lease``)."""
        from ..core.manager import HistGraph
        env = res.to_dict()
        opts = res.query.attrs
        if not isinstance(opts, AttrOptions):
            opts = self.gm.query.compiler.parse_attrs(opts or "")
        pairs = self._lease_states(res)
        with self.pool_lock:
            pool = self.gm.pool
            gids = pool.insert_snapshots([st for _, st in pairs])
            grants = {}
            added = 0
            for (t, _), gid in zip(pairs, gids):
                hg = HistGraph(self.gm, gid, t, opts)
                with self._lease_lock:
                    self.leases[gid] = hg
                added += (pool.entry_attr_bytes(gid)
                          + (pool.Wn + pool.We) * 4 * 2)
                grants[str(gid)] = {"t": t}
        with self._lease_lock:
            self.lease_bytes += added
        env["result"]["lease"] = grants
        return env

    def handle_control(self, d: dict) -> dict:
        """``{"release": [gid, ...] | "all"}`` → close the named leases
        (idempotent; unknown gids reported, not fatal)."""
        want = d.get("release")
        with self._lease_lock:
            held = list(self.leases)
        gids = held if want == "all" else [
            g for g in (want if isinstance(want, list) else [want])
            if isinstance(g, int) and not isinstance(g, bool)]
        released, unknown = [], []
        for gid in gids:
            with self._lease_lock:
                hg = self.leases.pop(gid, None)
            if hg is None:
                unknown.append(gid)
                continue
            with self.pool_lock:
                bytes_held = (self.gm.pool.entry_attr_bytes(gid)
                              + (self.gm.pool.Wn + self.gm.pool.We) * 4 * 2)
                hg.close()
            with self._lease_lock:
                self.lease_bytes = max(0, self.lease_bytes - bytes_held)
            released.append(gid)
        env = {"v": 1, "ok": True, "kind": "release",
               "released": released, "held": len(self.leases)}
        if unknown:
            env["unknown"] = unknown
        rid = d.get("id")
        if isinstance(rid, (str, int)) and not isinstance(rid, bool):
            env["id"] = rid
        return env

    def release_all(self) -> None:
        """Auto-reclaim on disconnect: every lease back to the pool."""
        with self._lease_lock:
            leases = list(self.leases.values())
            self.leases.clear()
            self.lease_bytes = 0
        for hg in leases:
            with self.pool_lock:
                hg.close()

    # ---------------------------------------------------------- rendering
    def render(self, res: "QueryResult", raw_id=None) -> dict:
        """QueryResult → wire dict, with lease post-processing and id
        echo salvaged from the raw line when the document never parsed."""
        if (res.ok and res.query is not None
                and res.query.reply == "lease"):
            env = self.attach_leases(res)
        else:
            env = res.to_dict()
        if raw_id is not None and "id" not in env:
            env["id"] = raw_id
        return env


def run_session_lines(core: SessionCore, lines: Iterable[str],
                      batch: int = 8) -> Iterator[str]:
    """The stdin code path: drive one :class:`SessionCore` from a line
    iterator, co-batching each chunk of ``batch`` documents as one
    scheduler wave (the same grouping the socket dispatcher applies to a
    batching window), and yield one JSON envelope per input line in
    input order."""

    def flush(chunk: list) -> Iterator[str]:
        docs = []
        for i, item in enumerate(chunk):
            if item[0] == "doc":
                if core.over_budget():
                    chunk[i] = ("err", core.shed_backpressure(item[1]),
                                item[2])
                else:
                    docs.append(item[1])
        results = iter(core.scheduler.run_wave(docs))
        for item in chunk:
            if item[0] == "control":
                yield json.dumps(core.handle_control(item[1]),
                                 sort_keys=True)
            elif item[0] == "err":
                yield json.dumps(core.render(item[1], item[2]),
                                 sort_keys=True)
            else:
                yield json.dumps(core.render(next(results), item[2]),
                                 sort_keys=True)

    chunk: list = []
    for line in lines:
        item = core.parse_line(line)
        if item is None:
            continue
        chunk.append(item)
        if len(chunk) >= batch:
            yield from flush(chunk)
            chunk = []
    if chunk:
        yield from flush(chunk)


# ---------------------------------------------------------------------------
# the socket server
# ---------------------------------------------------------------------------


class _Session(threading.Thread):
    """One connection: a reader thread (this) parsing lines into
    scheduler submissions, and a writer thread demultiplexing resolved
    futures back in request order."""

    _SENTINEL = object()

    def __init__(self, server: "QueryServer", conn: socket.socket,
                 addr, sid: int) -> None:
        super().__init__(name=f"query-session-{sid}", daemon=True)
        self.server = server
        self.conn = conn
        self.addr = addr
        self.sid = sid
        self.core = SessionCore(
            server.gm, server.scheduler,
            lease_budget_bytes=server.session_lease_bytes,
            pool_lock=server.pool_lock)
        self._out: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(
            target=self._write_loop, name=f"query-session-{sid}-w",
            daemon=True)
        self._closed = threading.Event()

    # --------------------------------------------------------------- reader
    def run(self) -> None:
        self._writer.start()
        try:
            rfile = self.conn.makefile("r", encoding="utf-8",
                                       newline="\n")
            for line in rfile:
                self._pause_while_over_budget()
                item = self.core.parse_line(line)
                if item is None:
                    continue
                if item[0] == "control":
                    # handled on the writer thread so a release that
                    # follows a lease grant in the request stream sees
                    # that lease attached (strict per-session ordering)
                    self._out.put(("control", item[1]))
                elif item[0] == "err":
                    self._out.put(("ready",
                                   self.core.render(item[1], item[2])))
                else:
                    _, doc, raw_id = item
                    if self.core.over_budget():
                        self._out.put(("ready", self.core.render(
                            self.core.shed_backpressure(doc), raw_id)))
                        continue
                    fut = self.server.scheduler.submit(doc)
                    self._out.put(("future", fut, raw_id))
        except (OSError, ValueError):
            pass          # connection reset / server shutdown
        finally:
            self._out.put(self._SENTINEL)

    def _pause_while_over_budget(self) -> None:
        """Transport-level backpressure: while this session is over its
        lease budget, stop reading its socket for up to
        ``backpressure_grace_s`` (bounded, so control frames that release
        leases are always read eventually)."""
        deadline = time.monotonic() + self.server.backpressure_grace_s
        while (self.core.over_budget()
               and time.monotonic() < deadline
               and not self._closed.is_set()):
            time.sleep(0.005)

    # --------------------------------------------------------------- writer
    def _write_loop(self) -> None:
        while True:
            entry = self._out.get()
            if entry is self._SENTINEL:
                break
            try:
                if entry[0] == "ready":
                    env = entry[1]
                elif entry[0] == "control":
                    env = self.core.handle_control(entry[1])
                else:
                    _, fut, raw_id = entry
                    env = self.core.render(fut.result(timeout=120),
                                           raw_id)
                data = (json.dumps(env, sort_keys=True) + "\n").encode()
                self.conn.sendall(data)
            except (OSError, ValueError):
                break     # client went away mid-write
            except Exception:
                break     # future timeout under shutdown
        self._teardown()

    def _teardown(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self.core.release_all()       # leases auto-reclaimed on disconnect
        try:
            self.conn.close()
        except OSError:
            pass
        self.server._forget(self)

    def close(self) -> None:
        self._closed.set()
        try:
            self.conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.conn.close()
        except OSError:
            pass


class QueryServer:
    """Socket front end: threaded accept loop, one :class:`_Session` per
    connection, one shared :class:`BatchingScheduler` (see module
    docstring).  ``port=0`` binds an ephemeral port (read it back from
    :attr:`port` after :meth:`start`)."""

    def __init__(self, gm: "GraphManager", host: str = "127.0.0.1",
                 port: int = 0, *, window_ms: float = 2.0,
                 workers: int = 4, admit_horizon_ms: float = 250.0,
                 session_lease_mb: float | None = None,
                 backpressure_grace_s: float = 0.05,
                 backlog: int = 128) -> None:
        self.gm = gm
        self.scheduler = BatchingScheduler(
            gm.query, window_ms=window_ms, workers=workers,
            admit_horizon_ms=admit_horizon_ms)
        self.pool_lock = threading.RLock()
        self.session_lease_bytes = (int(session_lease_mb * 2**20)
                                    if session_lease_mb is not None
                                    else _default_session_budget(gm))
        self.backpressure_grace_s = float(backpressure_grace_s)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(backlog)
        # accept() with a short timeout so close() can stop the loop —
        # closing a socket does not reliably wake a blocked accept()
        self._listener.settimeout(0.2)
        self.host, self.port = self._listener.getsockname()[:2]
        self._sessions: dict[int, _Session] = {}
        self._sessions_lock = threading.Lock()
        self._next_sid = 0
        self._accept_thread: threading.Thread | None = None
        self._closing = threading.Event()
        self.sessions_total = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "QueryServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="query-server-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break                   # listener closed
            conn.settimeout(None)       # sessions block on reads
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._sessions_lock:
                sid = self._next_sid
                self._next_sid += 1
                sess = _Session(self, conn, addr, sid)
                self._sessions[sid] = sess
                self.sessions_total += 1
            sess.start()

    def _forget(self, sess: _Session) -> None:
        with self._sessions_lock:
            self._sessions.pop(sess.sid, None)

    def close(self) -> None:
        """Stop accepting, disconnect every session (auto-reclaiming
        their leases), drain the scheduler, join all threads."""
        if self._closing.is_set():
            return
        self._closing.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=10)
            self._accept_thread = None
        with self._sessions_lock:
            sessions = list(self._sessions.values())
        for s in sessions:
            s.close()
        for s in sessions:
            s.join(timeout=10)
            s._writer.join(timeout=10)
            s._teardown()               # idempotent; covers join timeouts
        self.scheduler.close()

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._sessions_lock:
            live = len(self._sessions)
            sheds = sum(s.core.backpressure_sheds
                        for s in self._sessions.values())
            lease_bytes = sum(s.core.lease_bytes
                              for s in self._sessions.values())
        return {"sessions_live": live,
                "sessions_total": self.sessions_total,
                "backpressure_sheds_live": sheds,
                "lease_bytes_live": lease_bytes,
                "scheduler": self.scheduler.snapshot_stats()}
