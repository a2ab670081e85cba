"""Length-prefixed binary RPC over TCP sockets, shared by the shard
client and the shard/origin servers.

Wire format — one frame per request/response, all integers little-endian:

.. code-block:: text

    u32  frame length (bytes after this field)
    u8   kind: 0 = request, 1 = response-ok, 2 = response-error
    u64  request id (responses echo the request's id)
    u32  header length; ``header`` bytes of UTF-8 JSON
    u32  blob count; per blob: u32 length + raw bytes
         (length 0xFFFFFFFF encodes ``None`` — a *missing* blob, distinct
         from an empty one, which is how batched KV fetches report holes)

The JSON header carries the method name and small structured arguments;
bulk payloads (delta blobs, eventlists) travel as raw blob attachments so
nothing re-encodes megabytes through JSON.  Deadlines are per call: the
client arms ``settimeout`` with the remaining budget before every socket
op and also ships the deadline in the header so servers can shed work
that can no longer meet it.

Transport errors are typed and classified for the fault layer
(:func:`repro_torch.runtime.fault.retry` accepts a predicate):

* :class:`RpcConnectionError` / :class:`RpcTimeout` — ``retryable=True``;
  dial failures, resets, mid-frame EOF, deadline expiry.  Another attempt
  (same server or a replica) can succeed.
* :class:`RpcProtocolError` — ``retryable=False``; framing corruption or
  a response id mismatch.  Retrying a codec bug just re-fails.
* :class:`RemoteCallError` — the handler itself raised.  Carries the
  remote exception type, message, and the full remote traceback string
  (``remote_traceback``), so a failure inside a shard process surfaces in
  the coordinator's logs with the *server-side* frames, not just a local
  re-raise site.  Retryable only when the server classified the handler's
  exception as transient (IOError/TimeoutError by default).
"""
from __future__ import annotations

import itertools
import json
import socket
import struct
import threading
import time
from typing import Any, Callable, Iterable

MAGIC_NONE = 0xFFFFFFFF          # blob-length sentinel for None
MAX_FRAME = 1 << 30              # 1 GiB sanity cap: larger is corruption

KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_ERROR = 2

_RETRYABLE_REMOTE = (IOError, TimeoutError)


# --------------------------------------------------------------------- errors
class TransportError(Exception):
    """Base for everything the RPC layer raises; ``retryable`` tells the
    fault layer whether another attempt (same server or a replica) makes
    sense."""

    retryable = False


class RpcConnectionError(TransportError, ConnectionError):
    retryable = True


class RpcTimeout(TransportError, TimeoutError):
    retryable = True


class RpcProtocolError(TransportError):
    retryable = False


class RemoteCallError(TransportError):
    """The remote handler raised.  ``remote_traceback`` is the server-side
    traceback string; it is part of ``str(e)`` so any local re-raise
    (e.g. :func:`fault.retry`, which re-raises the last attempt's
    exception object) still shows where the worker actually failed."""

    def __init__(self, method: str, remote_type: str, message: str,
                 remote_traceback: str = "", retryable: bool = False):
        self.method = method
        self.remote_type = remote_type
        self.remote_message = message
        self.remote_traceback = remote_traceback
        self.retryable = bool(retryable)
        text = f"remote {remote_type} in {method!r}: {message}"
        if remote_traceback:
            text += f"\n--- remote traceback ---\n{remote_traceback.rstrip()}"
        super().__init__(text)


# -------------------------------------------------------------------- framing
def pack_frame(kind: int, req_id: int, header: dict,
               blobs: Iterable[bytes | None] = ()) -> bytes:
    head = json.dumps(header, separators=(",", ":")).encode()
    parts = [struct.pack("<BQI", kind, req_id, len(head)), head]
    blobs = list(blobs)
    parts.append(struct.pack("<I", len(blobs)))
    for b in blobs:
        if b is None:
            parts.append(struct.pack("<I", MAGIC_NONE))
        else:
            parts.append(struct.pack("<I", len(b)))
            parts.append(bytes(b))
    body = b"".join(parts)
    return struct.pack("<I", len(body)) + body


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
        except socket.timeout as e:
            raise RpcTimeout("deadline expired mid-frame") from e
        except OSError as e:
            raise RpcConnectionError(str(e)) from e
        if not chunk:
            raise RpcConnectionError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket) -> tuple[int, int, dict,
                                             list[bytes | None]]:
    """Read one frame; raises the typed transport errors above."""
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    if length < 13 or length > MAX_FRAME:
        raise RpcProtocolError(f"bad frame length {length}")
    body = _recv_exact(sock, length)
    kind, req_id, hlen = struct.unpack_from("<BQI", body, 0)
    off = 13
    if kind not in (KIND_REQUEST, KIND_RESPONSE, KIND_ERROR):
        raise RpcProtocolError(f"bad frame kind {kind}")
    if off + hlen > len(body):
        raise RpcProtocolError("header overruns frame")
    try:
        header = json.loads(body[off:off + hlen].decode())
    except ValueError as e:
        raise RpcProtocolError(f"unparseable header: {e}") from e
    off += hlen
    if off + 4 > len(body):
        raise RpcProtocolError("truncated blob count")
    (nblobs,) = struct.unpack_from("<I", body, off)
    off += 4
    blobs: list[bytes | None] = []
    for _ in range(nblobs):
        if off + 4 > len(body):
            raise RpcProtocolError("truncated blob length")
        (blen,) = struct.unpack_from("<I", body, off)
        off += 4
        if blen == MAGIC_NONE:
            blobs.append(None)
            continue
        if off + blen > len(body):
            raise RpcProtocolError("blob overruns frame")
        blobs.append(body[off:off + blen])
        off += blen
    return kind, req_id, header, blobs


# --------------------------------------------------------------------- client
class RpcClient:
    """Pooled client for one ``(host, port)`` endpoint.

    Connections are pooled per client (LIFO, capped at ``pool_size``):
    a call pops an idle socket or dials a new one, and returns it to the
    pool only after a clean response — any transport error discards the
    socket so a poisoned stream can never serve the next call.  Thread
    safe; concurrent calls simply use distinct pooled connections.
    """

    def __init__(self, host: str, port: int, *, pool_size: int = 4,
                 connect_timeout: float = 5.0,
                 default_deadline_s: float | None = 30.0) -> None:
        self.host = host
        self.port = int(port)
        self.pool_size = int(pool_size)
        self.connect_timeout = float(connect_timeout)
        self.default_deadline_s = default_deadline_s
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._idle: list[socket.socket] = []
        self._closed = False
        self.calls = 0
        self.dials = 0

    # -- connection pool ----------------------------------------------------
    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise RpcConnectionError("client closed")
            if self._idle:
                return self._idle.pop()
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            raise RpcConnectionError(
                f"connect {self.host}:{self.port}: {e}") from e
        with self._lock:
            self.dials += 1
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self.pool_size:
                self._idle.append(sock)
                return
        sock.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for s in idle:
            s.close()

    # -- calls ----------------------------------------------------------------
    def call(self, method: str, args: dict | None = None,
             blobs: Iterable[bytes | None] = (),
             deadline_s: float | None = None) -> tuple[Any,
                                                       list[bytes | None]]:
        """Issue one request; returns ``(result, blobs)``."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req_id = next(self._ids)
        header = {"m": method, "a": args or {}}
        if deadline_s is not None:
            header["dl_s"] = round(float(deadline_s), 6)
        frame = pack_frame(KIND_REQUEST, req_id, header, blobs)
        sock = self._checkout()
        try:
            self._arm(sock, deadline)
            try:
                sock.sendall(frame)
            except socket.timeout as e:
                raise RpcTimeout(f"{method}: send deadline expired") from e
            except OSError as e:
                raise RpcConnectionError(f"{method}: {e}") from e
            self._arm(sock, deadline)
            kind, rid, rhead, rblobs = read_frame(sock)
            # validate BEFORE pooling: an id/kind anomaly means the
            # stream is desynchronized — checking it in would hand the
            # stray frame to whichever call borrows the socket next
            if rid != req_id:
                raise RpcProtocolError(
                    f"{method}: response id {rid} != request id {req_id}")
            if kind not in (KIND_RESPONSE, KIND_ERROR):
                raise RpcProtocolError(
                    f"{method}: unexpected frame kind {kind}")
        except BaseException:
            sock.close()
            raise
        self._checkin(sock)
        with self._lock:
            self.calls += 1
        if kind == KIND_ERROR:
            raise RemoteCallError(
                method, rhead.get("type", "Exception"),
                rhead.get("msg", ""), rhead.get("tb", ""),
                retryable=bool(rhead.get("retryable", False)))
        return rhead.get("r"), rblobs

    @staticmethod
    def _arm(sock: socket.socket, deadline: float | None) -> None:
        if deadline is None:
            sock.settimeout(None)
            return
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise RpcTimeout("deadline expired before socket op")
        sock.settimeout(remaining)


# --------------------------------------------------------------------- server
class RpcServer:
    """Threaded frame server dispatching ``handlers[method](args, blobs)``.

    Handlers return ``(result, blobs)`` (or just ``result``); a handler
    exception becomes an error frame carrying its type, message, full
    traceback string, and a retryable flag (True for IOError/TimeoutError
    plus anything in ``retryable_types``) — the connection stays usable.
    """

    def __init__(self, handlers: dict[str, Callable],
                 host: str = "127.0.0.1", port: int = 0,
                 retryable_types: tuple = ()) -> None:
        self.handlers = dict(handlers)
        self.retryable_types = _RETRYABLE_REMOTE + tuple(retryable_types)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0

    def start(self) -> "RpcServer":
        t = threading.Thread(target=self._accept_loop,
                             name=f"rpc-accept:{self.port}", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return                          # closed before the loop started

        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name=f"rpc-conn:{self.port}", daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    kind, req_id, header, blobs = read_frame(conn)
                except TransportError:
                    return                      # peer gone or stream poisoned
                if kind != KIND_REQUEST:
                    return
                conn.sendall(self._dispatch(req_id, header, blobs))
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def _dispatch(self, req_id: int, header: dict,
                  blobs: list[bytes | None]) -> bytes:
        import traceback as _tb
        method = header.get("m", "")
        with self._lock:
            self.requests += 1
        fn = self.handlers.get(method)
        try:
            if fn is None:
                raise KeyError(f"no such RPC method: {method!r}")
            out = fn(header.get("a", {}), blobs)
            result, out_blobs = out if isinstance(out, tuple) else (out, ())
            return pack_frame(KIND_RESPONSE, req_id, {"r": result}, out_blobs)
        except Exception as e:  # noqa: BLE001 — every handler error → frame
            with self._lock:
                self.errors += 1
            return pack_frame(KIND_ERROR, req_id, {
                "type": type(e).__name__,
                "msg": str(e),
                "tb": _tb.format_exc(),
                "retryable": isinstance(e, self.retryable_types),
            })

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self) -> "RpcServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
