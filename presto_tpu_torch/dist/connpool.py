"""Keep-alive HTTP connection pool for the exchange plane.

Port of presto_tpu/dist/connpool.py (reference: operator/
HttpPageBufferClient rides an HTTP client with pooled keep-alive
connections). One shared per-destination pool with urlopen-compatible
semantics for dist/dcn.py, dist/spool.py and dist/scheduler.py:

  - ``request(url, ...)`` returns a response with ``.status``,
    ``.headers``, ``.read(n)``, usable as a context manager; it raises
    ``urllib.error.HTTPError`` on >= 400 (code/headers/body intact) and
    ``urllib.error.URLError`` on transport failure;
  - the pool lock guards only the free-list take/put; connects, sends,
    reads and closes happen outside it;
  - a request that fails on a REUSED connection (the peer closed an
    idle keep-alive socket) retries once on a fresh connection, logged;
    POSTs never ride a reused connection, so a task submit cannot reach
    a worker twice.

Each request served on a reused connection counts into the process
totals (``pool_totals()``, overlaid on the HTTP server's /metrics) and
the thread-bound transfer sink's ``exchange_fetch_reused_conns``
registry counter; each stale-socket retry counts as a failover.
"""

from __future__ import annotations

import http.client
import io
import logging
import urllib.error
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.obs.sanitizer import make_lock, register_owner

_LOG = logging.getLogger("presto_tpu_torch.dist.connpool")

# process-lifetime totals (the dist/serde.py _TOTALS pattern)
_TOTALS = {"exchange_fetch_reused_conns": 0, "exchange_pool_failovers": 0}

# bound the response bytes close() will drain to recycle a connection
_DRAIN_LIMIT = 1 << 16


class _PooledResponse:
    """One in-flight response bound to its pooled connection. Reading
    to EOF (or closing with only a small remainder) returns the
    connection to the pool; anything irregular closes it."""

    def __init__(self, pool: "ConnectionPool", key, conn, resp):
        self._pool = pool
        self._key = key
        self._conn = conn
        self._resp = resp
        self._released = False

    @property
    def status(self) -> int:
        return self._resp.status

    @property
    def headers(self):
        return self._resp.headers

    def read(self, amt: Optional[int] = None) -> bytes:
        return self._resp.read() if amt is None else self._resp.read(amt)

    def close(self) -> None:
        if self._released:
            return
        self._released = True
        reusable = False
        try:
            if not self._resp.isclosed():
                left = self._resp.length
                if left is not None and left <= _DRAIN_LIMIT:
                    self._resp.read()
            reusable = self._resp.isclosed() and not self._resp.will_close
        except (OSError, http.client.HTTPException):
            reusable = False
        if reusable:
            self._pool._give(self._key, self._conn)
        else:
            self._conn.close()

    def __enter__(self) -> "_PooledResponse":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ConnectionPool:
    """Per-destination keep-alive connection free-lists."""

    # the free-lists are mutated in place under _lock by every thread
    # that takes or returns a connection
    _shared_attrs = ("_conns",)

    def __init__(self, max_per_dest: int = 4):
        self.max_per_dest = max_per_dest
        self._conns: Dict[Tuple[str, str], List] = {}
        self._lock = make_lock("dist.connpool.ConnectionPool._lock")
        register_owner(self, lock_attrs=("_lock",))

    def _take(self, key):
        with self._lock:
            lst = self._conns.get(key)
            if lst:
                return lst.pop()
        return None

    def _give(self, key, conn) -> None:
        with self._lock:
            lst = self._conns.setdefault(key, [])
            if len(lst) < self.max_per_dest:
                lst.append(conn)
                return
        conn.close()  # over cap: closed OUTSIDE the lock

    def request(self, url: str, *, method: str = "GET",
                data: Optional[bytes] = None, headers=(),
                timeout: float = 60.0) -> _PooledResponse:
        split = urlsplit(url)
        key = (split.scheme or "http", split.netloc)
        path = split.path or "/"
        if split.query:
            path += "?" + split.query
        hdrs = dict(headers)
        conn = self._take(key) if data is None else None
        reused = conn is not None
        while True:
            fresh = conn is None
            if fresh:
                cls = (http.client.HTTPSConnection
                       if key[0] == "https" else http.client.HTTPConnection)
                conn = cls(key[1], timeout=timeout)
            try:
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                else:
                    conn.timeout = timeout
                conn.request(method, path, body=data, headers=hdrs)
                resp = conn.getresponse()
                break
            except (http.client.HTTPException, ConnectionError,
                    OSError) as e:
                conn.close()
                conn = None
                if reused and not fresh:
                    # a stale keep-alive socket, not a peer failure:
                    # retry once fresh without burning a caller retry
                    _TOTALS["exchange_pool_failovers"] += 1
                    _LOG.warning("pooled connection to %s://%s failed "
                                 "(%s); retrying once on a fresh "
                                 "connection", key[0], key[1], e)
                    reused = False
                    continue
                raise urllib.error.URLError(e) from e
        if reused:
            _TOTALS["exchange_fetch_reused_conns"] += 1
            count = getattr(XF.current_sink(), "count_reused_conn", None)
            if count is not None:
                count()
        if resp.status >= 400:
            try:
                body = resp.read()
                reusable = resp.isclosed() and not resp.will_close
            except (OSError, http.client.HTTPException):
                body, reusable = b"", False
            if reusable:
                self._give(key, conn)
            else:
                conn.close()
            raise urllib.error.HTTPError(
                url, resp.status, resp.reason, resp.headers,
                io.BytesIO(body))
        return _PooledResponse(self, key, conn, resp)


_POOL = ConnectionPool()


def request(url: str, *, method: str = "GET",
            data: Optional[bytes] = None, headers=(),
            timeout: float = 60.0) -> _PooledResponse:
    """Issue one HTTP request through THE process-shared pool."""
    return _POOL.request(url, method=method, data=data, headers=headers,
                         timeout=timeout)


def pool_totals() -> dict:
    """Process-lifetime reuse and failover totals, for the HTTP
    server's /metrics overlay."""
    return dict(_TOTALS)
