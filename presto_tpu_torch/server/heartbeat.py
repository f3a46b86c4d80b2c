"""Heartbeat-based failure detection.

Reference: presto-main failureDetector/HeartbeatFailureDetector.java —
the coordinator periodically pings every discovered node's status
endpoint, keeps per-node success-rate stats, and marks nodes ALIVE/
FAILED so schedulers avoid dead workers (recovery model is
fail-query-retry, nodes rejoin between queries).

Port of presto_tpu/server/heartbeat.py (pure Python, copied). The
monitored "nodes" are peer coordinator/worker HTTP endpoints
(/v1/info). Detection is purely host-side (urllib over HTTP) and never
touches the device.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List

from presto_tpu_torch.obs.sanitizer import make_lock, register_owner


@dataclasses.dataclass
class NodeHealth:
    uri: str
    alive: bool = True
    consecutive_failures: int = 0
    successes: int = 0
    failures: int = 0
    last_seen: float = 0.0
    last_error: str = ""

    def info(self) -> Dict:
        total = self.successes + self.failures
        return {
            "uri": self.uri,
            "state": "ALIVE" if self.alive else "FAILED",
            "successRate": (self.successes / total) if total else 1.0,
            "consecutiveFailures": self.consecutive_failures,
            "lastSeen": self.last_seen,
            "lastError": self.last_error or None,
        }


class HeartbeatFailureDetector:
    """Pings each node's /v1/info on a fixed interval; a node is FAILED
    after `fail_after` consecutive misses and returns to ALIVE on the
    first success (reference: success-rate window + expiry)."""

    # lock discipline: the nodes map (and
    # the NodeHealth records inside it) is shared between the
    # background ping loop and query-path readers — every access goes
    # through self._lock
    _shared_attrs = ("nodes",)

    def __init__(
        self,
        node_uris: List[str],
        interval_s: float = 1.0,
        timeout_s: float = 1.0,
        fail_after: int = 3,
    ):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.fail_after = fail_after
        self.nodes: Dict[str, NodeHealth] = {
            uri: NodeHealth(uri) for uri in node_uris
        }
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # optional (uri, info_dict) callback fired on every successful
        # ping OUTSIDE self._lock — the fleet-cache index rides the
        # heartbeat plane this way (dist/cacheprobe.RemoteCacheIndex.
        # update_from_info) without a detector->index lock ordering
        self.on_info = None
        self._lock = make_lock(
            "server.heartbeat.HeartbeatFailureDetector._lock")
        register_owner(self)

    # ------------------------------------------------------------ control
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.timeout_s + 1)

    def add_node(self, uri: str) -> None:
        with self._lock:
            self.nodes.setdefault(uri, NodeHealth(uri))

    # ------------------------------------------------------------- queries
    def alive_nodes(self) -> List[str]:
        with self._lock:
            return [u for u, n in self.nodes.items() if n.alive]

    def is_alive(self, uri: str) -> bool:
        with self._lock:
            n = self.nodes.get(uri)
            return bool(n and n.alive)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return [n.info() for n in self.nodes.values()]

    # ------------------------------------------------------------ internal
    def check_once(self) -> None:
        """One ping round (exposed for deterministic tests)."""
        with self._lock:
            uris = list(self.nodes)
        for uri in uris:
            self.probe(uri)

    def probe(self, uri: str) -> bool:
        """Ping ONE node now and record the outcome in its NodeHealth
        stats — direct probes (e.g. the DCN re-admission path) stay
        visible in /v1/node snapshots instead of bypassing the
        bookkeeping."""
        ok, err, info = self._ping(uri)
        if ok and self.on_info is not None:
            # outside the lock by design (see __init__); a listener
            # failure must not poison the health bookkeeping
            try:
                self.on_info(uri, info)
            except Exception:  # noqa: BLE001 - advisory plane
                pass
        with self._lock:
            n = self.nodes.get(uri)
            if n is None:
                return ok
            if ok:
                n.successes += 1
                n.consecutive_failures = 0
                n.alive = True
                n.last_seen = time.time()
                n.last_error = ""
            else:
                n.failures += 1
                n.consecutive_failures += 1
                n.last_error = err
                if n.consecutive_failures >= self.fail_after:
                    n.alive = False
        return ok

    def _ping(self, uri: str):
        """(ok, error, info_dict) — the body parse is best-effort:
        health detection needs only the status code, the parsed body
        feeds the optional on_info listener (cacheSummary etc.)."""
        try:
            with urllib.request.urlopen(
                uri.rstrip("/") + "/v1/info", timeout=self.timeout_s
            ) as resp:
                body = resp.read()
                info = None
                try:
                    import json

                    info = json.loads(body)
                except (ValueError, UnicodeDecodeError):
                    info = None
                return resp.status == 200, "", info
        except (urllib.error.URLError, OSError, ValueError) as e:
            return False, str(e)[:200], None

    def _loop(self) -> None:  # pragma: no cover - timing loop
        while not self._stop.wait(self.interval_s):
            self.check_once()
