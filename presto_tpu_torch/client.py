"""Client for the /v1/statement protocol.

Port of presto_tpu/client.py (pure Python, copied). Reference:
presto-client client/StatementClient.java — POST the SQL, then advance
nextUri until it disappears, accumulating typed rows; honor
X-Presto-Set-Session responses by carrying the property forward on
later requests (sessions are client-held, the server is stateless).
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional


@dataclasses.dataclass
class ClientResult:
    columns: List[Dict]
    rows: List[list]
    state: str
    query_id: str
    update_type: Optional[str] = None
    error: Optional[Dict] = None


class StatementClient:
    def __init__(
        self,
        server: str = "http://127.0.0.1:8080",
        user: str = "presto",
        catalog: Optional[str] = None,
        schema: str = "default",
        timeout: float = 3600.0,
    ):
        self.server = server.rstrip("/")
        self.user = user
        self.catalog = catalog
        self.schema = schema
        self.timeout = timeout
        self.session_properties: Dict[str, str] = {}

    def _headers(self) -> Dict[str, str]:
        h = {
            "X-Presto-User": self.user,
            "X-Presto-Schema": self.schema,
            "Content-Type": "text/plain",
        }
        if self.catalog:
            h["X-Presto-Catalog"] = self.catalog
        if self.session_properties:
            h["X-Presto-Session"] = ",".join(
                f"{k}={v}" for k, v in self.session_properties.items()
            )
        return h

    def _request(self, url: str, data: Optional[bytes] = None,
                 method: str = "GET"):
        req = urllib.request.Request(
            url, data=data, headers=self._headers(), method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = json.loads(resp.read().decode())
                set_sess = resp.headers.get("X-Presto-Set-Session")
                if set_sess and "=" in set_sess:
                    k, v = set_sess.split("=", 1)
                    self.session_properties[k] = v
        except urllib.error.HTTPError as e:
            # error statuses (e.g. 429 QUERY_QUEUE_FULL) still carry the
            # protocol's error body — surface it instead of raising
            # (reference: StatementClient parses QueryResults.error)
            try:
                body = json.loads(e.read().decode())
            except Exception:  # noqa: BLE001 - no protocol body
                raise e
            if "error" not in body:
                raise e
        return body

    def execute(self, sql: str) -> ClientResult:
        deadline = time.time() + self.timeout
        body = self._request(
            f"{self.server}/v1/statement", sql.encode(), "POST"
        )
        columns: List[Dict] = []
        rows: List[list] = []
        qid = body.get("id", "")
        while True:
            if body.get("columns"):
                columns = body["columns"]
            rows.extend(body.get("data", []))
            err = body.get("error")
            nxt = body.get("nextUri")
            if err or nxt is None:
                return ClientResult(
                    columns=columns,
                    rows=rows,
                    state=body.get("stats", {}).get("state", "?"),
                    query_id=qid,
                    update_type=body.get("updateType"),
                    error=err,
                )
            if time.time() > deadline:
                raise TimeoutError(f"query {qid} timed out")
            body = self._request(nxt)
