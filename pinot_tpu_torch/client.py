"""Python client for a pinot_tpu_torch cluster.

A copy of `pinot_tpu/client.py` (the analog of the reference's language
clients, `pinot-java-client` and `pinotdb`): connect to a broker, run SQL, iterate rows; plus
the controller admin surface. One import for applications:

    from pinot_tpu_torch.client import connect
    conn = connect(broker="http://localhost:8099", token="...")
    for row in conn.execute("SELECT city, COUNT(*) FROM trips GROUP BY city"):
        print(row)

`Connection.execute` returns a `ResultSet` with `columns`, `rows`,
`stats`, and iteration — a deliberately DB-API-flavored surface without the
full PEP 249 ceremony (no transactions in an OLAP store).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

from .cluster.process import BrokerClient, ControllerClient


class ResultSet:
    def __init__(self, resp: Dict[str, Any]):
        table = resp.get("resultTable") or {}
        self.columns: List[str] = table.get("dataSchema", {}).get("columnNames", [])
        self.rows: List[List[Any]] = table.get("rows", [])
        self.stats: Dict[str, Any] = {k: v for k, v in resp.items()
                                      if k != "resultTable"}

    def __iter__(self) -> Iterator[List[Any]]:
        return iter(self.rows)

    def __len__(self) -> int:
        return len(self.rows)

    def first(self) -> Optional[List[Any]]:
        return self.rows[0] if self.rows else None

    def scalar(self) -> Any:
        """The single value of a one-cell result (e.g. SELECT COUNT(*))."""
        return self.rows[0][0] if self.rows and self.rows[0] else None

    def __repr__(self) -> str:
        return f"ResultSet({self.columns}, {len(self.rows)} rows)"


class Connection:
    """A broker connection (+ optional controller admin surface).

    `token` is PER-CONNECTION — it rides each request's Authorization header,
    so two connections with different credentials coexist in one process
    (a global default would cross-contaminate them)."""

    def __init__(self, broker: str, controller: Optional[str] = None,
                 token: Optional[str] = None):
        self._broker = BrokerClient(broker, token=token)
        self.admin: Optional[ControllerClient] = (
            ControllerClient(controller, token=token) if controller else None)

    def execute(self, sql: str, timeout: float = 120.0) -> ResultSet:
        return ResultSet(self._broker.query(sql, timeout=timeout))


def connect(broker: str, controller: Optional[str] = None,
            token: Optional[str] = None) -> Connection:
    return Connection(broker, controller=controller, token=token)
