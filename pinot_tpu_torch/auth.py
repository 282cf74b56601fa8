"""Auth SPI: principals, token authentication, table-level access control.

A copy of `pinot_tpu/auth.py`. Analog of the reference's access-control SPI (`pinot-spi/.../auth/`, wired by
`BasicAuthAccessControlFactory` on the controller/broker: credentials map to
principals carrying table ACLs and permissions). Here the credential is a
bearer token (`Authorization: Bearer <token>`); the HTTP layer authenticates
once per request and route handlers enforce table-level authorization through
`require_table_access`. One process = one outgoing identity
(`set_default_token`), mirroring the reference's per-service auth tokens.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional

READ = "READ"
WRITE = "WRITE"
ADMIN = "ADMIN"

_IMPLIES = {ADMIN: {ADMIN, WRITE, READ}, WRITE: {WRITE, READ}, READ: {READ}}


class AuthError(Exception):
    """Carries the HTTP status the service layer should answer with."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


@dataclass(frozen=True)
class Principal:
    """An authenticated identity (reference: ZkBasicAuthPrincipal)."""

    name: str
    permissions: FrozenSet[str] = frozenset({READ})
    tables: Optional[FrozenSet[str]] = None   # None = every table

    def allows(self, action: str, table: Optional[str] = None) -> bool:
        granted = set()
        for p in self.permissions:
            granted |= _IMPLIES.get(p, {p})
        if action not in granted:
            return False
        if table is None or self.tables is None:
            return True
        # table ACLs match the logical name: `t`, `t_OFFLINE`, `t_REALTIME`
        base = table.rsplit("_", 1)[0] if table.endswith(("_OFFLINE", "_REALTIME")) \
            else table
        return table in self.tables or base in self.tables


class AccessControl:
    """SPI: authenticate a bearer token into a Principal (None = reject)."""

    def authenticate(self, token: Optional[str]) -> Optional[Principal]:
        raise NotImplementedError


@dataclass
class StaticTokenAccessControl(AccessControl):
    """Token -> principal map (the BasicAuth analog for bearer tokens)."""

    tokens: Dict[str, Principal] = field(default_factory=dict)

    def authenticate(self, token):
        return self.tokens.get(token) if token else None

    @staticmethod
    def from_config(cfg) -> Optional["StaticTokenAccessControl"]:
        """`auth.tokens = tok1=admin:*:ADMIN, tok2=bob:tableA|tableB:READ` —
        None when the key is absent (auth disabled)."""
        entries = cfg.get_list("auth.tokens")
        if not entries:
            return None
        tokens: Dict[str, Principal] = {}
        for entry in entries:
            token, spec = entry.split("=", 1)
            name, tables, perms = spec.split(":")
            tokens[token.strip()] = Principal(
                name.strip(),
                frozenset(p.strip().upper() for p in perms.split("|")),
                None if tables.strip() == "*" else
                frozenset(t.strip() for t in tables.split("|")))
        return StaticTokenAccessControl(tokens)


# -- per-request principal (set by HttpService, read by route handlers) -------
_local = threading.local()


def set_current_principal(p: Optional[Principal]) -> None:
    _local.principal = p


def current_principal() -> Optional[Principal]:
    return getattr(_local, "principal", None)


def require_table_access(table: str, action: str = READ) -> None:
    """Route-handler hook: 403 when the request's principal lacks the table
    permission. No-op when the service runs without access control."""
    p = current_principal()
    if p is not None and not p.allows(action, table):
        raise AuthError(403, f"{p.name} lacks {action} on {table}")
