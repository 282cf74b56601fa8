"""Layered configuration: defaults < file < environment < explicit overrides.

A copy of `pinot_tpu/config.py`: the same key space, file formats and
`PINOT_TPU_` environment prefix, so one configuration file and one
environment serve both packages. Analog of the reference's PinotConfiguration
(`pinot-spi/src/main/java/org/apache/pinot/spi/env/PinotConfiguration.java`):
one key space (dotted, case-insensitive) fed from properties/JSON files, the
process environment (`PINOT_TPU_` prefix, `_` doubling as `.`), and in-code
overrides — the same precedence order the reference applies (explicit args >
env > files > defaults). Role starters consume `subset("pinot.server.")`-style
views, mirroring the reference's per-component config slicing.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional

ENV_PREFIX = "PINOT_TPU_"


def _norm(key: str) -> str:
    return key.strip().lower()


def _env_key_to_config(key: str) -> str:
    """PINOT_TPU_SERVER_QUERY_TIMEOUT -> server.query.timeout."""
    return key[len(ENV_PREFIX):].lower().replace("__", "-").replace("_", ".")


class Configuration:
    """Immutable layered key-value view; later layers win."""

    def __init__(self, *layers: Mapping[str, Any]):
        merged: Dict[str, Any] = {}
        for layer in layers:
            for k, v in layer.items():
                merged[_norm(k)] = v
        self._data = merged

    # -- constructors ------------------------------------------------------
    @staticmethod
    def load(path: Optional[str] = None,
             defaults: Optional[Mapping[str, Any]] = None,
             overrides: Optional[Mapping[str, Any]] = None,
             env: Optional[Mapping[str, str]] = None) -> "Configuration":
        """The standard stack: defaults < file < environment < overrides."""
        layers: List[Mapping[str, Any]] = [defaults or {}]
        if path:
            layers.append(read_config_file(path))
        environ = os.environ if env is None else env
        layers.append({_env_key_to_config(k): v for k, v in environ.items()
                       if k.startswith(ENV_PREFIX)})
        layers.append(overrides or {})
        return Configuration(*layers)

    # -- typed getters -----------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(_norm(key), default)

    def get_str(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self.get(key, default)
        return None if v is None else str(v)

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self.get(key)
        return default if v is None or v == "" else int(v)

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        v = self.get(key)
        return default if v is None or v == "" else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None or v == "":
            return default
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("true", "1", "yes", "on")

    def get_list(self, key: str, default: Optional[List[str]] = None) -> List[str]:
        v = self.get(key)
        if v is None or v == "":
            return list(default or [])
        if isinstance(v, (list, tuple)):
            return [str(x) for x in v]
        return [s.strip() for s in str(v).split(",") if s.strip()]

    # -- views -------------------------------------------------------------
    def subset(self, prefix: str) -> "Configuration":
        """Keys under `prefix` with the prefix stripped (reference:
        PinotConfiguration.subset)."""
        p = _norm(prefix)
        if not p.endswith("."):
            p += "."
        return Configuration({k[len(p):]: v for k, v in self._data.items()
                              if k.startswith(p)})

    def keys(self) -> List[str]:
        return sorted(self._data)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    def __contains__(self, key: str) -> bool:
        return _norm(key) in self._data

    def __repr__(self) -> str:
        return f"Configuration({len(self._data)} keys)"


def read_config_file(path: str) -> Dict[str, Any]:
    """JSON (nested dicts flatten to dotted keys) or .properties (key=value)."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return _flatten(json.loads(text))
    out: Dict[str, Any] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "!")):
            continue
        if "=" not in line:
            raise ValueError(f"bad properties line in {path}: {line!r}")
        k, v = line.split("=", 1)
        out[_norm(k)] = v.strip()
    return out


def _flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[_norm(key)] = v
    return out
