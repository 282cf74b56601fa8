"""Plugin manager: one discovery surface over every SPI registry.

A trimmed copy of `pinot_tpu/plugins.py` (the analog of the reference's
PluginManager, `pinot-spi/.../plugin/PluginManager.java`): plugins register
themselves at import time into their SPI's registry; this module lists those
registries behind one `get` / `available` surface and imports the modules a
configuration names (`plugins.modules=a.b,c.d`), each of which registers its
factories as it loads. The registries are those this package has: the stream
factories (`memory`, `kafkalite`, `pulsar`, `kinesis`) and the stream decoders
(`ingest/stream.py`), the file readers (`ingest/readers.py`) and the
deep-store schemes (`cluster/deepstore.py`).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List

STREAM = "stream"
DECODER = "decoder"
FS = "fs"
READER = "reader"


def _stream_registry() -> Dict[str, Any]:
    from .ingest import stream
    return stream.stream_factories()


def _decoder_registry() -> Dict[str, Any]:
    from .ingest import stream
    return stream._DECODERS


def _fs_registry() -> Dict[str, Any]:
    from .cluster import deepstore
    return deepstore._FS_REGISTRY


def _reader_registry() -> Dict[str, Any]:
    from .ingest import readers
    return readers._READERS


_REGISTRIES: Dict[str, Callable[[], Dict[str, Any]]] = {
    STREAM: _stream_registry,
    DECODER: _decoder_registry,
    FS: _fs_registry,
    READER: _reader_registry,
}


def _registry(kind: str) -> Dict[str, Any]:
    reg = _REGISTRIES.get(kind)
    if reg is None:
        raise KeyError(f"unknown plugin kind {kind!r}; kinds: {sorted(_REGISTRIES)}")
    return reg()


def available(kind: str) -> List[str]:
    """Registered plugin names for one SPI kind."""
    return sorted(_registry(kind))


def get(kind: str, name: str) -> Any:
    """The registered factory or class for (kind, name)."""
    reg = _registry(kind)
    entry = reg.get(name)
    if entry is None:
        raise KeyError(f"no {kind} plugin named {name!r}; available: {sorted(reg)}")
    return entry


def load_modules(modules: List[str]) -> List[str]:
    """Import external plugin modules; each registers itself into its SPI
    registry as it loads. Returns the imported module names."""
    out = []
    for mod in modules:
        importlib.import_module(mod)
        out.append(mod)
    return out


def load_from_config(cfg) -> List[str]:
    """`plugins.modules` (a comma list) from a Configuration."""
    return load_modules(cfg.get_list("plugins.modules"))
