"""Peer segment download: a committed segment's tar from a replica server.

A copy of `pinot_tpu/cluster/peers.py` (the analog of the reference's
`PeerServerSegmentFinder`): the external view is the location map, and every
live server reporting a segment ONLINE serves its loaded copy over `GET
/segmentData/{table}/{segment}`. `download_segment_tar` is the one download
policy of every fetcher (a server's load, the controller's segment download):
the deep store first, with the `deepstore.retry.*` backoff of the upload path,
then a peer, for a `peer://` segment (committed while the deep store was down,
`completion.py`) or once the deep store's retries ran out (which also
quarantines the download, so that later fetches go to a peer at once).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Set, Tuple

from ..utils.metrics import get_registry
from .catalog import ONLINE

# (table, segment) pairs whose deep-store download ran out of retries: later
# fetches go to a peer at once instead of the backoff again (as the commit's
# upload quarantine in completion.py)
_download_quarantine: Set[Tuple[str, str]] = set()
_quarantine_lock = threading.Lock()


def clear_download_quarantine() -> None:
    """Give the quarantined downloads the deep store again (after it
    recovers)."""
    with _quarantine_lock:
        _download_quarantine.clear()


def peer_urls(catalog, table: str, segment: str,
              exclude_instance: Optional[str] = None) -> List[str]:
    """Base URLs of live servers whose external-view state for the segment is
    ONLINE (they hold a loaded local copy), excluding the asking instance."""
    with catalog._lock:   # copies: the catalog's dictionaries change in place
        ev = dict(catalog.external_view.get(table, {}).get(segment, {}))
        infos = {s: catalog.instances.get(s) for s in ev}
    urls = []
    for server_id, state in sorted(ev.items()):
        if state != ONLINE or server_id == exclude_instance:
            continue
        info = infos[server_id]
        if info is None or not info.alive or not info.port:
            continue
        urls.append(info.url)
    return urls


def download_segment_tar(deepstore, catalog, table: str, segment: str,
                         dest_tar: str, download_path: str,
                         exclude_instance: Optional[str] = None) -> None:
    """The segment's tar at `dest_tar`: from the deep store, with the
    `deepstore.retry.*` exponential backoff, else from a serving peer (at
    once for a `peer://` path or a quarantined download)."""
    key = (table, segment)
    with _quarantine_lock:
        quarantined = key in _download_quarantine
    if download_path.startswith("peer://") or quarantined:
        fetch_from_peer(catalog, table, segment, dest_tar,
                        exclude_instance=exclude_instance)
        return
    max_attempts = 3
    backoff_ms = 50.0
    try:
        max_attempts = max(1, int(catalog.get_property(
            "clusterConfig/deepstore.retry.max", 3)))
        backoff_ms = float(catalog.get_property(
            "clusterConfig/deepstore.retry.backoff.ms", 50))
    except (TypeError, ValueError):
        pass   # malformed knobs: the defaults
    reg = get_registry()
    for attempt in range(1, max_attempts + 1):
        if attempt > 1:
            reg.counter("pinot_deepstore_download_retries").inc()
            time.sleep(backoff_ms * 2 ** (attempt - 2) / 1000.0)
        try:
            deepstore.download(download_path, dest_tar)
            return
        except Exception:   # counted as a retry, or quarantined below
            continue
    with _quarantine_lock:
        _download_quarantine.add(key)
    reg.counter("pinot_deepstore_download_quarantined").inc()
    fetch_from_peer(catalog, table, segment, dest_tar,
                    exclude_instance=exclude_instance)


def fetch_from_peer(catalog, table: str, segment: str, dest_tar: str,
                    exclude_instance: Optional[str] = None,
                    timeout_s: float = 60.0) -> str:
    """Download the segment tar from the first answering peer; returns the
    peer URL used. Raises ConnectionError when no peer can serve it."""
    from .http_service import http_call
    last: Optional[Exception] = None
    for url in peer_urls(catalog, table, segment, exclude_instance):
        try:
            data = http_call("GET", f"{url}/segmentData/{table}/{segment}",
                             timeout=timeout_s)
        except Exception as e:
            last = e
            continue
        os.makedirs(os.path.dirname(dest_tar) or ".", exist_ok=True)
        with open(dest_tar, "wb") as f:
            f.write(data)
        return url
    raise ConnectionError(
        f"no peer can serve {table}/{segment}: {last!r}")
