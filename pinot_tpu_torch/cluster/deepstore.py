"""Deep store: durable segment storage behind a filesystem SPI.

A trimmed copy of `pinot_tpu/cluster/deepstore.py` (the analog of the
reference's PinotFS and segment fetchers): `DeepStoreFS`, the SPI, and
`LocalDeepStore`, plain paths under a root. Segments travel as gzip tar files
(`tar_segment`, `untar_segment`) in the JAX package's layout, so either
package's servers read the other's deep store. The in-memory, S3, GCS, HDFS
and ADLS stores wait.
"""

from __future__ import annotations

import os
import shutil
import tarfile
import tempfile
import threading
from typing import Callable, Dict, List

#: gzip level of a segment tar: level 1 packs a 2,097,152-row lineorder
#: segment (55 MB) into 36 MB in under a quarter of level 6's time, for 4%
#: more bytes; level 0 stores it (55 MB) in a tenth of level 1's time
TAR_COMPRESS_LEVEL = 1
#: bytes a tar moves a copy: with the default 16 KiB, eight unpacks at once
#: spend their time taking turns on the interpreter lock
TAR_COPY_BYTES = 1 << 20


class DeepStoreFS:
    """Filesystem SPI: copy, open and delete by URI."""

    scheme = ""

    def upload(self, local_path: str, uri: str) -> None:
        raise NotImplementedError

    def download(self, uri: str, local_path: str) -> None:
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        raise NotImplementedError

    def listdir(self, uri: str) -> List[str]:
        raise NotImplementedError

    def move(self, src_uri: str, dst_uri: str) -> None:
        """Download to a temporary file, upload, delete: a store without a
        rename streams through disk. A store with one overrides it."""
        with tempfile.TemporaryDirectory() as tmp:
            local = os.path.join(tmp, "moving")
            self.download(src_uri, local)
            self.upload(local, dst_uri)
        self.delete(src_uri)

    def put_bytes(self, data: bytes, uri: str) -> None:
        with tempfile.TemporaryDirectory() as tmp:
            local = os.path.join(tmp, "blob")
            with open(local, "wb") as f:
                f.write(data)
            self.upload(local, uri)

    def get_bytes(self, uri: str) -> bytes:
        with tempfile.TemporaryDirectory() as tmp:
            local = os.path.join(tmp, "blob")
            self.download(uri, local)
            with open(local, "rb") as f:
                return f.read()


class LocalDeepStore(DeepStoreFS):
    """The reference's LocalPinotFS: URIs are plain paths under a root."""

    scheme = "local"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, uri: str) -> str:
        return os.path.join(self.root, uri.lstrip("/"))

    def upload(self, local_path: str, uri: str) -> None:
        dest = self._path(uri)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        # copy to a temporary name, then rename: no reader sees a torn file
        tmp = f"{dest}.tmp.{os.getpid()}.{threading.get_ident()}"
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, dest)

    def download(self, uri: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        shutil.copyfile(self._path(uri), local_path)

    def delete(self, uri: str) -> None:
        p = self._path(uri)
        if os.path.isfile(p):
            os.remove(p)
        elif os.path.isdir(p):
            shutil.rmtree(p)

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._path(uri))

    def listdir(self, uri: str) -> List[str]:
        p = self._path(uri)
        return sorted(os.listdir(p)) if os.path.isdir(p) else []

    def move(self, src_uri: str, dst_uri: str) -> None:
        src, dst = self._path(src_uri), self._path(dst_uri)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(src, dst)


# scheme -> factory (the reference's PinotFSFactory)
_FS_REGISTRY: Dict[str, Callable[[str], DeepStoreFS]] = {"local": LocalDeepStore}


def register_fs(scheme: str, cls: Callable[[str], DeepStoreFS]) -> None:
    _FS_REGISTRY[scheme] = cls


def create_fs(spec: str) -> DeepStoreFS:
    """A store from "scheme://root" ("local:///data/deepstore")."""
    scheme, _, root = spec.partition("://")
    cls = _FS_REGISTRY.get(scheme)
    if cls is None:
        raise ValueError(f"unknown deep-store scheme {scheme!r} "
                         f"(registered: {sorted(_FS_REGISTRY)})")
    return cls(root)


def tar_segment(segment_dir: str, out_path: str) -> str:
    """Pack a segment directory into a gzip tar."""
    with tarfile.open(out_path, "w:gz", compresslevel=TAR_COMPRESS_LEVEL,
                      copybufsize=TAR_COPY_BYTES) as tar:
        tar.add(segment_dir, arcname=os.path.basename(segment_dir))
    return out_path


def untar_segment(tar_path: str, dest_dir: str) -> str:
    """Unpack; returns the segment directory. The tar is read as a stream,
    in one pass: listing its names first would decompress it twice."""
    names = []

    def members(tar):
        for member in tar:
            names.append(member.name)
            yield member
    with tarfile.open(tar_path, "r|gz", copybufsize=TAR_COPY_BYTES) as tar:
        tar.extractall(dest_dir, members=members(tar), filter="data")
    if not names:
        raise ValueError(f"{tar_path}: an empty segment tar")
    return os.path.join(dest_dir, names[0].split("/")[0])
