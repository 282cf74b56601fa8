"""The native (C) helpers of the realtime consume path, built with the system
compiler and loaded with ctypes.

A copy of `pinot_tpu/native/__init__.py` over a copy of its source
(`crc32c.c`): the CRC-32C of Kafka record batches (`crc32c`), the v2 record
walk (`decode_records`), the value splicer that joins a batch's values with a
one-byte separator (`splice_values`) and the schema-directed flat-JSON column
decoder (`json_columns`).

The library builds on first use with `cc -O3 -shared -fPIC` into
`pinot_tpu_torch/_build/`, under a name keyed by a hash of the source and the
flags, as the CUDA kernels do (`engine/cuda_lib.py`). There is no fallback: a
missing compiler or a failed build raises RuntimeError (the JAX package's
pure-Python CRC would take seconds for each megabyte-sized block). Each
function returns None only where its input is malformed, so that the caller
reports which batch was bad.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "crc32c.c")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    for cc in ("cc", "gcc", "clang"):
        path = shutil.which(cc)
        if path:
            return path
    raise RuntimeError("no C compiler (cc, gcc or clang) on PATH: the native ingest "
                       "helpers cannot be built")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libpinot_native_{digest}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    out = subprocess.run([_compiler(), *CC_FLAGS, "-o", tmp, SOURCE],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cc failed for native/crc32c.c (rc {out.returncode}):\n"
                           f"{out.stdout.decode(errors='replace')}")
    os.replace(tmp, so)   # atomic: a concurrent loader sees a whole file


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use; raises RuntimeError when it
    cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            LL = ctypes.POINTER(ctypes.c_longlong)
            lib.pinot_crc32c.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32)
            lib.pinot_crc32c.restype = ctypes.c_uint32
            lib.pinot_decode_records.argtypes = (
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_long, LL, LL, LL, LL, LL, LL)
            lib.pinot_decode_records.restype = ctypes.c_long
            lib.pinot_splice_values.argtypes = (
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_longlong, ctypes.c_long,
                ctypes.c_longlong, ctypes.c_ubyte, ctypes.c_char_p, ctypes.c_size_t, LL, LL)
            lib.pinot_splice_values.restype = ctypes.c_long
            lib.pinot_json_columns.argtypes = (
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_long, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long), ctypes.c_long,
                ctypes.POINTER(ctypes.c_double), LL, ctypes.POINTER(ctypes.c_ubyte), LL, LL,
                LL, LL, ctypes.POINTER(ctypes.c_ubyte))
            lib.pinot_json_columns.restype = ctypes.c_long
            _lib = lib
    return _lib


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `crc`."""
    data = bytes(data)
    return get_lib().pinot_crc32c(data, len(data), crc)


def splice_values(records_section: bytes, base_offset: int, count: int, min_offset: int,
                  sep: bytes = b","):
    """The values of a batch's records at or past `min_offset`, joined with
    `sep`: (bytes, n, last_offset), or None where the section is malformed."""
    lib = get_lib()
    if count <= 0:
        return b"", 0, -1
    if count > len(records_section) // 7 + 1:
        return None   # a record takes 7 bytes at least: the count is hostile
    cap = len(records_section) + count + 1
    out = np.empty(cap, dtype=np.uint8)   # no zero fill of the scratch
    out_len = ctypes.c_longlong(0)
    last = ctypes.c_longlong(-1)
    n = lib.pinot_splice_values(records_section, len(records_section), base_offset, count,
                                min_offset, sep[0], out.ctypes.data_as(ctypes.c_char_p), cap,
                                ctypes.byref(out_len), ctypes.byref(last))
    if n < 0:
        return None
    return out[:out_len.value].tobytes(), n, last.value


def json_columns(data: bytes, n_records: int, col_names: List[str]):
    """Schema-directed columnar decode of `n_records` spliced flat JSON
    objects: (nums f64[C, N], lints i64[C, N], types u8[C, N], str_off
    i64[C, N], str_len i64[C, N], rec_ranges i64[N, 2], bad bool[N]), or None
    where the outer structure is malformed.

    Cell types: 0 missing, 1 double, 2 string, 3 true, 4 false, 5 null, 6 an
    escaped string (decode the raw range), 8 int64. A `bad` row holds a
    nested value under a schema key or a number past int64: the caller parses
    that record alone."""
    lib = get_lib()
    if n_records <= 0:
        return None
    C = len(col_names)
    name_bytes = [n.encode("utf-8") for n in col_names]
    offs = (ctypes.c_long * C)()
    lens = (ctypes.c_long * C)()
    o = 0
    for i, nb in enumerate(name_bytes):
        offs[i], lens[i] = o, len(nb)
        o += len(nb)
    cells = C * n_records
    nums = np.empty(cells, dtype=np.float64)
    lints = np.empty(cells, dtype=np.int64)
    types = np.zeros(cells, dtype=np.uint8)
    str_off = np.empty(cells, dtype=np.int64)
    str_len = np.empty(cells, dtype=np.int64)
    rec_off = np.empty(n_records, dtype=np.int64)
    rec_len = np.empty(n_records, dtype=np.int64)
    bad = np.zeros(n_records, dtype=np.uint8)
    LLP = ctypes.POINTER(ctypes.c_longlong)
    n = lib.pinot_json_columns(
        data, len(data), n_records, b"".join(name_bytes), offs, lens, C,
        nums.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), lints.ctypes.data_as(LLP),
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), str_off.ctypes.data_as(LLP),
        str_len.ctypes.data_as(LLP), rec_off.ctypes.data_as(LLP), rec_len.ctypes.data_as(LLP),
        bad.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if n != n_records:
        return None
    shape = (C, n_records)
    return (nums.reshape(shape), lints.reshape(shape), types.reshape(shape),
            str_off.reshape(shape), str_len.reshape(shape),
            np.stack([rec_off, rec_len], axis=1), bad.astype(bool))


def decode_records(records_section: bytes, base_offset: int, first_ts: int,
                   count: int) -> Optional[List[Tuple[int, int, Optional[bytes], bytes]]]:
    """A v2 batch's record section -> [(offset, timestamp, key or None,
    value)], or None where the section is malformed."""
    lib = get_lib()
    if count <= 0:
        return []
    if count > len(records_section) // 7 + 1:
        return None   # a record takes 7 bytes at least: the count is hostile
    arr = ctypes.c_longlong * count
    offs, ts, koff, klen, voff, vlen = arr(), arr(), arr(), arr(), arr(), arr()
    n = lib.pinot_decode_records(records_section, len(records_section), base_offset, first_ts,
                                 count, offs, ts, koff, klen, voff, vlen)
    if n != count:
        return None
    return [(offs[i], ts[i], None if koff[i] < 0 else records_section[koff[i]:koff[i] + klen[i]],
             records_section[voff[i]:voff[i] + vlen[i]]) for i in range(count)]
