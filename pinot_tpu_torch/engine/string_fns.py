"""String transform/scalar functions (host only).

A copy of `pinot_tpu/engine/string_fns.py` (analog of the reference's
`pinot-common/.../function/scalar/StringFunctions.java`). Strings never reach
the device: the scan keeps them dictionary-encoded (predicates resolve to
dict-id sets) and values are materialized on the host, in the host
aggregation path, the selection gather and the reduce. These functions
therefore run on numpy object/str arrays only, and raise when handed another
array namespace.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

from .expr import register_function


def _vec(fn, dtype=object):
    """Vectorize a scalar->scalar python function over numpy arrays."""
    def run(v, *args):
        arr = np.asarray(v)
        if arr.ndim == 0:
            return fn(arr.item(), *args)
        return np.asarray([fn(x, *args) for x in arr.ravel()],
                          dtype=dtype).reshape(arr.shape)
    return run


def _host_only(xp):
    if xp is not np:
        raise ValueError("string functions are host-side only")


@register_function("upper")
def _upper(xp, v):
    _host_only(xp)
    return _vec(lambda s: str(s).upper())(v)


@register_function("lower")
def _lower(xp, v):
    _host_only(xp)
    return _vec(lambda s: str(s).lower())(v)


@register_function("reverse")
def _reverse(xp, v):
    _host_only(xp)
    return _vec(lambda s: str(s)[::-1])(v)


@register_function("length")
def _length(xp, v):
    _host_only(xp)
    return _vec(lambda s: len(str(s)), dtype=np.int32)(v)


@register_function("substr")
def _substr(xp, v, begin, end=-1):
    # reference semantics (StringFunctions.substr): 0-based begin, exclusive end, -1 = to end
    _host_only(xp)
    b, e = int(begin), int(end)

    def one(s):
        s = str(s)
        return s[b:] if e == -1 else s[b:e]
    return _vec(one)(v)


@register_function("substring")
def _substring(xp, v, start, length=None):
    # SQL-style: 1-based start
    _host_only(xp)
    st = max(int(start) - 1, 0)

    def one(s):
        s = str(s)
        return s[st:] if length is None else s[st:st + int(length)]
    return _vec(one)(v)


def _zip_join(sep: str, vs):
    arrs = [np.asarray(v) for v in vs]
    n = max((a.shape[0] for a in arrs if a.ndim), default=0)

    def at(a, i):
        return str(a.item() if a.ndim == 0 else a[i])
    if n == 0:
        return sep.join(str(a.item()) for a in arrs)
    return np.asarray([sep.join(at(a, i) for a in arrs) for i in range(n)], dtype=object)


@register_function("concat")
def _concat(xp, *vs):
    _host_only(xp)
    # reference semantics (StringFunctions.concat): CONCAT(a, b, sep) joins the FIRST TWO
    # args with the 3rd as separator; 2-arg and n-arg forms join with no separator
    if len(vs) == 3:
        return _zip_join(str(np.asarray(vs[2]).item() if np.asarray(vs[2]).ndim == 0
                             else vs[2]), vs[:2])
    return _zip_join("", vs)


@register_function("concat_ws")
def _concat_ws(xp, sep, *vs):
    _host_only(xp)
    return _zip_join(str(sep), vs)


@register_function("trim")
def _trim(xp, v):
    _host_only(xp)
    return _vec(lambda s: str(s).strip())(v)


@register_function("ltrim")
def _ltrim(xp, v):
    _host_only(xp)
    return _vec(lambda s: str(s).lstrip())(v)


@register_function("rtrim")
def _rtrim(xp, v):
    _host_only(xp)
    return _vec(lambda s: str(s).rstrip())(v)


@register_function("strpos")
def _strpos(xp, v, needle, instance=1):
    """0-based position of the `instance`-th occurrence; -1 if absent (reference semantics)."""
    _host_only(xp)
    nd, inst = str(needle), int(instance)

    def one(s):
        s = str(s)
        pos = -1
        for _ in range(inst):
            pos = s.find(nd, pos + 1)
            if pos < 0:
                return -1
        return pos
    return _vec(one, dtype=np.int32)(v)


@register_function("replace")
def _replace(xp, v, find, sub):
    _host_only(xp)
    f, r = str(find), str(sub)
    return _vec(lambda s: str(s).replace(f, r))(v)


@register_function("lpad")
def _lpad(xp, v, size, pad):
    _host_only(xp)
    n, p = int(size), str(pad)

    def one(s):
        s = str(s)
        if len(s) >= n:
            return s[:n]
        while len(s) < n:
            s = p + s
        return s[-n:]
    return _vec(one)(v)


@register_function("rpad")
def _rpad(xp, v, size, pad):
    _host_only(xp)
    n, p = int(size), str(pad)

    def one(s):
        s = str(s)
        while len(s) < n:
            s = s + p
        return s[:n]
    return _vec(one)(v)


@register_function("startswith")
def _startswith(xp, v, prefix):
    _host_only(xp)
    p = str(prefix)
    return _vec(lambda s: str(s).startswith(p), dtype=bool)(v)


@register_function("endswith")
def _endswith(xp, v, suffix):
    _host_only(xp)
    p = str(suffix)
    return _vec(lambda s: str(s).endswith(p), dtype=bool)(v)


@register_function("contains")
def _contains(xp, v, needle):
    _host_only(xp)
    nd = str(needle)
    return _vec(lambda s: nd in str(s), dtype=bool)(v)


@register_function("split")
def _split(xp, v, delim):
    _host_only(xp)
    d = str(delim)
    return _vec(lambda s: str(s).split(d))(v)


@register_function("splitpart")
def _splitpart(xp, v, delim, index):
    _host_only(xp)
    d, i = str(delim), int(index)

    def one(s):
        parts = str(s).split(d)
        return parts[i] if 0 <= i < len(parts) else "null"
    return _vec(one)(v)


@register_function("chr")
def _chr(xp, v):
    _host_only(xp)
    return _vec(lambda c: chr(int(c)))(v)


@register_function("codepoint")
def _codepoint(xp, v):
    _host_only(xp)
    return _vec(lambda s: ord(str(s)[0]), dtype=np.int32)(v)


@register_function("md5")
def _md5(xp, v):
    _host_only(xp)
    return _vec(lambda s: hashlib.md5(_to_bytes(s)).hexdigest())(v)


@register_function("sha")
def _sha(xp, v):
    _host_only(xp)
    return _vec(lambda s: hashlib.sha1(_to_bytes(s)).hexdigest())(v)


@register_function("sha256")
def _sha256(xp, v):
    _host_only(xp)
    return _vec(lambda s: hashlib.sha256(_to_bytes(s)).hexdigest())(v)


@register_function("sha512")
def _sha512(xp, v):
    _host_only(xp)
    return _vec(lambda s: hashlib.sha512(_to_bytes(s)).hexdigest())(v)


def _to_bytes(s) -> bytes:
    return s if isinstance(s, (bytes, bytearray)) else str(s).encode("utf-8")


@register_function("regexp_extract")
def _regexp_extract(xp, v, pattern, group=0, default=""):
    _host_only(xp)
    rx = re.compile(str(pattern))
    g, d = int(group), str(default)

    def one(s):
        m = rx.search(str(s))
        return m.group(g) if m else d
    return _vec(one)(v)


@register_function("regexp_replace")
def _regexp_replace(xp, v, pattern, sub):
    _host_only(xp)
    rx = re.compile(str(pattern))
    r = str(sub)
    return _vec(lambda s: rx.sub(r, str(s)))(v)


# -- codecs (reference: ScalarFunctions toBase64/fromBase64, encodeUrl/
# decodeUrl, toUtf8/fromUtf8, hex digests already above) ----------------------

def _str_map(v, fn):
    return _vec(lambda x: None if x is None else fn(str(x)))(v)


@register_function("tobase64")
def _tobase64(xp, v):
    import base64
    return _str_map(v, lambda s: base64.b64encode(s.encode("utf-8")).decode("ascii"))


@register_function("frombase64")
def _frombase64(xp, v):
    import base64
    return _str_map(v, lambda s: base64.b64decode(s.encode("ascii")).decode("utf-8"))


@register_function("encodeurl")
def _encodeurl(xp, v):
    import urllib.parse
    return _str_map(v, lambda s: urllib.parse.quote(s, safe=""))


@register_function("decodeurl")
def _decodeurl(xp, v):
    import urllib.parse
    return _str_map(v, urllib.parse.unquote)


# -- remaining reference StringFunctions (StringFunctions.java) ---------------

@register_function("repeat")
def _repeat(xp, v, a, b=None):
    # reference forms: repeat(input, times) and repeat(input, sep, times)
    if b is None:
        sep, times = "", int(a)
    else:
        sep, times = str(a), int(b)
    return _str_map(v, lambda x: sep.join([x] * times))


@register_function("remove")
def _remove(xp, v, sub):
    return _str_map(v, lambda x: x.replace(str(sub), ""))


@register_function("leftsubstr")
def _leftsubstr(xp, v, n):
    return _str_map(v, lambda x: x[:int(n)])


@register_function("rightsubstr")
def _rightsubstr(xp, v, n):
    return _str_map(v, lambda x: x[-int(n):] if int(n) else "")


@register_function("strcmp")
def _strcmp(xp, v, other):
    o = str(other)

    def cmp(x):
        if x is None:
            return 0
        x = str(x)
        return -1 if x < o else (1 if x > o else 0)
    return _vec(cmp, dtype=np.int64)(v)


@register_function("strrpos")
def _strrpos(xp, v, sub, *start):
    sub_s = str(sub)

    def rpos(x):
        if x is None:
            return -1
        x = str(x)
        # Java lastIndexOf(str, fromIndex): the match may START at fromIndex,
        # so the rfind end bound is fromIndex + len(needle)
        end = len(x) if not start else min(len(x), int(start[0]) + len(sub_s))
        return x.rfind(sub_s, 0, end)
    return _vec(rpos, dtype=np.int64)(v)


@register_function("hammingdistance")
def _hammingdistance(xp, v, other):
    o = str(other)

    def ham(x):
        if x is None or len(str(x)) != len(o):
            return -1  # reference returns -1 on length mismatch
        return sum(1 for a, b in zip(str(x), o) if a != b)
    return _vec(ham, dtype=np.int64)(v)


@register_function("normalize")
def _normalize(xp, v, form="NFC"):
    import unicodedata
    f = str(form).upper()
    return _str_map(v, lambda x: unicodedata.normalize(f, x))


@register_function("toascii")
def _toascii(xp, v):
    return _str_map(v, lambda x: x.encode("ascii", "ignore").decode("ascii"))


@register_function("toutf8")
def _toutf8(xp, v):
    return _vec(lambda x: None if x is None else str(x).encode("utf-8"))(v)


@register_function("fromutf8")
def _fromutf8(xp, v):
    return _vec(lambda x: None if x is None
                else (bytes(x).decode("utf-8") if not isinstance(x, str) else x))(v)


@register_function("bytestohex")
def _bytestohex(xp, v):
    return _vec(lambda x: None if x is None else bytes(x).hex())(v)


@register_function("hextobytes")
def _hextobytes(xp, v):
    return _vec(lambda x: None if x is None else bytes.fromhex(str(x)))(v)


# reference spells the codecs both ways
_FUNCTIONS_ALIASES = {"base64encode": "tobase64", "base64decode": "frombase64"}
from .expr import _FUNCTIONS as _FN_REG  # noqa: E402
for _alias, _target in _FUNCTIONS_ALIASES.items():
    _FN_REG[_alias] = _FN_REG[_target]
