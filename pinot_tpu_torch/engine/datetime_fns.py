"""Date/time transform functions over epoch timestamps.

A copy of `pinot_tpu/engine/datetime_fns.py` (analog of the reference's
DateTimeFunctions / DateTimeConversion / DateTrunc transforms). Calendar math
is integer arithmetic (Hinnant civil-from-days) written against an array
namespace `xp`: numpy on the host, and on the device `expr.TORCH`, a torch
namespace with jax.numpy's 32-bit promotion, so that YEAR()/DATETRUNC() in a
filter or an aggregate argument run in the device filter with no host round
trip. Only `DEVICE_DATETIME_FUNCS` take the device namespace. Pattern
(SIMPLE_DATE_FORMAT) conversions are host only, as in the reference.

All epoch functions are UTC, matching the reference's default time zone.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from .expr import register_function

MILLIS = {"MILLISECONDS": 1, "SECONDS": 1000, "MINUTES": 60_000, "HOURS": 3_600_000,
          "DAYS": 86_400_000}

_DAY_MS = 86_400_000


def _floordiv(xp, a, b):
    # numpy's and torch's `//` are floor division for ints (negative-safe)
    return a // b


def _civil_from_millis(xp, millis):
    """epoch millis -> (year, month, day, day-of-year(1-based), iso-dow(Mon=1))."""
    days = _floordiv(xp, millis, _DAY_MS)
    z = days + 719468
    era = _floordiv(xp, z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(xp, doe - doe // 1460 + doe // 36524 - doe // 146096, 365)
    y = yoe + era * 400
    doy_m = doe - (365 * yoe + yoe // 4 - yoe // 100)   # day-of-era-year, Mar-1-based
    mp = _floordiv(xp, 5 * doy_m + 2, 153)
    d = doy_m - _floordiv(xp, 153 * mp + 2, 5) + 1
    m = mp + 3 - 12 * (mp // 10)
    y = y + (m <= 2)
    # ordinal day-of-year (Jan-1-based)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    doy = doy_m + 59 + leap
    n_days = 365 + leap
    doy = xp.where(doy >= n_days, doy - n_days, doy) + 1
    dow = (days + 3) % 7 + 1          # epoch day 0 = Thursday; ISO Monday=1
    return y, m, d, doy, dow


def _days_from_civil(xp, y, m, d):
    y = y - (m <= 2)
    era = _floordiv(xp, y, 400)
    yoe = y - era * 400
    mp = xp.where(m > 2, m - 3, m + 9)
    doy = _floordiv(xp, 153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _asarray(xp, v):
    return xp.asarray(v)


def _unit_str(u: Any) -> str:
    return str(u).upper()


# -- epoch unit conversions ---------------------------------------------------

@register_function("timeconvert")
def _timeconvert(xp, v, from_unit, to_unit):
    v = _asarray(xp, v)
    return v * MILLIS[_unit_str(from_unit)] // MILLIS[_unit_str(to_unit)]


def _register_epoch_fns():
    for unit, ms in MILLIS.items():
        if unit == "MILLISECONDS":
            continue
        low = unit.lower()

        def from_fn(xp, v, _ms=ms):
            return _asarray(xp, v) * _ms

        def to_fn(xp, v, _ms=ms):
            return _floordiv(xp, _asarray(xp, v), _ms)

        def from_bucket(xp, v, bucket, _ms=ms):
            return _asarray(xp, v) * (_ms * int(bucket))

        def to_bucket(xp, v, bucket, _ms=ms):
            return _floordiv(xp, _asarray(xp, v), _ms * int(bucket))

        register_function(f"fromepoch{low}")(from_fn)
        register_function(f"toepoch{low}")(to_fn)
        register_function(f"fromepoch{low}bucket")(from_bucket)
        register_function(f"toepoch{low}bucket")(to_bucket)


_register_epoch_fns()


@register_function("now")
def _now(xp):
    return int(time.time() * 1000)


@register_function("ago")
def _ago(xp, iso_period):
    # ISO-8601 duration like 'PT3H', 'P1D'; supports D/H/M/S components
    s = str(iso_period).upper()
    assert s.startswith("P"), f"bad period {iso_period!r}"
    total_ms, num, in_time = 0, "", False
    for c in s[1:]:
        if c == "T":
            in_time = True
        elif c.isdigit() or c == ".":
            num += c
        else:
            val = float(num)
            num = ""
            scale = {"D": 86_400_000, "H": 3_600_000, "S": 1000,
                     "M": 60_000 if in_time else 30 * 86_400_000,
                     "W": 7 * 86_400_000, "Y": 365 * 86_400_000}[c]
            total_ms += int(val * scale)
    return int(time.time() * 1000) - total_ms


# -- calendar field extraction ------------------------------------------------

@register_function("year")
def _year(xp, millis):
    return _civil_from_millis(xp, _asarray(xp, millis))[0]


@register_function("quarter")
def _quarter(xp, millis):
    m = _civil_from_millis(xp, _asarray(xp, millis))[1]
    return (m - 1) // 3 + 1


@register_function("month")
@register_function("monthofyear")
def _month(xp, millis):
    return _civil_from_millis(xp, _asarray(xp, millis))[1]


@register_function("dayofmonth")
@register_function("day")
def _dayofmonth(xp, millis):
    return _civil_from_millis(xp, _asarray(xp, millis))[2]


@register_function("dayofyear")
@register_function("doy")
def _dayofyear(xp, millis):
    return _civil_from_millis(xp, _asarray(xp, millis))[3]


@register_function("dayofweek")
@register_function("dow")
def _dayofweek(xp, millis):
    return _civil_from_millis(xp, _asarray(xp, millis))[4]


def _weeks_in_year(yr):
    p = (yr + yr // 4 - yr // 100 + yr // 400) % 7
    pm1 = ((yr - 1) + (yr - 1) // 4 - (yr - 1) // 100 + (yr - 1) // 400) % 7
    return 52 + ((p == 4) | (pm1 == 3))


def _iso_week_raw(xp, millis):
    """(raw week number before year-boundary adjustment, civil year)."""
    y, _, _, doy, dow = _civil_from_millis(xp, millis)
    return (doy - dow + 10) // 7, y


def _iso_week(xp, millis):
    w0, y = _iso_week_raw(xp, millis)
    return xp.where(w0 < 1, _weeks_in_year(y - 1), xp.where(w0 > _weeks_in_year(y), 1, w0))


@register_function("week")
@register_function("weekofyear")
def _week(xp, millis):
    return _iso_week(xp, _asarray(xp, millis))


@register_function("hour")
def _hour(xp, millis):
    return _floordiv(xp, _asarray(xp, millis), 3_600_000) % 24


@register_function("minute")
def _minute(xp, millis):
    return _floordiv(xp, _asarray(xp, millis), 60_000) % 60


@register_function("second")
def _second(xp, millis):
    return _floordiv(xp, _asarray(xp, millis), 1000) % 60


@register_function("millisecond")
def _millisecond(xp, millis):
    return _asarray(xp, millis) % 1000


@register_function("yearofweek")
@register_function("yow")
def _yearofweek(xp, millis):
    w0, y = _iso_week_raw(xp, _asarray(xp, millis))
    return xp.where(w0 < 1, y - 1, xp.where(w0 > _weeks_in_year(y), y + 1, y))


# -- truncation ---------------------------------------------------------------

_TRUNC_FIXED_MS = {"MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
                   "DAY": _DAY_MS}


@register_function("datetrunc")
def _datetrunc(xp, unit, millis, input_unit="MILLISECONDS", tz="UTC", output_unit=None):
    """DATETRUNC('month', ts[, inputUnit[, timeZone[, outputUnit]]]).

    Reference signature (DateTruncTransformFunction): the 4th argument is a time zone.
    Only UTC is supported — the engine stores epochs UTC-only, like the reference default.
    """
    if _unit_str(tz) not in ("UTC", "GMT", "ETC/UTC", "Z"):
        raise ValueError(f"DATETRUNC: only UTC time zone supported, got {tz!r}")
    unit_u = _unit_str(unit)
    in_ms = MILLIS[_unit_str(input_unit)]
    out_ms = MILLIS[_unit_str(output_unit)] if output_unit else in_ms
    v = _asarray(xp, millis) * in_ms
    if unit_u in _TRUNC_FIXED_MS:
        g = _TRUNC_FIXED_MS[unit_u]
        t = _floordiv(xp, v, g) * g
    elif unit_u == "WEEK":  # truncate to Monday
        days = _floordiv(xp, v, _DAY_MS)
        dow0 = (days + 3) % 7            # Monday=0
        t = (days - dow0) * _DAY_MS
    else:
        y, m, d, _, _ = _civil_from_millis(xp, v)
        if unit_u == "MONTH":
            t = _days_from_civil(xp, y, m, 1 * xp.ones_like(d)) * _DAY_MS
        elif unit_u == "QUARTER":
            qm = ((m - 1) // 3) * 3 + 1
            t = _days_from_civil(xp, y, qm, 1 * xp.ones_like(d)) * _DAY_MS
        elif unit_u == "YEAR":
            t = _days_from_civil(xp, y, 1 * xp.ones_like(m), 1 * xp.ones_like(d)) * _DAY_MS
        else:
            raise ValueError(f"unsupported DATETRUNC unit {unit!r}")
    return _floordiv(xp, t, out_ms)


# -- DATETIMECONVERT ----------------------------------------------------------

def _parse_dt_format(fmt: str):
    """Pinot datetime format 'size:UNIT:EPOCH|SIMPLE_DATE_FORMAT[:pattern]'."""
    parts = str(fmt).split(":", 3)
    size = int(parts[0])
    unit = parts[1].upper()
    kind = parts[2].upper()
    pattern = parts[3] if len(parts) > 3 else None
    return size, unit, kind, pattern


def _sdf_to_strftime(pattern: str) -> str:
    """Joda/SimpleDateFormat pattern -> strftime (common subset)."""
    out, i = [], 0
    mapping = [("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
               ("mm", "%M"), ("ss", "%S"), ("SSS", "%f")]
    while i < len(pattern):
        for tok, rep in mapping:
            if pattern.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            out.append(pattern[i])
            i += 1
    return "".join(out)


def _millis_to_sdf(millis_arr: np.ndarray, pattern: str) -> np.ndarray:
    strf = _sdf_to_strftime(pattern)
    trunc_us = "%f" in strf

    def one(ms):
        t = time.gmtime(ms / 1000.0)
        s = time.strftime(strf.replace("%f", f"{int(ms % 1000):03d}"), t) if trunc_us \
            else time.strftime(strf, t)
        return s
    return np.asarray([one(int(ms)) for ms in np.asarray(millis_arr).ravel()],
                      dtype=object).reshape(np.shape(millis_arr))


def _sdf_to_millis(values: np.ndarray, pattern: str) -> np.ndarray:
    import calendar
    import re as _re
    strf = _sdf_to_strftime(pattern)
    # Build a regex with a named group per directive so SSS can sit anywhere in the pattern
    # (time.strptime has no %f).
    directive_rx = {"%Y": r"(?P<Y>\d{4})", "%y": r"(?P<y>\d{2})", "%m": r"(?P<m>\d{1,2})",
                    "%d": r"(?P<d>\d{1,2})", "%H": r"(?P<H>\d{1,2})", "%M": r"(?P<M>\d{1,2})",
                    "%S": r"(?P<S>\d{1,2})", "%f": r"(?P<f>\d{3})"}
    rx, i = [], 0
    while i < len(strf):
        if strf[i] == "%" and strf[i:i + 2] in directive_rx:
            rx.append(directive_rx[strf[i:i + 2]])
            i += 2
        else:
            rx.append(_re.escape(strf[i]))
            i += 1
    compiled = _re.compile("".join(rx) + r"$")

    def one(s):
        m = compiled.match(str(s))
        if not m:
            raise ValueError(f"value {s!r} does not match datetime pattern {pattern!r}")
        g = m.groupdict()
        year = int(g.get("Y") or (2000 + int(g["y"]) if g.get("y") else 1970))
        t = (year, int(g.get("m") or 1), int(g.get("d") or 1),
             int(g.get("H") or 0), int(g.get("M") or 0), int(g.get("S") or 0), 0, 0, 0)
        return calendar.timegm(t) * 1000 + int(g.get("f") or 0)
    return np.asarray([one(v) for v in np.asarray(values).ravel()],
                      dtype=np.int64).reshape(np.shape(values))


@register_function("fromdatetime")
def _fromdatetime(xp, values, pattern):
    if xp is not np:
        raise ValueError("FROMDATETIME is host-side only")
    return _sdf_to_millis(values, str(pattern))


@register_function("todatetime")
def _todatetime(xp, millis, pattern):
    if xp is not np:
        raise ValueError("TODATETIME is host-side only")
    return _millis_to_sdf(millis, str(pattern))


@register_function("datetimeconvert")
def _datetimeconvert(xp, v, input_fmt, output_fmt, granularity):
    """DATETIMECONVERT(col, '1:MILLISECONDS:EPOCH', '1:DAYS:EPOCH', '1:DAYS')."""
    in_size, in_unit, in_kind, in_pat = _parse_dt_format(str(input_fmt))
    out_size, out_unit, out_kind, out_pat = _parse_dt_format(str(output_fmt))
    g_parts = str(granularity).split(":")
    g_ms = int(g_parts[0]) * MILLIS[g_parts[1].upper()]

    if in_kind == "EPOCH":
        millis = _asarray(xp, v) * (in_size * MILLIS[in_unit])
    else:
        if xp is not np:
            raise ValueError("SIMPLE_DATE_FORMAT input is host-side only")
        millis = _sdf_to_millis(v, in_pat)

    millis = _floordiv(xp, millis, g_ms) * g_ms

    if out_kind == "EPOCH":
        return _floordiv(xp, millis, out_size * MILLIS[out_unit])
    if xp is not np:
        raise ValueError("SIMPLE_DATE_FORMAT output is host-side only")
    return _millis_to_sdf(millis, out_pat)


# Device-evaluable subset, part of `expr.DEVICE_FUNCS`. The device compute path is
# int32 (datablock narrows 64->32 and the planner rejects columns whose values exceed
# int32), so only value-SHRINKING functions are admitted: calendar extraction and
# TOEPOCH* floor-divide their input down. Unit-up-scaling functions (FROMEPOCH*,
# TIMECONVERT, DATETRUNC with sub-milli blowup) multiply intermediates past int32 and
# run on the 64-bit host path.
DEVICE_DATETIME_FUNCS = frozenset({
    "year", "quarter", "month", "monthofyear", "day", "dayofmonth",
    "dayofyear", "doy", "dayofweek", "dow", "week", "weekofyear", "yearofweek", "yow",
    "hour", "minute", "second", "millisecond",
} | {f"toepoch{u.lower()}{suf}" for u in ("SECONDS", "MINUTES", "HOURS", "DAYS")
     for suf in ("", "bucket")})


# -- timestamp arithmetic (reference: DateTimeFunctions timestampAdd/
# timestampDiff aka dateAdd/dateDiff, totimestamp/fromtimestamp) --------------

_FIXED_UNIT_MS = {"MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000,
                  "HOUR": 3_600_000, "DAY": 86_400_000, "WEEK": 7 * 86_400_000}


def _ts_shift_calendar(ms: int, unit: str, amount: int) -> int:
    import calendar
    import datetime as _dt
    d = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc) \
        + _dt.timedelta(milliseconds=int(ms))
    if unit == "YEAR":
        y = d.year + amount
        d = d.replace(year=y, day=min(d.day, calendar.monthrange(y, d.month)[1]))
    else:  # MONTH / QUARTER — day-of-month clamps to the target month's length
        months = amount * (3 if unit == "QUARTER" else 1)
        total = d.year * 12 + (d.month - 1) + months
        y, m = divmod(total, 12)
        d = d.replace(year=y, month=m + 1,
                      day=min(d.day, calendar.monthrange(y, m + 1)[1]))
    # integer epoch math: float timestamp() truncation would drop 1 ms on ~1%
    # of inputs, silently breaking equality filters on the shifted value
    return calendar.timegm(d.timetuple()) * 1000 + d.microsecond // 1000


@register_function("timestampadd")
def _timestampadd(xp, unit, amount, ts):
    """timestampAdd('MONTH', n, tsMs): calendar-aware for YEAR/QUARTER/MONTH,
    fixed-width otherwise (reference: DateTimeFunctions.timestampAdd)."""
    u = str(unit).upper()
    n = int(amount)
    arr = np.asarray(ts)
    if u in _FIXED_UNIT_MS:
        return (arr.astype(np.int64) + n * _FIXED_UNIT_MS[u])
    if u not in ("YEAR", "QUARTER", "MONTH"):
        raise ValueError(f"timestampAdd: unknown unit {unit!r}")
    if arr.ndim == 0:
        return _ts_shift_calendar(int(arr), u, n)
    return np.asarray([_ts_shift_calendar(int(x), u, n) for x in arr.ravel()],
                      dtype=np.int64).reshape(arr.shape)


@register_function("dateadd")
def _dateadd(xp, unit, amount, ts):
    return _timestampadd(xp, unit, amount, ts)


@register_function("timestampdiff")
def _timestampdiff(xp, unit, a, b):
    """timestampDiff(unit, tsA, tsB) = whole units from A to B
    (reference: DateTimeFunctions.timestampDiff)."""
    u = str(unit).upper()
    aa = np.asarray(a).astype(np.int64)
    bb = np.asarray(b).astype(np.int64)
    if u in _FIXED_UNIT_MS:
        return (bb - aa) // _FIXED_UNIT_MS[u]

    def months_between(x, y):
        import datetime as _dt
        dx = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc) \
            + _dt.timedelta(milliseconds=int(x))
        dy = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc) \
            + _dt.timedelta(milliseconds=int(y))
        m = (dy.year - dx.year) * 12 + (dy.month - dx.month)
        # partial month doesn't count
        if m > 0 and (dy.day, dy.time()) < (dx.day, dx.time()):
            m -= 1
        elif m < 0 and (dy.day, dy.time()) > (dx.day, dx.time()):
            m += 1
        return m

    if u not in ("YEAR", "QUARTER", "MONTH"):
        raise ValueError(f"timestampDiff: unknown unit {unit!r}")
    div = {"YEAR": 12, "QUARTER": 3, "MONTH": 1}[u]
    flat_a, flat_b = np.broadcast_arrays(aa, bb)
    if flat_a.ndim == 0:
        return months_between(int(flat_a), int(flat_b)) // div
    out = np.asarray([months_between(int(x), int(y)) // div
                      for x, y in zip(flat_a.ravel(), flat_b.ravel())],
                     dtype=np.int64)
    return out.reshape(flat_a.shape)


@register_function("datediff")
def _datediff(xp, unit, a, b):
    return _timestampdiff(xp, unit, a, b)


@register_function("totimestamp")
def _totimestamp(xp, v):
    # ms since epoch passthrough (the reference converts long -> java Timestamp)
    return np.asarray(v).astype(np.int64)


@register_function("fromtimestamp")
def _fromtimestamp(xp, v):
    return np.asarray(v).astype(np.int64)


def _tz_offset_seconds(tz, millis) -> int:
    """UTC offset of `tz` at `millis` (reference 1-arg form evaluates at epoch
    0 — deterministic, unlike wall-clock now() which flips with DST)."""
    import datetime as _dt
    import zoneinfo
    at = _dt.datetime.fromtimestamp(int(millis) / 1000, _dt.timezone.utc)
    return int(at.astimezone(zoneinfo.ZoneInfo(str(tz))).utcoffset()
               .total_seconds())


@register_function("timezonehour")
def _timezonehour(xp, tz, millis=0):
    total = _tz_offset_seconds(tz, millis)
    return int(total / 3600)  # truncate toward zero: -3:30 -> hour -3


@register_function("timezoneminute")
def _timezoneminute(xp, tz, millis=0):
    total = _tz_offset_seconds(tz, millis)
    hours = int(total / 3600)
    return int((total - hours * 3600) / 60)  # -3:30 -> minute -30
