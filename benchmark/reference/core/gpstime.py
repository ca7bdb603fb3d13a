"""GPS time-system conversions (float64, host side).

Replicates the reference's exact semantics — including the millisecond
rounding in ``inc_gps_time`` — so scenario timelines line up bit-for-bit
(reference: gps.c:315-355 date2gps/gps2date, gps.c:1096-1124
subGpsTime/incGpsTime).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .constants import (
    SECONDS_IN_DAY,
    SECONDS_IN_HOUR,
    SECONDS_IN_MINUTE,
    SECONDS_IN_WEEK,
)

_DOY = (0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334)


@dataclass(frozen=True)
class GpsTime:
    """GPS week number (since Jan 1980) and second-of-week."""

    week: int
    sec: float


@dataclass(frozen=True)
class DateTime:
    """Calendar UTC date/time."""

    y: int
    m: int
    d: int
    hh: int
    mm: int
    sec: float


def date2gps(t: DateTime) -> GpsTime:
    """Convert UTC calendar date to GPS week/sec (reference gps.c:315-337)."""
    ye = t.y - 1980
    # Leap days since Jan 5/6 1980.
    lpdays = ye // 4 + 1
    if (ye % 4) == 0 and t.m <= 2:
        lpdays -= 1
    de = ye * 365 + _DOY[t.m - 1] + t.d + lpdays - 6
    week = de // 7
    sec = (
        float(de % 7) * SECONDS_IN_DAY
        + t.hh * SECONDS_IN_HOUR
        + t.mm * SECONDS_IN_MINUTE
        + t.sec
    )
    return GpsTime(week, sec)


def gps2date(g: GpsTime) -> DateTime:
    """Convert GPS week/sec to UTC calendar date (reference gps.c:339-355)."""
    c = int(7 * g.week + math.floor(g.sec / 86400.0) + 2444245.0) + 1537
    d = int((c - 122.1) / 365.25)
    e = 365 * d + d // 4
    f = int((c - e) / 30.6001)

    day = c - e - int(30.6001 * f)
    month = f - 1 - 12 * (f // 14)
    year = d - 4715 - ((7 + month) // 10)

    hh = (int(g.sec / 3600.0)) % 24
    mm = (int(g.sec / 60.0)) % 60
    sec = g.sec - 60.0 * math.floor(g.sec / 60.0)
    return DateTime(year, month, day, hh, mm, sec)


def sub_gps_time(g1: GpsTime, g0: GpsTime) -> float:
    """g1 - g0 in seconds (reference gps.c:1096-1103)."""
    dt = g1.sec - g0.sec
    dt += float(g1.week - g0.week) * SECONDS_IN_WEEK
    return dt


def inc_gps_time(g0: GpsTime, dt: float) -> GpsTime:
    """g0 + dt, rounded to 1 ms, with week rollover (reference gps.c:1105-1124).

    The ms rounding (round half away from zero via C round()) is load-bearing:
    the 30-second nav-regen trigger compares ``int(sec*10 + 0.5) % 300``.
    """
    week = g0.week
    sec = g0.sec + dt
    # C round(): half away from zero; sec >= 0 in practice but keep both sides.
    scaled = sec * 1000.0
    scaled = math.floor(scaled + 0.5) if scaled >= 0 else math.ceil(scaled - 0.5)
    sec = scaled / 1000.0
    while sec >= SECONDS_IN_WEEK:
        sec -= SECONDS_IN_WEEK
        week += 1
    while sec < 0.0:
        sec += SECONDS_IN_WEEK
        week -= 1
    return GpsTime(week, sec)
