"""RINEX v2/v3 GPS navigation-file parsers and scenario time setup.

Python re-implementation of the reference's fixed-column parsers
(gps.c:1131-1505 readRinex2, gps.c:1512-1891 readRinex3), including their
quirks: Fortran 'D' exponents, the v2 seconds field that is truncated to two
characters, >1 h toc gaps starting a new ephemeris set, SV-health MSB
flagging, and the 4-flag iono/UTC validity mask. Also implements scenario
start-time validation/overwrite (gps.c:2507-2608).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field


from .atmosphere import IonoUtc
from .constants import EPHEM_ARRAY_SIZE, MAX_SAT, SECONDS_IN_HOUR
from .gpstime import DateTime, GpsTime, date2gps, gps2date, inc_gps_time, sub_gps_time
from .orbits import EphemerisSet


@dataclass
class NavData:
    """Parsed navigation data: up to 13 ephemeris sets + iono/UTC params."""

    sets: list[EphemerisSet] = field(default_factory=list)
    ionoutc: IonoUtc = field(default_factory=IonoUtc)
    rinex_date: str = ""

    @property
    def neph(self) -> int:
        return len(self.sets)


def _open_text(fname: str):
    """gz-aware text open (the reference uses gzopen for both cases)."""
    with open(fname, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(fname, "rt", newline=None)
    return open(fname, "rt")


def _f(s: str) -> float:
    """Fixed-column float with Fortran D-exponent (gps.c:1079-1094).

    atof semantics: empty/garbage → 0.0.
    """
    s = s.replace("D", "E").replace("d", "E").strip()
    if not s:
        return 0.0
    try:
        return float(s)
    except ValueError:
        # atof parses the longest valid prefix.
        for i in range(len(s), 0, -1):
            try:
                return float(s[:i])
            except ValueError:
                continue
        return 0.0


def _i(s: str) -> int:
    try:
        return int(s.strip() or "0")
    except ValueError:
        return int(_f(s))


def _parse_header_v2(line: str, iono: IonoUtc, flags: int, meta: dict) -> int:
    label = line[60:].rstrip("\n")
    if label.startswith("PGM / RUN BY / DATE"):
        meta["rinex_date"] = line[40:60]
    elif label.startswith("ION ALPHA"):
        iono.alpha0 = _f(line[2:14])
        iono.alpha1 = _f(line[14:26])
        iono.alpha2 = _f(line[26:38])
        iono.alpha3 = _f(line[38:50])
        flags |= 0x1
    elif label.startswith("ION BETA"):
        iono.beta0 = _f(line[2:14])
        iono.beta1 = _f(line[14:26])
        iono.beta2 = _f(line[26:38])
        iono.beta3 = _f(line[38:50])
        flags |= 0x2
    elif label.startswith("DELTA-UTC"):
        iono.A0 = _f(line[3:22])
        iono.A1 = _f(line[22:41])
        iono.tot = _i(line[41:50])
        iono.wnt = _i(line[50:59])
        if iono.tot % 4096 == 0:
            flags |= 0x4
    elif label.startswith("LEAP SECONDS"):
        iono.dtls = _i(line[0:6])
        flags |= 0x8
    return flags


def _parse_header_v3(line: str, iono: IonoUtc, flags: int, meta: dict) -> int:
    label = line[60:].rstrip("\n")
    if label.startswith("PGM / RUN BY / DATE"):
        meta["rinex_date"] = line[40:60]
    elif label.startswith("IONOSPHERIC CORR"):
        if line.startswith("GPSA"):
            iono.alpha0 = _f(line[5:17])
            iono.alpha1 = _f(line[17:29])
            iono.alpha2 = _f(line[29:41])
            iono.alpha3 = _f(line[41:53])
            flags |= 0x1
        elif line.startswith("GPSB"):
            iono.beta0 = _f(line[5:17])
            iono.beta1 = _f(line[17:29])
            iono.beta2 = _f(line[29:41])
            iono.beta3 = _f(line[41:53])
            flags |= 0x2
    elif label.startswith("TIME SYSTEM CORR") and line.startswith("GPUT"):
        iono.A0 = _f(line[5:22])
        iono.A1 = _f(line[22:38])
        iono.tot = _i(line[38:45])
        iono.wnt = _i(line[45:51])
        if iono.tot % 4096 == 0:
            flags |= 0x4
    elif label.startswith("LEAP SECONDS"):
        iono.dtls = _i(line[0:6])
        flags |= 0x8
    return flags


def read_rinex_nav(fname: str, version: int = 2) -> NavData:
    """Parse a (optionally gzipped) RINEX v2 or v3 GPS navigation file."""
    nav = NavData()
    iono = nav.ionoutc
    meta: dict = {}
    flags = 0

    fh = _open_text(fname)
    try:
        # ---- header ----
        for line in fh:
            line = line.rstrip("\n")
            label = line[60:]
            if label.startswith("COMMENT"):
                continue
            if label.startswith("END OF HEADER"):
                break
            if label.startswith("RINEX VERSION / TYPE"):
                ver = _f(line[0:9])
                if version == 2 and ver > 3.0:
                    raise ValueError(f"not a RINEX v2 file (version {ver})")
                if version == 3 and ver < 3.0:
                    raise ValueError(f"not a RINEX v3 file (version {ver})")
                continue
            if version == 2:
                flags = _parse_header_v2(line, iono, flags, meta)
            else:
                flags = _parse_header_v3(line, iono, flags, meta)

        iono.vflg = flags == 0xF
        nav.rinex_date = meta.get("rinex_date", "")

        # ---- body ----
        sets = [EphemerisSet() for _ in range(EPHEM_ARRAY_SIZE)]
        g0: GpsTime | None = None
        ieph = 0
        lines = iter(fh)
        for line in lines:
            if version == 3:
                if not line.startswith("G"):
                    continue
                sv = _i(line[1:3]) - 1
                t = DateTime(
                    _i(line[4:8]),
                    _i(line[9:11]),
                    _i(line[12:14]),
                    _i(line[15:17]),
                    _i(line[18:20]),
                    float(_i(line[21:23])),
                )
                c0, w = 23, 19
                orbit_c0 = 4
            else:
                sv = _i(line[0:2]) - 1
                t = DateTime(
                    _i(line[3:5]) + 2000,
                    _i(line[6:8]),
                    _i(line[9:11]),
                    _i(line[12:14]),
                    _i(line[15:17]),
                    # C bug kept for parity: 4 chars copied, terminated at 2.
                    _f(line[18:20]),
                )
                c0, w = 22, 19
                orbit_c0 = 3

            if sv < 0 or sv >= MAX_SAT:
                continue

            g = date2gps(t)
            if g0 is None:
                g0 = g
            if sub_gps_time(g, g0) > SECONDS_IN_HOUR:
                g0 = g
                ieph += 1
                if ieph >= EPHEM_ARRAY_SIZE:
                    break

            e = sets[ieph]
            clk = [_f(line[c0 + w * k : c0 + w * (k + 1)]) for k in range(3)]

            try:
                rows = [next(lines) for _ in range(7)]
            except StopIteration:
                break

            def fld(row: int, col: int) -> float:
                # columns at orbit_c0, orbit_c0+19, +38, +57
                start = orbit_c0 + col * w
                return _f(rows[row][start : start + w])

            e.t_y[sv], e.t_m[sv], e.t_d[sv] = t.y, t.m, t.d
            e.t_hh[sv], e.t_mm[sv], e.t_sec[sv] = t.hh, t.mm, t.sec
            e.toc_week[sv], e.toc_sec[sv] = g.week, g.sec
            e.af0[sv], e.af1[sv], e.af2[sv] = clk

            e.iode[sv] = int(fld(0, 0))
            e.crs[sv] = fld(0, 1)
            e.deltan[sv] = fld(0, 2)
            e.m0[sv] = fld(0, 3)

            e.cuc[sv] = fld(1, 0)
            e.ecc[sv] = fld(1, 1)
            e.cus[sv] = fld(1, 2)
            e.sqrta[sv] = fld(1, 3)

            e.toe_sec[sv] = fld(2, 0)
            e.cic[sv] = fld(2, 1)
            e.omg0[sv] = fld(2, 2)
            e.cis[sv] = fld(2, 3)

            e.inc0[sv] = fld(3, 0)
            e.crc[sv] = fld(3, 1)
            e.aop[sv] = fld(3, 2)
            e.omgdot[sv] = fld(3, 3)

            e.idot[sv] = fld(4, 0)
            e.code[sv] = int(fld(4, 1))
            e.toe_week[sv] = int(fld(4, 2))
            e.flag[sv] = int(fld(4, 3))

            if version == 2:
                e.sva[sv] = int(fld(5, 0))
            svh = int(fld(5, 1))
            if 0 < svh < 32:
                svh += 32  # set MSB (gps.c:1467-1468)
            e.svh[sv] = svh
            e.tgd[sv] = fld(5, 2)
            e.iodc[sv] = int(fld(5, 3))

            e.fit[sv] = fld(6, 1)
            e.vflg[sv] = True

        if g0 is not None:
            n = min(ieph + 1, EPHEM_ARRAY_SIZE)
            nav.sets = sets[:n]
            for s in nav.sets:
                s.finalize()
    finally:
        fh.close()

    return nav


# ---------------------------------------------------------------------------
# Scenario time setup (reference gps.c:2507-2608)
# ---------------------------------------------------------------------------


def nav_time_span(nav: NavData) -> tuple[GpsTime, GpsTime]:
    """(gmin, gmax): toc of first valid SV in first and last sets."""
    gmin = gmax = GpsTime(0, 0.0)
    first = nav.sets[0]
    for sv in range(MAX_SAT):
        if first.vflg[sv]:
            gmin = GpsTime(int(first.toc_week[sv]), float(first.toc_sec[sv]))
            break
    last = nav.sets[-1]
    for sv in range(MAX_SAT):
        if last.vflg[sv]:
            gmax = GpsTime(int(last.toc_week[sv]), float(last.toc_sec[sv]))
            break
    return gmin, gmax


def apply_time_overwrite(nav: NavData, g0: GpsTime) -> None:
    """Relocate all toc/toe so the data covers g0 ("--start now" mode).

    Reference gps.c:2531-2561: shift by delta from gmin to g0 rounded down
    to a 2 h boundary; also rewrites the UTC reference week/time.
    """
    gmin, _ = nav_time_span(nav)
    gtmp = GpsTime(g0.week, float(int(g0.sec) // 7200) * 7200.0)
    dsec = sub_gps_time(gtmp, gmin)
    nav.ionoutc.wnt = gtmp.week
    nav.ionoutc.tot = int(gtmp.sec)
    for s in nav.sets:
        for sv in range(MAX_SAT):
            if not s.vflg[sv]:
                continue
            toc = inc_gps_time(GpsTime(int(s.toc_week[sv]), float(s.toc_sec[sv])), dsec)
            t = gps2date(toc)
            s.toc_week[sv], s.toc_sec[sv] = toc.week, toc.sec
            s.t_y[sv], s.t_m[sv], s.t_d[sv] = t.y, t.m, t.d
            s.t_hh[sv], s.t_mm[sv], s.t_sec[sv] = t.hh, t.mm, t.sec
            toe = inc_gps_time(GpsTime(int(s.toe_week[sv]), float(s.toe_sec[sv])), dsec)
            s.toe_week[sv], s.toe_sec[sv] = toe.week, toe.sec


def select_ephemeris_set(nav: NavData, g0: GpsTime) -> int:
    """Index of the set whose first valid toc is within [-1 h, +1 h) of g0.

    Reference gps.c:2588-2608. Returns -1 if none.
    """
    for i, s in enumerate(nav.sets):
        for sv in range(MAX_SAT):
            if s.vflg[sv]:
                dt = sub_gps_time(
                    g0, GpsTime(int(s.toc_week[sv]), float(s.toc_sec[sv]))
                )
                if -SECONDS_IN_HOUR <= dt < SECONDS_IN_HOUR:
                    return i
    return -1
