"""GPS almanac store and Celestrak SEM-format parser.

Mirrors reference almanac.c: per-PRN record (almanac.h:21-43), SEM text
parsing with blank-line tolerance, field clamping, week-rollover +2048
(almanac.c:161-164), and partial-file tolerance (almanac.c:171-183).
(The port fetches almanacs over the network; the reference reads files only.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .constants import MAX_SAT
from .gpstime import GpsTime


@dataclass
class AlmanacPrn:
    ura: int = 0
    health: int = 0
    config_code: int = 0
    svid: int = 0
    svn: int = 0
    valid: int = 0
    toa: GpsTime = field(default_factory=lambda: GpsTime(0, 0.0))
    e: float = 0.0
    delta_i: float = 0.0
    omegadot: float = 0.0
    sqrta: float = 0.0
    omega0: float = 0.0
    aop: float = 0.0
    m0: float = 0.0
    af0: float = 0.0
    af1: float = 0.0


@dataclass
class Almanac:
    valid: int = 0
    sv: list[AlmanacPrn] = field(
        default_factory=lambda: [AlmanacPrn() for _ in range(MAX_SAT)]
    )


def read_sem_almanac(fname: str) -> Almanac:
    """Parse a SEM-format almanac file (reference almanac.c:73-184).

    On mid-file errors the partial result is kept only if EOF was reached
    (u-blox saves fewer records than announced); otherwise an empty almanac
    is returned — matching the reference's error handling.
    """
    alm = Almanac()
    try:
        with open(fname, "rt") as fp:
            lines = fp.read().splitlines()
    except OSError:
        return alm

    pos = 0

    def next_line() -> str | None:
        nonlocal pos
        if pos >= len(lines):
            return None
        s = lines[pos]
        pos += 1
        return s

    try:
        hdr = next_line()
        if hdr is None:
            raise EOFError
        parts = hdr.split()
        n = int(parts[0])

        wk = next_line()
        if wk is None:
            raise EOFError
        week, sec = (int(x) for x in wk.split()[:2])

        n -= 1
        if n > 31:
            n = 31

        for _ in range(n + 1):
            s = next_line()
            if s is None:
                raise EOFError
            if not s.strip():
                s = next_line()
                if s is None:
                    raise EOFError
            svid = int(s.split()[0])
            svid = max(1, min(32, svid))
            a = alm.sv[svid - 1]
            a.svid = svid

            s = next_line()
            if s is None:
                raise EOFError
            a.svn = int(s.split()[0]) if s.strip() else 0

            s = next_line()
            if s is None:
                raise EOFError
            a.ura = min(int(s.split()[0]), 15)

            s = next_line()
            if s is None:
                raise EOFError
            a.e, a.delta_i, a.omegadot = (float(x) for x in s.split()[:3])

            s = next_line()
            if s is None:
                raise EOFError
            a.sqrta, a.omega0, a.aop = (float(x) for x in s.split()[:3])

            s = next_line()
            if s is None:
                raise EOFError
            a.m0, a.af0, a.af1 = (float(x) for x in s.split()[:3])

            s = next_line()
            if s is None:
                raise EOFError
            a.health = min(int(s.split()[0]), 63)

            s = next_line()
            if s is None:
                raise EOFError
            a.config_code = min(int(s.split()[0]), 15)

            # Celestrak files carry modulo-1024 week numbers; apply the
            # current rollover as the reference does (almanac.c:161-164).
            a.toa = GpsTime(week + 2048, float(sec))
            a.valid = 1
            alm.valid = 1
    except (EOFError, ValueError, IndexError):
        if pos < len(lines):
            # Not EOF: malformed file — drop everything.
            return Almanac()
    return alm
