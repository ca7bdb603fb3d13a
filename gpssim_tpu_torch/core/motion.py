"""Trajectory sources: static location, user-motion CSV, interactive control.

Reference: readUserMotion gps.c:2253-2277 (CSV t,x,y,z ECEF at 10 Hz),
static/target setup gps.c:2336-2363, interactive integration gps.c:2714-2729.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import R2D, USER_MOTION_SIZE
from .frames import llh2xyz, ltcmat


def read_user_motion(filename: str, max_rows: int = USER_MOTION_SIZE) -> np.ndarray:
    """Read a motion file → float64[N, 3] ECEF at 10 Hz.

    Two formats, auto-detected by content:
    - the reference's CSV of ``t,x,y,z`` ECEF rows at 10 Hz
      (readUserMotion, gps.c:2253-2277);
    - NMEA ``$--GGA`` logs (a gps-sdr-sim-family convenience the
      reference dropped): fixes are checksum-validated, converted
      llh→ECEF, and linearly interpolated onto the 10 Hz epoch grid
      using the GGA timestamps — so a real 1 Hz receiver log replays
      directly.
    """
    with open(filename, "rt", errors="replace") as fp:
        for line in fp:
            s = line.strip()
            if not s:
                continue
            if s.startswith("$"):
                return _read_nmea_gga(filename, max_rows)
            break
    rows = []
    with open(filename, "rt") as fp:
        for line in fp:
            if len(rows) >= max_rows:
                break
            parts = line.strip().split(",")
            if len(parts) < 4:
                break
            try:
                _, x, y, z = (float(p) for p in parts[:4])
            except ValueError:
                break
            rows.append((x, y, z))
    if not rows:
        raise ValueError(f"no motion records in {filename}")
    return np.array(rows, dtype=np.float64)


def _nmea_checksum_ok(s: str) -> bool:
    """Validate ``$...*HH``; sentences without a checksum are accepted."""
    if "*" not in s:
        return True
    body, _, tail = s[1:].partition("*")
    if len(tail) < 2:
        return False
    want = 0
    for c in body:
        want ^= ord(c)
    try:
        return want == int(tail[:2], 16)
    except ValueError:
        return False


def _parse_gga(parts: list[str]) -> tuple[float, np.ndarray] | None:
    """One GGA sentence → (seconds-of-day, llh[rad,rad,m]) or None."""
    # $--GGA,hhmmss.ss,ddmm.mmm,N,dddmm.mmm,E,fix,nsat,hdop,alt,M,geoid,M,...
    if len(parts) < 11 or not parts[1] or not parts[2] or not parts[4]:
        return None
    try:
        if parts[6] and int(parts[6]) == 0:
            return None  # no fix
        t = parts[1]
        sec = int(t[0:2]) * 3600 + int(t[2:4]) * 60 + float(t[4:])
        lat = float(parts[2][:2]) + float(parts[2][2:]) / 60.0
        if parts[3] == "S":
            lat = -lat
        lon = float(parts[4][:3]) + float(parts[4][3:]) / 60.0
        if parts[5] == "W":
            lon = -lon
        alt = float(parts[9]) if parts[9] else 0.0
        geoid = float(parts[11]) if len(parts) > 11 and parts[11] else 0.0
        # GGA altitude is MSL; ellipsoidal height = MSL + geoid separation.
        return sec, np.array([lat / R2D, lon / R2D, alt + geoid])
    except (ValueError, IndexError):
        return None


def _read_nmea_gga(filename: str, max_rows: int) -> np.ndarray:
    fixes: list[tuple[float, np.ndarray]] = []
    with open(filename, "rt", errors="replace") as fp:
        for line in fp:
            s = line.strip()
            if len(s) < 10 or not s.startswith("$") or s[3:6] != "GGA":
                continue
            if not _nmea_checksum_ok(s):
                continue
            got = _parse_gga(s.split("*", 1)[0].split(","))
            if got is None:
                continue
            sec, llh = got
            if fixes:
                # Timestamps are seconds-of-day; accumulate a running day
                # offset so multi-midnight logs stay monotonic.
                prev = fixes[-1][0]
                sec += 86400.0 * np.floor(prev / 86400.0)
                if sec + 43200.0 < prev:
                    sec += 86400.0  # crossed midnight since the last fix
                if sec <= prev:
                    continue  # duplicate / out-of-order fix
            fixes.append((sec, llh))
    if not fixes:
        raise ValueError(f"no valid GGA fixes in {filename}")
    xyz = np.array([llh2xyz(llh) for _, llh in fixes])
    if len(fixes) == 1:
        return xyz[:1]
    t = np.array([sec for sec, _ in fixes])
    t = t - t[0]
    # Interpolate ECEF onto the 10 Hz epoch grid spanning the log.
    grid = np.arange(0.0, t[-1] + 1e-9, 0.1)
    if len(grid) > max_rows:
        grid = grid[:max_rows]
    out = np.empty((len(grid), 3))
    for k in range(3):
        out[:, k] = np.interp(grid, t, xyz[:, k])
    return out


def static_xyz(lat_deg: float, lon_deg: float, height_m: float) -> np.ndarray:
    """ECEF position of a static receiver (gps.c:2337-2340)."""
    llh = np.array([lat_deg / R2D, lon_deg / R2D, height_m])
    return llh2xyz(llh)


def _add_neu_transposed(xyz: np.ndarray, tmat: np.ndarray, neu) -> np.ndarray:
    """xyz + tmatᵀ·neu — the reference applies the NEU matrix with its rows
    used as columns (gps.c:2352-2357, 2723-2728); that transpose quirk is
    parity-critical and lives only here."""
    out = np.array(xyz, dtype=np.float64)
    for i in range(3):
        out[i] += (
            tmat[0][i] * neu[0] + tmat[1][i] * neu[1] + tmat[2][i] * neu[2]
        )
    return out


def apply_target_offset(
    xyz0: np.ndarray,
    llh: np.ndarray,
    distance_m: float,
    bearing_millideg: float,
    height_m: float,
) -> np.ndarray:
    """Shift the start position by a distance/bearing/height target.

    Reference gps.c:2348-2357; bearing is stored scaled by 1000 in the CLI
    layer (gps-sim.c:148), hence the /1000 here. Note the transpose use of
    the NEU matrix (rows used as columns) matches the reference.
    """
    import math

    t = ltcmat(llh)
    dirb = (bearing_millideg / 1000.0) / R2D
    neu = np.array(
        [
            distance_m * math.cos(dirb),
            distance_m * math.sin(dirb),
            height_m,
        ]
    )
    return _add_neu_transposed(xyz0, t, neu)


@dataclass
class InteractiveState:
    """Live-controllable kinematic state (gps-sim.h:36-46 target_t subset)."""

    bearing_millideg: float = 0.0  # bearing * 1000, as the reference stores it
    velocity: float = 0.0  # ground speed [m/s]
    vertical_speed: float = 0.0  # [m/s]

    def step(self, xyz: np.ndarray, tmat: np.ndarray, dt: float = 0.1) -> np.ndarray:
        """Integrate one epoch of motion (reference gps.c:2720-2728)."""
        import math

        dirb = (self.bearing_millideg / 1000.0) / R2D
        neu = np.array(
            [
                (self.velocity * math.cos(dirb)) * dt,
                (self.velocity * math.sin(dirb)) * dt,
                self.vertical_speed * dt,
            ]
        )
        return _add_neu_transposed(xyz, tmat, neu)
