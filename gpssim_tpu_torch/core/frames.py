"""WGS84 geodesy and local-frame transforms (float64 host math, vectorized).

Numerics note: NumPy's sin/cos/sqrt are bit-identical to glibc libm on this
platform, but arctan2 and power differ by up to 1 ulp, which is enough to
break sample-exact parity over long scenarios (the carrier frequency feeds a
phase accumulator). ``atan2``/``pow`` therefore route through libm via
frompyfunc. Reference semantics: gps.c:243-266 (vector helpers), 361-499
(xyz2llh/llh2xyz/ltcmat/ecef2neu/neu2azel).
"""

from __future__ import annotations

import math

import numpy as np

from .constants import PI, WGS84_ECCENTRICITY, WGS84_RADIUS

# libm-exact elementwise transcendentals (1-ulp parity with the C oracle).
_atan2_obj = np.frompyfunc(math.atan2, 2, 1)
_pow_obj = np.frompyfunc(math.pow, 2, 1)


def atan2(y, x) -> np.ndarray:
    return np.asarray(_atan2_obj(y, x), dtype=np.float64)


def libm_pow(x, p) -> np.ndarray:
    return np.asarray(_pow_obj(x, p), dtype=np.float64)


def _f64(x):
    return np.asarray(x, dtype=np.float64)


def xyz2llh(xyz: np.ndarray) -> np.ndarray:
    """ECEF → lat/lon/height, iterative (reference gps.c:361-406).

    xyz: (..., 3) float64. Returns (..., 3) [rad, rad, m].
    The loop replicates the per-element ``while |dz - dz_new| >= eps`` exactly
    by only updating not-yet-converged elements.
    """
    xyz = _f64(xyz)
    a = WGS84_RADIUS
    e2 = WGS84_ECCENTRICITY * WGS84_ECCENTRICITY
    eps = 1.0e-3

    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    norm = np.sqrt(x * x + y * y + z * z)
    invalid = norm < eps

    rho2 = x * x + y * y
    dz = e2 * z

    zdz = np.zeros_like(z)
    nh = np.ones_like(z)
    n = np.full_like(z, a)
    active = ~invalid
    # Each element iterates until its own convergence test passes, exactly
    # like the scalar C loop (the loop body always runs at least once).
    while np.any(active):
        zdz_new = z + dz
        nh_new = np.sqrt(rho2 + zdz_new * zdz_new)
        slat = zdz_new / np.where(nh_new == 0.0, 1.0, nh_new)
        n_new = a / np.sqrt(1.0 - e2 * slat * slat)
        dz_new = n_new * e2 * slat

        zdz = np.where(active, zdz_new, zdz)
        nh = np.where(active, nh_new, nh)
        n = np.where(active, n_new, n)
        converged = np.abs(dz - dz_new) < eps
        dz = np.where(active, dz_new, dz)
        active = active & ~converged

    lat = atan2(zdz, np.sqrt(rho2)).astype(np.float64)
    lon = atan2(y, x).astype(np.float64)
    hgt = nh - n

    llh = np.stack([lat, lon, hgt], axis=-1)
    if np.any(invalid):
        llh = np.where(invalid[..., None], np.array([0.0, 0.0, -a]), llh)
    return llh


def llh2xyz(llh: np.ndarray) -> np.ndarray:
    """Lat/lon/height → ECEF (reference gps.c:412-443)."""
    llh = _f64(llh)
    a = WGS84_RADIUS
    e = WGS84_ECCENTRICITY
    e2 = e * e

    clat = np.cos(llh[..., 0])
    slat = np.sin(llh[..., 0])
    clon = np.cos(llh[..., 1])
    slon = np.sin(llh[..., 1])
    d = e * slat

    n = a / np.sqrt(1.0 - d * d)
    nph = n + llh[..., 2]

    tmp = nph * clat
    return np.stack(
        [tmp * clon, tmp * slon, ((1.0 - e2) * n + llh[..., 2]) * slat], axis=-1
    )


def ltcmat(llh: np.ndarray) -> np.ndarray:
    """ECEF→NEU rotation matrix for a given lat/lon (reference gps.c:449-469).

    llh: (..., 3). Returns (..., 3, 3) with rows = N, E, U directions.
    """
    llh = _f64(llh)
    slat = np.sin(llh[..., 0])
    clat = np.cos(llh[..., 0])
    slon = np.sin(llh[..., 1])
    clon = np.cos(llh[..., 1])
    zero = np.zeros_like(slat)

    row0 = np.stack([-slat * clon, -slat * slon, clat], axis=-1)
    row1 = np.stack([-slon, clon, zero], axis=-1)
    row2 = np.stack([clat * clon, clat * slon, slat], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def ecef2neu(xyz: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Rotate an ECEF vector into NEU using ltcmat output (gps.c:476-482).

    Written out per component to keep the exact multiply/add association of
    the reference (a*x + b*y + c*z evaluated left-to-right).
    """
    xyz = _f64(xyz)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    n = t[..., 0, 0] * x + t[..., 0, 1] * y + t[..., 0, 2] * z
    e = t[..., 1, 0] * x + t[..., 1, 1] * y + t[..., 1, 2] * z
    u = t[..., 2, 0] * x + t[..., 2, 1] * y + t[..., 2, 2] * z
    return np.stack([n, e, u], axis=-1)


def neu2azel(neu: np.ndarray) -> np.ndarray:
    """NEU → (azimuth, elevation) in radians (reference gps.c:488-499)."""
    neu = _f64(neu)
    az = atan2(neu[..., 1], neu[..., 0]).astype(np.float64)
    az = np.where(az < 0.0, az + 2.0 * PI, az)
    ne = np.sqrt(neu[..., 0] * neu[..., 0] + neu[..., 1] * neu[..., 1])
    el = atan2(neu[..., 2], ne).astype(np.float64)
    return np.stack([az, el], axis=-1)
