"""Broadcast-ephemeris satellite position/velocity/clock and visibility.

Host-side float64 NumPy, vectorized over satellites and epochs (the
reference computes this per-satellite per-0.1 s epoch in scalar C;
gps.c:508-611 satpos, gps.c:2142-2162 checkSatVisibility). The Kepler solver
replicates the per-element ``while |ek - ekold| > 1e-14`` loop with masked
updates so results are bit-identical to sequential iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .constants import (
    GM_EARTH,
    MAX_SAT,
    OMEGA_EARTH,
    R2D,
    SECONDS_IN_HALF_WEEK,
    SECONDS_IN_WEEK,
)
from .frames import atan2, ecef2neu, ltcmat, neu2azel, xyz2llh


def _zeros():
    return np.zeros(MAX_SAT, dtype=np.float64)


def _izeros():
    return np.zeros(MAX_SAT, dtype=np.int64)


@dataclass
class EphemerisSet:
    """One set of broadcast ephemerides, struct-of-arrays over 32 PRNs.

    Field names follow the RINEX nav record (reference ephem_t, gps.h:153-191).
    """

    vflg: np.ndarray = field(default_factory=lambda: np.zeros(MAX_SAT, dtype=bool))
    # Time of clock / ephemeris
    toc_week: np.ndarray = field(default_factory=_izeros)
    toc_sec: np.ndarray = field(default_factory=_zeros)
    toe_week: np.ndarray = field(default_factory=_izeros)
    toe_sec: np.ndarray = field(default_factory=_zeros)
    # Calendar time of record (used for TUI/limits only)
    t_y: np.ndarray = field(default_factory=_izeros)
    t_m: np.ndarray = field(default_factory=_izeros)
    t_d: np.ndarray = field(default_factory=_izeros)
    t_hh: np.ndarray = field(default_factory=_izeros)
    t_mm: np.ndarray = field(default_factory=_izeros)
    t_sec: np.ndarray = field(default_factory=_zeros)
    iodc: np.ndarray = field(default_factory=_izeros)
    iode: np.ndarray = field(default_factory=_izeros)
    deltan: np.ndarray = field(default_factory=_zeros)
    cuc: np.ndarray = field(default_factory=_zeros)
    cus: np.ndarray = field(default_factory=_zeros)
    cic: np.ndarray = field(default_factory=_zeros)
    cis: np.ndarray = field(default_factory=_zeros)
    crc: np.ndarray = field(default_factory=_zeros)
    crs: np.ndarray = field(default_factory=_zeros)
    ecc: np.ndarray = field(default_factory=_zeros)
    sqrta: np.ndarray = field(default_factory=_zeros)
    m0: np.ndarray = field(default_factory=_zeros)
    omg0: np.ndarray = field(default_factory=_zeros)
    inc0: np.ndarray = field(default_factory=_zeros)
    aop: np.ndarray = field(default_factory=_zeros)
    omgdot: np.ndarray = field(default_factory=_zeros)
    idot: np.ndarray = field(default_factory=_zeros)
    af0: np.ndarray = field(default_factory=_zeros)
    af1: np.ndarray = field(default_factory=_zeros)
    af2: np.ndarray = field(default_factory=_zeros)
    tgd: np.ndarray = field(default_factory=_zeros)
    sva: np.ndarray = field(default_factory=_izeros)
    svh: np.ndarray = field(default_factory=_izeros)
    code: np.ndarray = field(default_factory=_izeros)
    flag: np.ndarray = field(default_factory=_izeros)
    fit: np.ndarray = field(default_factory=_zeros)
    # Derived working variables (reference gps.c:1493-1496)
    n: np.ndarray = field(default_factory=_zeros)
    sq1e2: np.ndarray = field(default_factory=_zeros)
    A: np.ndarray = field(default_factory=_zeros)
    omgkdot: np.ndarray = field(default_factory=_zeros)

    def finalize(self) -> None:
        """Compute derived fields for valid records (gps.c:1493-1496)."""
        m = self.vflg
        self.A[m] = self.sqrta[m] * self.sqrta[m]
        self.n[m] = (
            np.sqrt(GM_EARTH / (self.A[m] * self.A[m] * self.A[m])) + self.deltan[m]
        )
        self.sq1e2[m] = np.sqrt(1.0 - self.ecc[m] * self.ecc[m])
        self.omgkdot[m] = self.omgdot[m] - OMEGA_EARTH


def _half_week_wrap(tk: np.ndarray) -> np.ndarray:
    tk = np.where(tk > SECONDS_IN_HALF_WEEK, tk - SECONDS_IN_WEEK, tk)
    tk = np.where(tk < -SECONDS_IN_HALF_WEEK, tk + SECONDS_IN_WEEK, tk)
    return tk


def satpos(
    eph: EphemerisSet, gsec, sv=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Satellite position, velocity and clock (reference gps.c:508-611).

    gsec: second-of-week, broadcastable against the selected satellites.
    sv: optional index array selecting satellites; default all 32.
    Returns (pos (...,3), vel (...,3), clk (...,2)).
    """
    idx = np.arange(MAX_SAT) if sv is None else np.asarray(sv)
    gsec = np.asarray(gsec, dtype=np.float64)

    ecc = eph.ecc[idx]
    nmm = eph.n[idx]
    sq1e2 = eph.sq1e2[idx]
    A = eph.A[idx]
    sqrta = eph.sqrta[idx]

    tk = _half_week_wrap(gsec - eph.toe_sec[idx])

    mk = eph.m0[idx] + nmm * tk
    ek = mk.copy()
    ekold = ek + 1.0
    one_minus_ecose = np.ones_like(ek)

    # Per-element while-loop with masked updates (bit-identical to scalar C).
    active = np.abs(ek - ekold) > 1.0e-14
    while np.any(active):
        ekold = np.where(active, ek, ekold)
        omec = 1.0 - ecc * np.cos(ekold)
        one_minus_ecose = np.where(active, omec, one_minus_ecose)
        ek_new = ek + (mk - ekold + ecc * np.sin(ekold)) / omec
        ek = np.where(active, ek_new, ek)
        active = active & (np.abs(ek - ekold) > 1.0e-14)

    sek = np.sin(ek)
    cek = np.cos(ek)
    ekdot = nmm / one_minus_ecose

    relativistic = -4.442807633e-10 * ecc * sqrta * sek

    pk = atan2(sq1e2 * sek, cek - ecc).astype(np.float64) + eph.aop[idx]
    pkdot = sq1e2 * ekdot / one_minus_ecose

    s2pk = np.sin(2.0 * pk)
    c2pk = np.cos(2.0 * pk)

    uk = pk + eph.cus[idx] * s2pk + eph.cuc[idx] * c2pk
    suk = np.sin(uk)
    cuk = np.cos(uk)
    ukdot = pkdot * (1.0 + 2.0 * (eph.cus[idx] * c2pk - eph.cuc[idx] * s2pk))

    rk = A * one_minus_ecose + eph.crc[idx] * c2pk + eph.crs[idx] * s2pk
    rkdot = A * ecc * sek * ekdot + 2.0 * pkdot * (
        eph.crs[idx] * c2pk - eph.crc[idx] * s2pk
    )

    ik = eph.inc0[idx] + eph.idot[idx] * tk + eph.cic[idx] * c2pk + eph.cis[idx] * s2pk
    sik = np.sin(ik)
    cik = np.cos(ik)
    ikdot = eph.idot[idx] + 2.0 * pkdot * (
        eph.cis[idx] * c2pk - eph.cic[idx] * s2pk
    )

    xpk = rk * cuk
    ypk = rk * suk
    xpkdot = rkdot * cuk - ypk * ukdot
    ypkdot = rkdot * suk + xpk * ukdot

    ok = eph.omg0[idx] + tk * eph.omgkdot[idx] - OMEGA_EARTH * eph.toe_sec[idx]
    sok = np.sin(ok)
    cok = np.cos(ok)

    pos = np.stack(
        [
            xpk * cok - ypk * cik * sok,
            xpk * sok + ypk * cik * cok,
            ypk * sik,
        ],
        axis=-1,
    )
    tmp = ypkdot * cik - ypk * sik * ikdot
    vel = np.stack(
        [
            -eph.omgkdot[idx] * pos[..., 1] + xpkdot * cok - tmp * sok,
            eph.omgkdot[idx] * pos[..., 0] + xpkdot * sok + tmp * cok,
            ypk * cik * ikdot + ypkdot * sik,
        ],
        axis=-1,
    )

    tk2 = _half_week_wrap(gsec - eph.toc_sec[idx])
    clk0 = (
        eph.af0[idx]
        + tk2 * (eph.af1[idx] + tk2 * eph.af2[idx])
        + relativistic
        - eph.tgd[idx]
    )
    clk1 = eph.af1[idx] + 2.0 * tk2 * eph.af2[idx]
    clk = np.stack([clk0, clk1], axis=-1)

    return pos, vel, clk


def check_sat_visibility(
    eph: EphemerisSet, gsec: float, xyz: np.ndarray, elv_mask_deg: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Visibility of all 32 SVs from ECEF position xyz (gps.c:2142-2162).

    Returns (state int8[32], azel float64[32, 2]) with state 1 = visible,
    0 = below mask, -1 = no valid ephemeris.
    """
    llh = xyz2llh(xyz)
    tmat = ltcmat(llh)
    pos, _, _ = satpos(eph, gsec)
    los = pos - np.asarray(xyz, dtype=np.float64)
    neu = ecef2neu(los, tmat)
    azel = neu2azel(neu)
    state = np.where(azel[:, 1] * R2D > elv_mask_deg, 1, 0).astype(np.int8)
    state = np.where(eph.vflg, state, np.int8(-1))
    return state, azel
