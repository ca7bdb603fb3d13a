"""Pseudorange / range-rate observation model and per-epoch channel phase.

Host-side float64, vectorized over channels. Mirrors reference
gps.c:1972-2026 (computeRange: light-time extrapolation, Sagnac correction,
SV clock, az/el, iono) and gps.c:2033-2064 (computeCodePhase: carrier/code
frequency from delta-range, absolute code-phase/bit-counter decomposition).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .atmosphere import IonoUtc, ionospheric_delay
from .constants import (
    CA_SEQ_LEN,
    CARR_TO_CODE,
    CODE_FREQ,
    LAMBDA_L1,
    OMEGA_EARTH,
    SPEED_OF_LIGHT,
)
from .frames import ecef2neu, ltcmat, neu2azel, xyz2llh
from .orbits import EphemerisSet, satpos


@dataclass
class RangeObs:
    """Vectorized range_t (reference gps.h:203-210): arrays over channels."""

    g_week: np.ndarray
    g_sec: np.ndarray
    range: np.ndarray  # pseudorange [m]
    rate: np.ndarray  # range rate [m/s]
    d: np.ndarray  # geometric distance [m]
    azel: np.ndarray  # (..., 2) az/el [rad]
    iono_delay: np.ndarray  # [m]

    def select(self, mask_or_idx) -> "RangeObs":
        i = mask_or_idx
        return RangeObs(
            self.g_week[i],
            self.g_sec[i],
            self.range[i],
            self.rate[i],
            self.d[i],
            self.azel[i],
            self.iono_delay[i],
        )


def compute_range(
    eph: EphemerisSet,
    ionoutc: IonoUtc,
    g_week,
    g_sec,
    xyz: np.ndarray,
    sv,
) -> RangeObs:
    """Pseudorange observation at receive time (reference gps.c:1972-2026).

    sv: int array of satellite indices (0-based), one per channel.
    g_sec broadcastable against sv; xyz (..., 3) receiver ECEF.
    """
    sv = np.asarray(sv)
    g_sec = np.asarray(g_sec, dtype=np.float64)
    xyz = np.asarray(xyz, dtype=np.float64)

    pos, vel, clk = satpos(eph, g_sec, sv)

    los = pos - xyz
    tau = np.sqrt((los * los).sum(axis=-1)) / SPEED_OF_LIGHT

    # Extrapolate SV position back to transmission time.
    pos = pos - vel * tau[..., None]

    # Earth-rotation (Sagnac) correction.
    xrot = pos[..., 0] + pos[..., 1] * OMEGA_EARTH * tau
    yrot = pos[..., 1] - pos[..., 0] * OMEGA_EARTH * tau
    pos = np.stack([xrot, yrot, pos[..., 2]], axis=-1)

    los = pos - xyz
    rng = np.sqrt((los * los).sum(axis=-1))

    prange = rng - SPEED_OF_LIGHT * clk[..., 0]
    rate = (vel * los).sum(axis=-1) / rng  # SV clock drift term omitted, as in C

    llh = xyz2llh(xyz)
    tmat = ltcmat(llh)
    neu = ecef2neu(los, tmat)
    azel = neu2azel(neu)

    iono = ionospheric_delay(ionoutc, g_sec, llh, azel)
    iono = np.broadcast_to(iono, prange.shape).astype(np.float64)
    prange = prange + iono

    g_week = np.broadcast_to(np.asarray(g_week), prange.shape).copy()
    g_sec_b = np.broadcast_to(g_sec, prange.shape).copy()
    return RangeObs(g_week, g_sec_b, prange, rate, rng, azel, iono)


@dataclass
class CodePhaseState:
    """Per-channel per-epoch synthesis parameters (reference channel_t subset).

    These are exactly the scalar inputs of the per-block synth kernel.
    """

    f_carr: np.ndarray  # carrier Doppler [Hz]
    f_code: np.ndarray  # code frequency [Hz]
    code_phase: np.ndarray  # initial code phase [chips)
    iword: np.ndarray  # initial word index into the 60-word buffer
    ibit: np.ndarray  # initial bit within word (0..29)
    icode: np.ndarray  # initial code period within bit (0..19)


def compute_code_phase(
    rho0_g_week,
    rho0_g_sec,
    rho0_range,
    rho1_range,
    g0_week,
    g0_sec,
    dt: float,
) -> CodePhaseState:
    """Carrier/code frequency and absolute code phase (gps.c:2033-2064).

    rho0: previous-epoch pseudorange (time/range); rho1: current. g0: the
    channel's 30 s-aligned data-bit reference time. All array-broadcastable.
    """
    rho0_range = np.asarray(rho0_range, dtype=np.float64)
    rho1_range = np.asarray(rho1_range, dtype=np.float64)

    rhorate = (rho1_range - rho0_range) / dt
    f_carr = -rhorate / LAMBDA_L1
    f_code = CODE_FREQ + f_carr * CARR_TO_CODE

    # subGpsTime(rho0.g, g0) expanded inline to keep f64 op order.
    dtg = (rho0_g_sec - np.asarray(g0_sec, dtype=np.float64)) + (
        np.asarray(rho0_g_week) - np.asarray(g0_week)
    ).astype(np.float64) * 604800.0
    ms = ((dtg + 6.0) - rho0_range / SPEED_OF_LIGHT) * 1000.0

    ims = ms.astype(np.int64)  # C (int) truncation toward zero
    code_phase = (ms - ims.astype(np.float64)) * CA_SEQ_LEN

    iword = ims // 600
    ims = ims - iword * 600
    ibit = ims // 20
    ims = ims - ibit * 20
    icode = ims

    return CodePhaseState(f_carr, f_code, code_phase, iword, ibit, icode)
