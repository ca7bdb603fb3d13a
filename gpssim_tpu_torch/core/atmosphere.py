"""Klobuchar single-frequency ionospheric delay (IS-GPS-200 model).

Vectorized float64 host math replicating reference gps.c:1893-1964 exactly,
including the truncated-PI constant, the libm pow() obliquity term, and the
no-data fallback F*5e-9*c.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import PI, SECONDS_IN_DAY, SPEED_OF_LIGHT
from .frames import libm_pow


@dataclass
class IonoUtc:
    """Ionosphere + UTC parameters from the RINEX header (gps.h:193-201)."""

    enable: bool = True
    vflg: bool = False
    alpha0: float = 0.0
    alpha1: float = 0.0
    alpha2: float = 0.0
    alpha3: float = 0.0
    beta0: float = 0.0
    beta1: float = 0.0
    beta2: float = 0.0
    beta3: float = 0.0
    A0: float = 0.0
    A1: float = 0.0
    dtls: int = 0
    tot: int = 0
    wnt: int = 0
    dtlsf: int = 18
    dn: int = 7
    wnlsf: int = 1929 % 256


def ionospheric_delay(
    ionoutc: IonoUtc, gsec, llh: np.ndarray, azel: np.ndarray
) -> np.ndarray:
    """Iono delay in meters (reference gps.c:1893-1964).

    gsec: second-of-week (broadcastable). llh: (..., 3) user position.
    azel: (..., 2) az/el radians. Returns delay broadcast over inputs.
    """
    az = np.asarray(azel)[..., 0]
    el = np.asarray(azel)[..., 1]
    gsec = np.asarray(gsec, dtype=np.float64)

    if not ionoutc.enable:
        return np.zeros(np.broadcast(az, gsec).shape, dtype=np.float64)

    E = el / PI
    phi_u = np.asarray(llh)[..., 0] / PI
    lam_u = np.asarray(llh)[..., 1] / PI

    # Obliquity factor; pow() via libm for 1-ulp parity with the C oracle.
    F = 1.0 + 16.0 * libm_pow(0.53 - E, 3.0).astype(np.float64)

    fallback = F * 5.0e-9 * SPEED_OF_LIGHT
    if not ionoutc.vflg:
        return np.broadcast_to(fallback, np.broadcast(fallback, gsec).shape).copy()

    psi = 0.0137 / (E + 0.11) - 0.022

    phi_i = phi_u + psi * np.cos(az)
    phi_i = np.clip(phi_i, -0.416, 0.416)

    lam_i = lam_u + psi * np.sin(az) / np.cos(phi_i * PI)

    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * PI)
    phi_m2 = phi_m * phi_m
    phi_m3 = phi_m2 * phi_m

    AMP = (
        ionoutc.alpha0
        + ionoutc.alpha1 * phi_m
        + ionoutc.alpha2 * phi_m2
        + ionoutc.alpha3 * phi_m3
    )
    AMP = np.maximum(AMP, 0.0)

    PER = (
        ionoutc.beta0
        + ionoutc.beta1 * phi_m
        + ionoutc.beta2 * phi_m2
        + ionoutc.beta3 * phi_m3
    )
    PER = np.maximum(PER, 72000.0)

    # Local time of day (the C while-loops reduce into [0, 86400)).
    t = SECONDS_IN_DAY / 2.0 * lam_i + gsec
    t = t - SECONDS_IN_DAY * np.floor(t / SECONDS_IN_DAY)

    X = 2.0 * PI * (t - 50400.0) / PER
    X2 = X * X
    X4 = X2 * X2

    poly = F * (5.0e-9 + AMP * (1.0 - X2 / 2.0 + X4 / 24.0)) * SPEED_OF_LIGHT
    return np.where(np.abs(X) < 1.57, poly, fallback)
