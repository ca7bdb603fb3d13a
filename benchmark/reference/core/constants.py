"""Physical and GPS-system constants for the TPU-native GPS L1 C/A synthesizer.

These mirror the reference simulator's compile-time constants so that a
"parity mode" run reproduces its output bit-for-bit (reference:
gps.h:58-108, sdr.h:18-29), while everything
that was a compile-time #define there is a runtime config parameter here.
"""

from __future__ import annotations

import math

import numpy as np

# --- Signal plan (reference sdr.h:18-29) ---------------------------------
TX_FREQUENCY = 1_575_420_000  # L1 carrier [Hz]
DEFAULT_TX_SAMPLERATE = 3_000_000  # reference is hard-wired to 3.0 Msps (sdr.h:21)
EPOCH_SECONDS = 0.1  # position/range update cadence (gps.c:2298,2692,2744)
NUM_FIFO_BUFFERS = 8  # host pipeline depth (sdr.h:24)
HACKRF_TRANSFER_BUFFER_SIZE = 262_144  # sdr.h:34

# --- Constellation / channel plan (reference gps.h:33-58) -----------------
MAX_SAT = 32
MAX_CHAN = 12
CA_SEQ_LEN = 1023
N_SBF = 5  # subframes per frame
N_DWRD_SBF = 10  # words per subframe
N_DWRD = (N_SBF + 1) * N_DWRD_SBF  # 60-word rolling buffer (gps.h:52)
N_SBF_PAGE = 3 + 2 * 25  # subframes 1-3 + 25 pages of subframes 4&5
MAX_PAGE = 25
EPHEM_ARRAY_SIZE = 13  # ephemeris sets per daily brdc file (gps.h:108)
USER_MOTION_SIZE = 864_000  # 24 h at 10 Hz (gps.h:42)

# --- Time (reference gps.h:60-64) -----------------------------------------
SECONDS_IN_WEEK = 604800.0
SECONDS_IN_HALF_WEEK = 302400.0
SECONDS_IN_DAY = 86400.0
SECONDS_IN_HOUR = 3600.0
SECONDS_IN_MINUTE = 60.0

# --- WGS84 / ICD-GPS-200 (reference gps.h:86-106) --------------------------
GM_EARTH = 3.986005e14
OMEGA_EARTH = 7.2921151467e-5
PI = 3.1415926535898  # the reference's truncated pi (gps.h:91); used in navmsg scaling
WGS84_RADIUS = 6378137.0
WGS84_ECCENTRICITY = 0.0818191908426
R2D = 57.2957795131
SPEED_OF_LIGHT = 2.99792458e8
LAMBDA_L1 = 0.190293672798365
CODE_FREQ = 1.023e6
CARR_TO_CODE = 1.0 / 1540.0

# --- Power-of-two scale factors for nav-message packing (gps.h:66-84) ------
POW2_M5 = 0.03125
POW2_M19 = 1.907348632812500e-6
POW2_M29 = 1.862645149230957e-9
POW2_M31 = 4.656612873077393e-10
POW2_M33 = 1.164153218269348e-10
POW2_M43 = 1.136868377216160e-13
POW2_M55 = 2.775557561562891e-17
POW2_M50 = 8.881784197001252e-016
POW2_M30 = 9.313225746154785e-010
POW2_M27 = 7.450580596923828e-009
POW2_M24 = 5.960464477539063e-008
POW2_M21 = 4.76837158203125e-007
POW2_12 = 4096
POW2_M38 = 3.63797880709171e-012
POW2_M11 = 0.00048828125
POW2_M23 = 1.19209289550781e-007
POW2_M20 = 9.5367431640625e-007

# --- Nav message parity (gps.h:123-134) ------------------------------------
EMPTY_WORD = 0xAAAAAAAA
PARITY_MASKS = (
    0x3B1F3480,
    0x1D8F9A40,
    0x2EC7CD00,
    0x1763E680,
    0x2BB1F340,
    0x0B7A89C0,
)  # D25..D30 bit-vectors over <D29*,D30*,d1..d24> (gps.c:1033-1036)

# Page-number → SV-ID tables for subframes 4 & 5 (IS-GPS-200 table 20-V;
# reference gps.c:224-234).
SBF4_SVID = (
    57, 0, 0, 0, 0, 57, 0, 0, 0, 0,
    57, 62, 52, 53, 54, 57, 55, 56, 58,
    59, 57, 60, 61, 62, 63,
)
SBF5_SVID = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 51,
)

# --- Receiver antenna pattern ----------------------------------------------
# Attenuation in dB for boresight angle 0:5:180 deg (reference gps.c:216-221,
# inherited from gps-sdr-sim).
ANT_PAT_DB = (
    0.00, 0.00, 0.22, 0.44, 0.67, 1.11, 1.56, 2.00, 2.44, 2.89, 3.56, 4.22,
    4.89, 5.56, 6.22, 6.89, 7.56, 8.22, 8.89, 9.78, 10.67, 11.56, 12.44,
    13.33, 14.44, 15.56, 16.67, 17.78, 18.89, 20.00, 21.33, 22.67, 24.00,
    25.56, 27.33, 29.33, 31.56,
)

# Path-loss numerator: gain = 20 200 000 / distance (gps.c:2749).
PATH_LOSS_NUMERATOR = 20_200_000.0

# --- Carrier LUTs -----------------------------------------------------------
# The reference uses 512-entry integer sine/cosine tables with amplitude 250
# (gps.c:145-213).  They equal round-half-away-from-zero of
# 250*sin(2*pi*(k+0.5)/512) except at four half-way entries (value exactly
# 105.50007 in f64) where the original generator produced 105; we encode that
# quirk explicitly so parity mode matches sample-for-sample.
_SIN_HALFWAY_QUIRKS = {35: 105, 220: 105, 291: -105, 476: -105}


def c_round(x: float) -> int:
    """C99 round(): half away from zero (parity-critical; single copy)."""
    return int(math.floor(x + 0.5)) if x >= 0.0 else int(math.ceil(x - 0.5))


_c_round = c_round


def make_carrier_tables() -> tuple[np.ndarray, np.ndarray]:
    """Build (sin512, cos512) int32 tables identical to the reference's."""
    sin_t = np.empty(512, dtype=np.int32)
    for k in range(512):
        sin_t[k] = _c_round(250.0 * math.sin(2.0 * math.pi * (k + 0.5) / 512.0))
    for k, v in _SIN_HALFWAY_QUIRKS.items():
        sin_t[k] = v
    cos_t = np.roll(sin_t, -128)  # cos(x) = sin(x + pi/2), 128 = 512/4
    return sin_t, cos_t


SIN_TABLE_512, COS_TABLE_512 = make_carrier_tables()
