"""C/A Gold-code generation.

TPU-first design: all 32 PRN chip sequences are generated once on the host
and live as a constant ``int8[32, 1023]`` table (values in {0, 1}); the synth
kernels consume them as bit-packed ``uint32`` words so the per-sample chip
lookup is a shift/mask, never a big gather.

Reference behavior: two 10-stage LFSRs, G1 taps (3,10), G2 taps
(2,3,6,8,9,10), per-PRN G2 delay, chip = (1 - g1*g2)/2 with registers seeded
to -1 (gps.c:272-309).
"""

from __future__ import annotations

import functools

import numpy as np

from .constants import CA_SEQ_LEN, MAX_SAT

# G2 delay (chips) per PRN 1..32 — IS-GPS-200 table 3-I (reference gps.c:273-278).
G2_DELAY = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
)


def _lfsr_sequences() -> tuple[np.ndarray, np.ndarray]:
    """Run both LFSRs for one code period; chips in {-1, +1} convention."""
    r1 = [-1] * 10
    r2 = [-1] * 10
    g1 = np.empty(CA_SEQ_LEN, dtype=np.int64)
    g2 = np.empty(CA_SEQ_LEN, dtype=np.int64)
    for i in range(CA_SEQ_LEN):
        g1[i] = r1[9]
        g2[i] = r2[9]
        c1 = r1[2] * r1[9]
        c2 = r2[1] * r2[2] * r2[5] * r2[7] * r2[8] * r2[9]
        r1 = [c1] + r1[:9]
        r2 = [c2] + r2[:9]
    return g1, g2


@functools.cache
def ca_table() -> np.ndarray:
    """All PRN chip sequences: int8[32, 1023] with values in {0, 1}.

    ca[prn-1, i] = (1 - g1[i]*g2[(i + 1023 - delay) % 1023]) / 2.
    """
    g1, g2 = _lfsr_sequences()
    out = np.empty((MAX_SAT, CA_SEQ_LEN), dtype=np.int8)
    for prn in range(1, MAX_SAT + 1):
        shift = CA_SEQ_LEN - G2_DELAY[prn - 1]
        g2d = np.roll(g2, -shift)
        out[prn - 1] = (1 - g1 * g2d) // 2
    return out


CA_PACKED_WORDS = 36


@functools.cache
def ca_table_packed() -> np.ndarray:
    """Bit-packed chips with wraparound tail: uint32[32, 36].

    Word w bit b (LSB-first) holds chip (32*w + b) of the periodically
    extended sequence, covering chips 0..1151 so that any 0..128-bit
    window starting at chip < 1023 is contiguous (used by the lane
    kernels — the wide low-sample-rate window reads words j..j+4)."""
    ca = ca_table()
    n = CA_PACKED_WORDS
    ext = np.concatenate([ca, ca[:, : n * 32 - CA_SEQ_LEN]], axis=1)
    bits = ext.reshape(MAX_SAT, n, 32).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :]
    return (bits * weights).sum(axis=2, dtype=np.uint32)


def first_chips_octal(prn: int, n: int = 10) -> int:
    """First n chips as an octal integer (standard published check values)."""
    chips = ca_table()[prn - 1, :n]
    return int("".join(str(int(c)) for c in chips), 2)
