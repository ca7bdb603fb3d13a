"""Float64 NumPy block synthesizer — the parity path.

Replicates the reference hot loop (gps.c:2767-2836) sample-for-sample,
including the double→int truncation of data*chip*LUT*gain (gps.c:2781-2782),
the ``(int)floor(carr_phase*512)`` LUT indexing, int16 wraparound stores and
the ``>> 4`` arithmetic shift for 8-bit output (gps.c:2841-2845).

The sequential per-sample phase accumulation is replaced by the closed form
described in ops/plan.py; the difference is below 1e-10 chips over a block,
orders of magnitude under a LUT/chip quantization boundary.
"""

from __future__ import annotations

import numpy as np

from ..core.constants import CA_SEQ_LEN, COS_TABLE_512, SIN_TABLE_512
from .plan import BlockPlan


def chips_and_bits(plan: BlockPlan, c: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample (±1 C/A chip, ±1 data bit) of channel ``c`` — the
    closed-form code trajectory shared by the synthesizer and the stream
    verifier (qa.py), so the two can never drift apart."""
    n = np.arange(plan.num_samples, dtype=np.float64)
    raw = plan.code_phase[c] + n * (plan.f_code[c] * plan.delt)
    wraps = np.floor(raw / CA_SEQ_LEN).astype(np.int64)
    chip = (raw - wraps.astype(np.float64) * CA_SEQ_LEN).astype(np.int64)
    # guard the pathological raw==k*1023 float edge
    chip = np.clip(chip, 0, CA_SEQ_LEN - 1)
    code_ca = plan.ca[c, chip].astype(np.int64) * 2 - 1

    total = (
        plan.iword[c] * 600 + plan.ibit[c] * 20 + plan.icode[c] + wraps
    )
    bitpos = total // 20  # data-bit index since dwrd[0] bit 0
    iw = bitpos // 30
    ib = bitpos - iw * 30
    words = plan.dwrd[c].astype(np.int64)
    data_bit = ((words[iw] >> (29 - ib)) & 0x1) * 2 - 1
    return code_ca, data_bit


def carrier_fraction(plan: BlockPlan, c: int, int_nco: bool) -> np.ndarray:
    """Per-sample carrier phase fraction (cycles in [0,1)) of channel
    ``c`` — shared by the synthesizer's LUT indexing and qa.py."""
    if int_nco:
        ph = (
            plan.carr_phase_i[c].astype(np.uint64)
            + np.arange(plan.num_samples, dtype=np.uint64)
            * np.int64(plan.carr_step_i[c]).astype(np.uint64)
        ) & np.uint64(0xFFFFFFFF)
        # 9.16 NCO: one cycle = 2^25 counts.
        return (ph & np.uint64(0x1FFFFFF)).astype(np.float64) / 2.0**25
    n = np.arange(plan.num_samples, dtype=np.float64)
    carr = plan.carr_phase[c] + n * (plan.f_carr[c] * plan.delt)
    return carr - np.floor(carr)


def synth_block_numpy(plan: BlockPlan, int_nco: bool = False) -> np.ndarray:
    """Synthesize one block → interleaved int16[2 * num_samples] (I, Q)."""
    i_acc = np.zeros(plan.num_samples, dtype=np.int64)
    q_acc = np.zeros(plan.num_samples, dtype=np.int64)

    for c in range(plan.num_channels):
        if not plan.active[c]:
            continue

        code_ca, data_bit = chips_and_bits(plan, c)

        # --- carrier LUT index ------------------------------------------
        # floor(frac*512) reproduces the reference indexing exactly in
        # both modes: int-NCO fractions are 25-bit dyadics, so the
        # multiply is exact and equals (ph >> 16) & 511.
        frac = carrier_fraction(plan, c, int_nco)
        itable = np.floor(frac * 512.0).astype(np.int64)
        itable = np.clip(itable, 0, 511)

        # --- mix, truncate, accumulate (C int truncation semantics) -----
        s = (data_bit * code_ca).astype(np.float64)
        g = plan.gain[c]
        i_acc += np.trunc(s * COS_TABLE_512[itable] * g).astype(np.int64)
        q_acc += np.trunc(s * SIN_TABLE_512[itable] * g).astype(np.int64)

    out = np.empty(2 * plan.num_samples, dtype=np.int16)
    out[0::2] = i_acc.astype(np.int16)  # (short) cast wraps mod 2^16
    out[1::2] = q_acc.astype(np.int16)
    return out


def quantize_iq(iq16: np.ndarray, bits: int) -> np.ndarray:
    """16-bit passthrough or 8-bit ``>> 4`` arithmetic shift (gps.c:2841-2845)."""
    if bits == 16:
        return iq16
    return (iq16 >> 4).astype(np.int8)
