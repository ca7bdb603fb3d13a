"""Block plans: the per-0.1 s-epoch inputs of the synthesis kernels.

The reference carries per-channel NCO state through a sequential sample loop
(gps.c:2767-2836). Here every per-sample quantity is a closed-form function
of the block-start state because the phase recurrences are affine with
per-block-constant rates:

    code:    raw(n)  = cp0 + n*f_code*delt
             chip(n) = floor(raw(n) mod 1023)
             wraps(n)= floor(raw(n) / 1023)          (cp0 in [0,1023))
             bit(n)  = dwrd bit at (iword0*600 + ibit0*20 + icode0 + wraps(n)) / 20
    carrier: idx(n)  = floor(frac(carr0 + n*f_carr*delt) * 512)

so blocks are embarrassingly parallel over samples AND channels AND blocks;
the only cross-block state is carr0 (an O(1) update) — see parallel/blocks.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BlockPlan:
    """Inputs for synthesizing one block of ``num_samples`` IQ samples.

    All per-channel arrays have length C (the channel count); inactive
    channels have active=False and contribute nothing (gain 0 semantics).
    """

    num_samples: int
    delt: float  # 1 / sample_rate
    active: np.ndarray  # bool[C]
    code_phase: np.ndarray  # f64[C] chips in [0, 1023)
    f_code: np.ndarray  # f64[C] Hz
    carr_phase: np.ndarray  # f64[C] cycles in [0, 1)
    f_carr: np.ndarray  # f64[C] Hz
    carr_phase_i: np.ndarray  # uint32[C] 9.16 NCO phase (int-NCO mode)
    carr_step_i: np.ndarray  # int32[C] 9.16 NCO step (int-NCO mode)
    gain: np.ndarray  # f64[C]
    iword: np.ndarray  # i64[C]
    ibit: np.ndarray  # i64[C]
    icode: np.ndarray  # i64[C]
    prn: np.ndarray  # i64[C] PRN per slot (0 = inactive)
    ca: np.ndarray  # int8[C, 1023] chips {0,1}
    dwrd: np.ndarray  # uint32[C, 60]

    @property
    def num_channels(self) -> int:
        return len(self.active)

    def end_carr_phase(self) -> np.ndarray:
        """Block-end carrier phase (the only state carried across blocks)."""
        c = self.carr_phase + self.num_samples * (self.f_carr * self.delt)
        out = c - np.floor(c)
        return np.where(self.active, out, self.carr_phase)

    def end_carr_phase_i(self) -> np.ndarray:
        """Block-end integer-NCO phase (exact, mod 2^32)."""
        adv = (
            self.carr_phase_i.astype(np.uint64)
            + np.uint64(self.num_samples)
            * self.carr_step_i.astype(np.int64).astype(np.uint64)
        ) & np.uint64(0xFFFFFFFF)
        return np.where(self.active, adv.astype(np.uint32), self.carr_phase_i)
