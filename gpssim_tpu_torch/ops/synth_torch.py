"""Plain PyTorch version of the fused synthesis kernel (K1) and its finalize.

The int32 counterpart of the JAX package's XLA synthesizer: the same
fixed-point program, written as tensor operations, that the hand-written
CUDA kernel (ops/synth_cuda.py, csrc/synth_k1.cu) computes sample by
sample. The CPU tests compare it with the JAX package byte for byte;
on the card it is the reference the CUDA kernel is held against.

* Stage A (``row_bases``, per row and channel): the row-start code phase
  (Q46) and carrier phase (Q53) from base-2^23 limbs with the row index
  split into digits < 64, so every product fits int32; the row's
  pre-shifted C/A chip window with the data-bit sign folded in.
* Stage B (per sample, a loop over channels): chip sign from the window,
  carrier LUT magnitude from a quadrant-folded polynomial
  (``lut_mag_neg``), exact truncation of gain × LUT in split Q44
  (``gain_trunc_mag``), int32 sum over channels.
* ``finalize_iq``: interleave, cast to int16, and ``>> 4`` to int8 for
  8-bit output.

The (B, R, 128) accumulators are updated channel by channel; a
(B, R, C, 128) intermediate would be several hundred MB for a 25-block
window.

torch's ``>>`` on int32 is arithmetic. Where the JAX program shifts right
logically to build window words, the words are handled as int64 holding
the uint32 bit pattern. Bit extraction ``(x >> k) & 1`` is the same for
either kind of shift and stays int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import CA_SEQ_LEN, COS_TABLE_512, SIN_TABLE_512
from .args import _M23, _Q_CARR, LANES

_U32 = 0xFFFFFFFF

# Discrete-minimax fits of the carrier-table magnitudes at the 128 folded
# LUT indices: degree-5 odd (sin) / degree-6 even (cos). Each lands within
# 0.489 of its integer target, with >= 0.011 margin to the 0.5 rounding
# boundary — ~19x any f32 Horner's evaluation error. Exhaustively held
# against both 512-entry tables by tests/test_torch_synth.py.
_LUT_POLY_SIN = (785.0718994140625, -1283.7464599609375, 575.4459838867188)
_LUT_POLY_COS = (
    249.99581909179688, -1233.1646728515625, 1003.1950073242188,
    -279.9259033203125,
)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern → the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 → int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & _U32


def row_bases(code_l, carr_l, nav, ca_packed, n_rows: int,
              wide: bool = False) -> dict:
    """Stage A: per-(block, row, channel) int32 bases, each (B, R, C).

    ``code_l``/``carr_l`` are int32 (B, 4, C, 3), ``nav`` (B, 3, C),
    ``ca_packed`` int32 (B, C, 36) in the uint32 bit pattern. Returns
    f_hi, f_lo (code phase), c_hi, c_lo (carrier phase) and the sign-folded
    window words sA, sB (and sC, sD for the 128-chip wide window).
    """
    dev = code_l.device
    q = torch.arange(n_rows, dtype=torch.int32, device=dev).view(1, -1, 1)
    digits = (q & 63, (q >> 6) & 63, q >> 12)  # row = q2*4096 + q1*64 + q0

    def poly(L):
        """base + q0*s1 + q1*s64 + q2*s4096 in base-2^23 limbs → p0, p1, p2."""

        def term(i):
            t = L[:, 0, None, :, i]
            for d, dig in enumerate(digits, start=1):
                t = t + dig * L[:, d, None, :, i]
            return t

        p0 = term(0)
        p1 = term(1) + (p0 >> 23)
        p0 = p0 & _M23
        p2 = term(2) + (p1 >> 23)
        p1 = p1 & _M23
        return p0, p1, p2

    # ---- code phase: P = code0 + q*step128 (exact, Q46) ----
    f_lo, f_hi, chips_total = poly(code_l)
    wraps = torch.div(chips_total, CA_SEQ_LEN, rounding_mode="floor")
    chip_base = chips_total - wraps * CA_SEQ_LEN  # 0..1022

    # ---- carrier phase: M = (carr0 + q*kstep128) mod 2^53 ----
    c_lo, c_p1, c_p2 = poly(carr_l)
    c_hi = ((c_p2 & ((1 << (_Q_CARR - 46)) - 1)) << 23) + c_p1

    # ---- data bits: shift into the host-packed 8-bit window ----
    tcu = nav[:, 0, None, :] + wraps
    bidx0 = nav[:, 1, None, :]
    bits = nav[:, 2, None, :]

    def bit_neg(t):
        """1 where the data bit is -1 (bit value 0) at code period t."""
        j = torch.div(t, 20, rounding_mode="floor") - bidx0  # 0..7
        return ((bits >> (j & 31)) & 1) ^ 1

    neg_now = _u32(bit_neg(tcu))
    neg_next = _u32(bit_neg(tcu + 1))

    # ---- C/A chip window [chip_base, chip_base + 32*n_win) pre-shifted ----
    n_win = 4 if wide else 2
    wordpos = (chip_base >> 5).to(torch.int64)
    bitoff = (chip_base & 31).to(torch.int64)
    B, R, C = chip_base.shape
    cap = _u32(ca_packed)[:, None].expand(B, R, C, ca_packed.shape[-1])
    w = [
        torch.gather(cap, 3, (wordpos + k)[..., None])[..., 0]
        for k in range(n_win + 1)
    ]

    # ---- fold the data-bit sign into the window ----
    # Window bit j becomes chipbit ^ dbit_neg(chip_base + j): the data bit
    # flips exactly at the code wrap, window offset 1023 - chip_base.
    wrap_off = (CA_SEQ_LEN - chip_base).to(torch.int64)  # 1..1023
    xor_now = neg_now * _U32
    xor_flip = (neg_now ^ neg_next) * _U32
    out = dict(f_hi=f_hi, f_lo=f_lo, c_hi=c_hi, c_lo=c_lo)
    for k in range(n_win):
        win = (w[k] >> bitoff) | ((w[k + 1] << (32 - bitoff)) & _U32)
        # all ones where the offset lies past the wrap (x << k, k >= 32 → 0)
        ones = torch.full_like(wrap_off, _U32)
        mask = (ones << (wrap_off - 32 * k).clamp(0, 32)) & _U32
        out["s" + "ABCD"[k]] = _as_i32(win ^ xor_now ^ (mask & xor_flip))
    return out


def select_chip_word(chip_off, words):
    """The pre-shifted 32-chip window word holding ``chip_off``: [sA, sB]
    (64-chip window) or [sA..sD] (128-chip wide window)."""
    if len(words) == 4:
        return torch.where(
            chip_off < 64,
            torch.where(chip_off < 32, words[0], words[1]),
            torch.where(chip_off < 96, words[2], words[3]),
        )
    return torch.where(chip_off < 32, words[0], words[1])


def lut_mag_neg(idx):
    """(|sin_t[idx]|, sin<0, |cos_t[idx]|, cos<0) for int32 ``idx`` in
    0..511 — the carrier tables by polynomial, no gathers.

    |table[idx]| = M(m) with m = u or 127-u per quadrant, where
    M(m) = round(250*sin(pi*(m+0.5)/256)) except the tables' half-way
    quirk entries (105 where rounding gives 106), which fold onto m == 35
    (sin) and m == 92 (cos)."""
    u = idx & 127
    quad = idx >> 7  # 0..3
    m = torch.where((quad & 1) == 1, 127 - u, u)

    x = m.to(torch.float32) * (1.0 / 256.0) + (0.5 / 256.0)
    x2 = x * x
    p = torch.full_like(x, _LUT_POLY_SIN[-1])
    for c in _LUT_POLY_SIN[-2::-1]:
        p = c + x2 * p
    q = torch.full_like(x, _LUT_POLY_COS[-1])
    for c in _LUT_POLY_COS[-2::-1]:
        q = c + x2 * q
    ts = torch.round(x * p).to(torch.int32)  # half to even, as rint
    tc = torch.round(q).to(torch.int32)
    ts = torch.where(m == 35, 105, ts)
    tc = torch.where(m == 92, 105, tc)

    neg_s = quad >= 2
    neg_c = (quad == 1) | (quad == 2)  # cos quadrant = quad + 1 (mod 4)
    return ts, neg_s, tc, neg_c


def gain_trunc_mag(ta, ga, gb):
    """Exact trunc(gain * ta), ta >= 0, gain in split Q44 (ga hi / gb lo):
    equal to (g44 * ta) >> 44 in int64, in int32 arithmetic."""
    return (ga * ta + ((gb * ta) >> 22)) >> 22


def finalize_iq(i_acc, q_acc, num_samples: int, out_bits: int = 16):
    """Interleave and cast to int16 (C wraparound), or to int8 by the
    reference's arithmetic ``>> 4`` of the int16 value (gps.c:2841-2845)."""
    iq = torch.stack([i_acc, q_acc], dim=-1).reshape(*i_acc.shape[:-1], -1)
    iq16 = iq[..., : 2 * num_samples].to(torch.int16)
    if out_bits == 8:
        return (iq16 >> 4).to(torch.int8)
    return iq16


def synth_blocks_batch_torch(args: dict, *, n_rows: int, num_samples: int,
                             out_bits: int = 16, wide: bool = False):
    """Batch of B blocks → int16[B, 2*num_samples] (int8 for 8 bits).

    ``args`` holds the int32 kernel arguments with a leading block axis
    (ops/args.py: plan_to_args, unpack_args, to_device)."""
    bases = row_bases(
        args["code_l"], args["carr_l"], args["nav"], args["ca_packed"],
        n_rows, wide=wide,
    )
    ls = args["lane_steps"]
    B, R, C = bases["f_hi"].shape
    r = torch.arange(LANES, dtype=torch.int32, device=ls.device).view(1, 1, -1)
    words = ["s" + "ABCD"[k] for k in range(4 if wide else 2)]
    i_acc = torch.zeros((B, R, LANES), dtype=torch.int32, device=ls.device)
    q_acc = torch.zeros_like(i_acc)

    def blk(x):  # (B,) per-block scalar → (B, 1, 1)
        return x.view(B, 1, 1)

    for c in range(C):
        def rc(name):  # (B, R) base column → (B, R, 1)
            return bases[name][:, :, c:c + 1]

        # ---- code: chips advanced within the row; the sign-folded
        # window bit IS the full dataBit*codeCA sign ----
        lo = rc("f_lo") + r * blk(ls[:, 1, c])
        H = rc("f_hi") + r * blk(ls[:, 0, c]) + (lo >> 23)
        chip_off = H >> 23  # 0..44 (narrow window) / 0..127 (wide)
        word = select_chip_word(chip_off, [rc(n) for n in words])
        spos = (word >> (chip_off & 31)) & 1  # 1 where product is POSITIVE

        # ---- carrier LUT index ----
        klo = rc("c_lo") + r * blk(ls[:, 3, c])
        kH = rc("c_hi") + r * blk(ls[:, 2, c]) + (klo >> 23)
        idx = (kH >> 21) & 511

        # ---- LUT magnitudes, exact gain fold, signs by select ----
        ta_s, neg_s, ta_c, neg_c = lut_mag_neg(idx)
        ga = blk(args["gain_a"][:, c])
        gb = blk(args["gain_b"][:, c])
        mag_i = gain_trunc_mag(ta_c, ga, gb)
        mag_q = gain_trunc_mag(ta_s, ga, gb)
        i_acc += torch.where((spos == 0) ^ neg_c, -mag_i, mag_i)
        q_acc += torch.where((spos == 0) ^ neg_s, -mag_q, mag_q)

    return finalize_iq(
        i_acc.view(B, -1), q_acc.view(B, -1), num_samples, out_bits
    )


def lut_tables() -> np.ndarray:
    """int16[1024]: SIN_TABLE_512 then COS_TABLE_512 (the CUDA kernel's
    shared-memory tables)."""
    return np.concatenate([SIN_TABLE_512, COS_TABLE_512]).astype(np.int16)
