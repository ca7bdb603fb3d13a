"""The bytes of each block: as the reference C writes them
(:func:`synth_bytes`), or as the port's closed form defines them
(:func:`fixed_point_bytes`).

The reference C's bytes, in plain PyTorch float64 on whatever device it
is given: for every sample
of every channel it evaluates the closed form of the phase recurrences
(``phase0 + n*step``, the port's plain-NumPy order of operations), and
flags the samples whose closed-form phase lies within a proven error
bound of a chip, wrap or carrier-table boundary: only there can the
reference C's sequential float64 accumulation pick another index. Each
flagged sample is evaluated again by replaying the sequential
recurrences (``seqwalk``) and its contribution replaced. Then the sum
wraps to int16 and shifts to the 8-bit sample (gps.c:2841-2845).

Error bound of a sample n (|sequential - closed form|):
  code, chips: each of the n sequential additions rounds by at most half
  an ulp of a value below 1024 (2**-44); the closed form rounds twice,
  at most an ulp of its magnitude m in all: n * 2**-44 + ulp(m).
  carrier, cycles: each sequential step rounds by at most 2**-53 (half
  an ulp below 1, or of the sum in [1, 2) at a wrap, or the two
  roundings of a downward wrap); the closed form at most ulp(m):
  n * 2**-53 + ulp(m), times 512 in table-index units.
The flags use twice these bounds.

The port's closed form (``--no-parity-exact``, PARITY.md "Why this is
fast") puts each block's phases in fixed point, rounded to nearest from
the float64 plan, 2**-46 chip for the code and 2**-53 cycle for the
carrier, and steps them as exact integers: chip index and code periods
from ``rint(cp0*2**46) + n*rint(f_code*delt*2**46)``, table index from
the top 9 of 53 bits of ``rint(c0*2**53) + n*rint(f_carr*delt*2**53)``;
the mixing is the reference C's float64 truncation. That semantics has
no rounding left to replay: :func:`fixed_point_bytes` computes it in
int64.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .core.constants import COS_TABLE_512, SIN_TABLE_512
from .seqwalk import code_walk, carrier_walk

COS = np.ascontiguousarray(COS_TABLE_512, dtype=np.float64)
SIN = np.ascontiguousarray(SIN_TABLE_512, dtype=np.float64)


def _stack(plans, name, dtype):
    return np.ascontiguousarray(np.stack([getattr(p, name) for p in plans]),
                                dtype=dtype)


def _ulp_bound(mag: np.ndarray) -> np.ndarray:
    """ulp(mag) for magnitudes >= 1 (an upper bound below 1)."""
    return np.exp2(np.floor(np.log2(np.maximum(mag, 1.0))) - 52.0)


def _mix(data, chip_bit, it, gain):
    """trunc(dataBit * codeCA * LUT * gain) for I and Q (gps.c:2781-2782)."""
    s = (data * (chip_bit * 2 - 1)).astype(np.float64)
    return (np.trunc(s * COS[it] * gain).astype(np.int64),
            np.trunc(s * SIN[it] * gain).astype(np.int64))


def _closed_form_at(p, c, n, c0):
    """The closed-form indices and contribution of channel c at samples n."""
    nf = n.astype(np.float64)
    raw = p.code_phase[c] + nf * (p.f_code[c] * p.delt)
    wraps = np.floor(raw / 1023.0)
    chip = np.clip((raw - wraps * 1023.0).astype(np.int64), 0, 1022)
    carr = c0 + nf * (p.f_carr[c] * p.delt)
    frac = carr - np.floor(carr)
    it = np.clip(np.floor(frac * 512.0).astype(np.int64), 0, 511)
    return _mix(_data_bits(p, c, wraps.astype(np.int64)),
                p.ca[c, chip].astype(np.int64), it, p.gain[c])


def _data_bits(p, c, wraps):
    total = p.iword[c] * 600 + p.ibit[c] * 20 + p.icode[c] + wraps
    bitpos = total // 20
    iw = bitpos // 30
    ib = bitpos - iw * 30
    words = p.dwrd[c].astype(np.int64)
    return ((words[iw] >> (29 - ib)) & 1) * 2 - 1


def _sequential_at(p, c, n, c0):
    """The reference C's contribution of channel c at samples n: the
    sequential recurrences replayed from the block start."""
    last = int(n.max())
    cp, wraps = code_walk(p.code_phase[c], p.f_code[c] * p.delt, last)
    ph = carrier_walk(c0, p.f_carr[c] * p.delt, last)
    chip = cp[n].astype(np.int64)
    it = np.minimum((ph[n] * 512.0).astype(np.int64), 511)
    return _mix(_data_bits(p, c, wraps[n].astype(np.int64)),
                p.ca[c, chip].astype(np.int64), it, p.gain[c])


def _finalize(i_acc, q_acc, dev):
    """Wrap the sums to int16 and shift to the interleaved 8-bit samples
    (gps.c:2841-2845)."""
    B, N = i_acc.shape
    out = torch.empty((B, 2 * N), dtype=torch.int8, device=dev)
    for k, acc in enumerate((i_acc, q_acc)):
        i16 = torch.remainder(acc + 32768, 65536) - 32768
        out[:, k::2] = torch.div(i16, 16, rounding_mode="floor").to(
            torch.int8)
    return out


def _channel_tables(plans, c, t):
    ca = t(np.stack([p.ca[c] for p in plans]).astype(np.int64), torch.int64)
    dw = t(np.stack([p.dwrd[c] for p in plans]).astype(np.int64),
           torch.int64)
    return ca, dw


def _data_and_code(ca, dw, base_c, chip, wraps):
    """±1 C/A chip and ±1 data bit from a chip index and the code periods
    since the block start."""
    code = torch.gather(ca, 1, chip) * 2 - 1
    total = base_c[:, None] + wraps
    bitpos = torch.div(total, 20, rounding_mode="floor")
    iw = torch.div(bitpos, 30, rounding_mode="floor")
    ib = bitpos - iw * 30
    word = torch.gather(dw, 1, iw.clamp(0, 59))
    data = torch.bitwise_and(torch.bitwise_right_shift(word, 29 - ib),
                             1) * 2 - 1
    return data * code


def fixed_point_bytes(plans, starts: np.ndarray, device: str,
                      dtype=torch.int64):
    """int8[B, 2N] (a tensor on ``device``) of ``plans`` in the port's closed form, the block-start
    carrier phases ``starts`` (f64[B, C]). With ``dtype=torch.float32``
    the same closed form is evaluated in float32 instead: the control, a
    precision below the configuration's."""
    dev = torch.device(device)
    B = len(plans)
    N = plans[0].num_samples
    delt = plans[0].delt
    active = _stack(plans, "active", bool)
    step = _stack(plans, "f_code", np.float64) * delt
    kstep = _stack(plans, "f_carr", np.float64) * delt
    cp0 = _stack(plans, "code_phase", np.float64)
    c0 = np.ascontiguousarray(starts, dtype=np.float64)
    base = (_stack(plans, "iword", np.int64) * 600
            + _stack(plans, "ibit", np.int64) * 20
            + _stack(plans, "icode", np.int64))
    gain = _stack(plans, "gain", np.float64)

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dt)

    i64 = torch.int64
    n = torch.arange(N, dtype=i64, device=dev)[None, :]
    cos_t, sin_t = t(COS), t(SIN)
    i_acc = torch.zeros((B, N), dtype=i64, device=dev)
    q_acc = torch.zeros((B, N), dtype=i64, device=dev)
    mask53 = (1 << 53) - 1
    for c in range(active.shape[1]):
        on = active[:, c]
        if not on.any():
            continue
        ca, dw = _channel_tables(plans, c, t)
        if dtype == torch.int64:
            q = (t(np.rint(cp0[:, c] * 2.0**46), i64)[:, None]
                 + n * t(np.rint(step[:, c] * 2.0**46), i64)[:, None])
            chips = torch.bitwise_right_shift(q, 46)
            ph = torch.bitwise_and(
                t(np.rint(c0[:, c] * 2.0**53), i64)[:, None]
                + n * t(np.rint(kstep[:, c] * 2.0**53), i64)[:, None],
                mask53)
            idx = torch.bitwise_right_shift(ph, 44)
        else:
            nf = n.to(dtype)
            raw = t(cp0[:, c], dtype)[:, None] + nf * t(step[:, c],
                                                        dtype)[:, None]
            chips = torch.floor(raw).to(i64).clamp(min=0)
            carr = t(c0[:, c], dtype)[:, None] + nf * t(kstep[:, c],
                                                        dtype)[:, None]
            frac = carr - torch.floor(carr)
            idx = torch.floor(frac * 512.0).to(i64).clamp(0, 511)
        wraps = torch.div(chips, 1023, rounding_mode="floor")
        chip = chips - wraps * 1023
        s = _data_and_code(ca, dw, t(base[:, c], i64), chip,
                           wraps).to(torch.float64)
        g = t(gain[:, c])[:, None]
        keep = t(on, i64)[:, None]
        i_acc += torch.trunc(s * cos_t[idx] * g).to(i64) * keep
        q_acc += torch.trunc(s * sin_t[idx] * g).to(i64) * keep
    return _finalize(i_acc, q_acc, dev)


def synth_bytes(plans, starts: np.ndarray, device: str) -> tuple:
    """int8[B, 2N] (a tensor on ``device``) interleaved I/Q of ``plans``, whose carrier phase at the
    block start is ``starts`` (f64[B, C]), and the number of flagged
    samples that were replayed sequentially."""
    dev = torch.device(device)
    f64 = torch.float64
    B = len(plans)
    N = plans[0].num_samples
    delt = plans[0].delt
    active = _stack(plans, "active", bool)
    cp0 = _stack(plans, "code_phase", np.float64)
    dc = _stack(plans, "f_code", np.float64) * delt
    dp = _stack(plans, "f_carr", np.float64) * delt
    gain = _stack(plans, "gain", np.float64)
    base = (_stack(plans, "iword", np.int64) * 600
            + _stack(plans, "ibit", np.int64) * 20
            + _stack(plans, "icode", np.int64))
    starts = np.ascontiguousarray(starts, dtype=np.float64)
    code_e0 = _ulp_bound(cp0 + N * np.abs(dc) + 1.0)
    carr_e0 = _ulp_bound(np.abs(starts) + N * np.abs(dp) + 1.0)

    def t(a, dtype=f64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    n = torch.arange(N, dtype=f64, device=dev)[None, :]
    cos_t, sin_t = t(COS), t(SIN)
    i_acc = torch.zeros((B, N), dtype=torch.int64, device=dev)
    q_acc = torch.zeros((B, N), dtype=torch.int64, device=dev)
    flagged = defaultdict(list)  # (b, c) -> sample indices
    for c in range(active.shape[1]):
        on = active[:, c]
        if not on.any():
            continue
        ca, dw = _channel_tables(plans, c, t)
        raw = t(cp0[:, c])[:, None] + n * t(dc[:, c])[:, None]
        wraps = torch.floor(raw / 1023.0)
        chip = (raw - wraps * 1023.0).to(torch.int64).clamp(0, 1022)
        sign = _data_and_code(ca, dw, t(base[:, c], torch.int64), chip,
                              wraps.to(torch.int64))
        carr = t(starts[:, c])[:, None] + n * t(dp[:, c])[:, None]
        frac = carr - torch.floor(carr)
        idx = torch.floor(frac * 512.0).to(torch.int64).clamp(0, 511)
        s = sign.to(f64)
        g = t(gain[:, c])[:, None]
        keep = t(on, torch.int64)[:, None]
        i_acc += torch.trunc(s * cos_t[idx] * g).to(torch.int64) * keep
        q_acc += torch.trunc(s * sin_t[idx] * g).to(torch.int64) * keep
        del sign, s, idx, chip
        code_m = 2.0 * (n * 2.0**-44 + t(code_e0[:, c])[:, None])
        carr_m = 2.0 * 512.0 * (n * 2.0**-53 + t(carr_e0[:, c])[:, None])
        y = frac * 512.0
        flag = ((raw - torch.round(raw)).abs() <= code_m) | (
            (y - torch.round(y)).abs() <= carr_m)
        flag &= t(on, torch.bool)[:, None]
        for b, k in torch.nonzero(flag).cpu().numpy():
            flagged[(int(b), c)].append(int(k))
        del raw, wraps, carr, frac, y, flag
    n_flagged = 0
    if flagged:
        rows, cols, di, dq = [], [], [], []
        for (b, c), ks in flagged.items():
            p = plans[b]
            ks = np.asarray(ks, dtype=np.int64)
            ci, cq = _closed_form_at(p, c, ks, starts[b, c])
            si, sq = _sequential_at(p, c, ks, starts[b, c])
            rows.append(np.full(len(ks), b))
            cols.append(ks)
            di.append(si - ci)
            dq.append(sq - cq)
            n_flagged += len(ks)
        at = (t(np.concatenate(rows), torch.int64),
              t(np.concatenate(cols), torch.int64))
        i_acc.index_put_(at, t(np.concatenate(di), torch.int64),
                         accumulate=True)
        q_acc.index_put_(at, t(np.concatenate(dq), torch.int64),
                         accumulate=True)
    return _finalize(i_acc, q_acc, dev), n_flagged
