"""GPS C/A acquisition on generated IQ — receiver-side validation.

The counterpart of the JAX package's ``acquire.py``. The reference's
end-to-end QA is physical: feed the RF output to a real receiver and check
it finds the simulated satellites. This is the software equivalent: a
classic FFT parallel-code-phase search over the generated baseband,
returning detected PRNs with Doppler and code-phase estimates. Used by
tests to prove the stream is *receivable*, not merely byte-identical, and
handy as a debugging tool:

    python -m gpssim_tpu_torch.acquire iqdata.bin --bits 8 --rate 3000000
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .core.cacode import ca_table
from .core.constants import CA_SEQ_LEN, CODE_FREQ

BACKENDS = ("numpy", "torch")


@dataclass
class Detection:
    prn: int
    doppler_hz: float
    code_phase_chips: float
    snr: float  # peak power / mean off-peak power


def load_iq(path: str, bits: int = 8) -> np.ndarray:
    """Interleaved IQ file → complex64 baseband."""
    dtype = np.int8 if bits == 8 else np.int16
    raw = np.fromfile(path, dtype=dtype).astype(np.float32)
    # A file truncated mid-sample-pair (killed writer) still has a valid
    # prefix — drop the trailing lone I value instead of crashing.
    raw = raw[: len(raw) // 2 * 2]
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def _resampled_codes(sample_rate: float, n: int) -> np.ndarray:
    """C/A chips (±1) for all 32 PRNs sampled at ``sample_rate`` over n
    samples (one code period worth)."""
    chips = ca_table().astype(np.float32) * 2.0 - 1.0  # (32, 1023) ±1
    idx = (
        np.arange(n, dtype=np.float64) * (CODE_FREQ / sample_rate)
    ).astype(np.int64) % CA_SEQ_LEN
    return chips[:, idx]  # (32, n)


def _scan_numpy(seg, code_fft, bins, t, noncoherent_ms, n, n_prns):
    """Per-bin Doppler wipe + FFT correlation, NumPy. Returns the
    (ratio, doppler, lag) best row per PRN."""
    best = np.zeros((n_prns, 3))
    for fd in bins:
        wiped = (seg * np.exp(-2j * np.pi * fd * t)).reshape(
            noncoherent_ms, n
        )
        wf = np.fft.fft(wiped, axis=1)  # (ms, n)
        corr = np.fft.ifft(
            wf[None, :, :] * code_fft[:, None, :], axis=2
        )  # (P, ms, n)
        power = (corr.real**2 + corr.imag**2).sum(axis=1)  # (P, n)
        lag = np.argmax(power, axis=1)
        peak = power[np.arange(n_prns), lag]
        total = power.sum(axis=1)
        for k in range(n_prns):
            # Correlation is circular: exclude the peak's ±2 neighbours
            # with wraparound, or a peak near lag 0 / n-1 leaks its own
            # energy into the noise estimate.
            excl = (int(lag[k]) + np.arange(-2, 3)) % n
            off = total[k] - power[k, excl].sum()
            ratio = float(peak[k]) / (off / (n - excl.size))
            if ratio > best[k, 0]:
                best[k] = (ratio, float(fd), float(lag[k]))
    return best


def _scan_torch(seg, code_fft, bins, t, noncoherent_ms, n, n_prns,
                device):
    """The same search as one batched program on ``device``, complex64:
    every (bin, PRN) cell of the grid at once — the Doppler wipes, the
    forward/inverse FFTs over the code period, the noncoherent sum, and
    the circular-exclusion SNR; only the (P, 3) winners come home. The
    counterpart of the JAX package's jitted ``_scan_jax``."""
    import torch

    seg_d = torch.from_numpy(np.asarray(seg, np.complex64)).to(device)
    cfft_d = torch.from_numpy(np.asarray(code_fft, np.complex64)).to(device)
    bins_d = torch.from_numpy(np.asarray(bins, np.float32)).to(device)
    t_d = torch.from_numpy(np.asarray(t, np.float32)).to(device)

    # exp(-2πj·fd·t), with the phase rounded as jnp rounds it: (-2π·fd)·t
    ang = ((-2.0 * math.pi) * bins_d)[:, None] * t_d[None, :]  # (B, need)
    wipe = torch.polar(torch.ones_like(ang), ang)
    wiped = (seg_d[None, :] * wipe).reshape(-1, noncoherent_ms, n)
    wf = torch.fft.fft(wiped, dim=-1)  # (B, ms, n)
    corr = torch.fft.ifft(wf[:, None, :, :] * cfft_d[None, :, None, :],
                          dim=-1)  # (B, P, ms, n)
    power = torch.view_as_real(corr).square().sum(-1).sum(2)  # (B, P, n)
    del corr
    lag = torch.argmax(power, dim=2)  # (B, P), the first maximum
    peak = torch.gather(power, 2, lag[:, :, None])[..., 0]
    total = power.sum(dim=2)
    excl = (lag[:, :, None]
            + torch.arange(-2, 3, device=power.device)[None, None, :]) % n
    off = total - torch.gather(power, 2, excl).sum(dim=2)
    ratio = peak / (off / (n - 5))  # (B, P)
    b_best = torch.argmax(ratio, dim=0)  # (P,), the first maximum
    ar = torch.arange(ratio.shape[1], device=ratio.device)
    best = np.zeros((n_prns, 3))
    best[:, 0] = ratio[b_best, ar].cpu().numpy().astype(np.float64)
    best[:, 1] = bins_d[b_best].cpu().numpy().astype(np.float64)
    best[:, 2] = lag[b_best, ar].cpu().numpy().astype(np.float64)
    return best


def acquire(
    x: np.ndarray,
    sample_rate: float = 3_000_000.0,
    max_doppler_hz: float = 5_000.0,
    doppler_step_hz: float = 250.0,
    noncoherent_ms: int = 5,
    snr_threshold: float = 12.0,
    prns=None,
    backend: str = "numpy",
    device="cuda",
) -> list[Detection]:
    """Parallel code-phase search (FFT circular correlation).

    For each PRN and Doppler bin, correlates ``noncoherent_ms`` successive
    1 ms segments against the local code and sums their power. Returns
    detections sorted by SNR.

    ``backend='torch'`` runs the whole (bin x PRN) search grid as one
    batched program on ``device`` (``cuda`` unless the caller names
    ``cpu``; without a card it raises), in single-precision FFTs: SNR
    ratios differ from the f64 NumPy path in the 3rd decimal, detections
    match. ``device`` is unused by the NumPy backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown acquisition backend {backend!r}")
    if backend == "torch":
        from .runner import torch_device

        device = torch_device(device)
    n = int(round(sample_rate * 1e-3))  # samples per code period
    need = n * noncoherent_ms
    if len(x) < need:
        raise ValueError(f"need at least {need} samples, got {len(x)}")
    prns = list(range(1, 33)) if prns is None else list(prns)
    codes = _resampled_codes(sample_rate, n)[np.asarray(prns) - 1]
    code_fft = np.conj(np.fft.fft(codes, axis=1))  # (P, n)

    t = np.arange(need, dtype=np.float64) / sample_rate
    bins = np.arange(-max_doppler_hz, max_doppler_hz + 1, doppler_step_hz)
    seg = x[:need]

    if backend == "torch":
        best = _scan_torch(seg, code_fft, bins, t, noncoherent_ms, n,
                           len(prns), device)
    else:
        best = _scan_numpy(seg, code_fft, bins, t, noncoherent_ms, n,
                           len(prns))

    out = []
    for k, prn in enumerate(prns):
        if best[k, 0] >= snr_threshold:
            # lag samples until the code START → code phase in chips
            phase = (
                (-int(best[k, 2]) % n) * (CODE_FREQ / sample_rate)
            ) % CA_SEQ_LEN
            out.append(Detection(prn, best[k, 1], phase, float(best[k, 0])))
    out.sort(key=lambda d: -d.snr)
    return out


def demodulate_bits(
    x: np.ndarray, plans, slot: int, sample_rate: float = 3_000_000.0
):
    """Coherently demodulate one channel's nav bits from baseband IQ.

    Wipes code and carrier with the channel's exact per-block parameters
    (plans from scenario.Simulation), integrates per code period, and
    slices 20 ms bits on the channel's icode boundary. Returns
    (bits uint8[N], start_bit) where start_bit is the index of bits[0] in
    the channel's dwrd bit stream (word*30 + bit)."""
    n = plans[0].num_samples
    ca = plans[0].ca[slot]
    # Integrate per GLOBAL code period: the chip stream is continuous
    # across blocks, so a period split by a block boundary accumulates
    # from both fragments (per-block handling would count it twice).
    total = len(plans) * n // int(sample_rate // 1000) + 4
    acc = np.zeros(total, dtype=np.complex128)
    cnt = np.zeros(total, dtype=np.int64)
    base = 0
    prev_end_mod = None
    tgrid = np.arange(n, dtype=np.float64)
    for b, plan in enumerate(plans):
        code_phase = plan.code_phase[slot] + tgrid * (
            plan.f_code[slot] * plan.delt
        )
        # A code wrap can fall exactly between two blocks: the next
        # block then STARTS in a new period even though its own
        # period[0] is also 0 — detect it from the boundary phases or
        # the global period counter slips one code period.
        if prev_end_mod is not None and (
            plan.code_phase[slot] % CA_SEQ_LEN
        ) < prev_end_mod:
            base += 1
        chips = ca[(code_phase % CA_SEQ_LEN).astype(np.int64)].astype(
            np.float64
        ) * 2.0 - 1.0
        carr = plan.carr_phase[slot] + tgrid * (
            plan.f_carr[slot] * plan.delt
        )
        wiped = x[b * n : (b + 1) * n] * chips * np.exp(-2j * np.pi * carr)
        period = (code_phase // CA_SEQ_LEN).astype(np.int64)
        gid = base + (period - period[0])
        np.add.at(acc, gid, wiped)
        np.add.at(cnt, gid, 1)
        base += int(period[-1]) - int(period[0])
        prev_end_mod = float(code_phase[-1] % CA_SEQ_LEN)
    full = 0.9 * sample_rate * 1e-3
    kept = np.nonzero(cnt > full)[0]
    corr = acc[kept]

    ms_bits = np.sign(corr.real).astype(np.int64)
    # corr[0] is the first KEPT code period; gid 0 (the block-start
    # period) survives the count filter only when the starting code phase
    # is small enough that its fragment is nearly whole. The ms counter
    # is tcu0 + first kept gid (tcu = iword*600 + ibit*20 + icode).
    tcu0 = (
        int(plans[0].iword[slot]) * 600
        + int(plans[0].ibit[slot]) * 20
        + int(plans[0].icode[slot])
    )
    start_ms = tcu0 + int(kept[0])
    j0 = (-start_ms) % 20  # first 20 ms-aligned entry
    usable = ms_bits[j0:]
    nbits = len(usable) // 20
    groups = usable[: nbits * 20].reshape(nbits, 20)
    bits = (groups.sum(axis=1) > 0).astype(np.uint8)
    start_bit = (start_ms + j0) // 20
    return bits, start_bit


def decode_tow(bits: np.ndarray) -> list[tuple[int, int]]:
    """Find subframes in a demodulated bit stream and decode their TOW.

    Scans for the TLM preamble (IS-GPS-200 10001011, possibly inverted by
    D30*), validates both TLM and HOW word parity, and returns
    [(bit_offset, tow_count), ...]. tow_count*6 is the GPS
    second-of-week of the NEXT subframe boundary."""
    from .core.navmsg import LNAV_PREAMBLE_BITS, decode_data_word

    out = []
    n = len(bits)
    # D29*/D30* come from the 2 bits before the preamble, and TLM+HOW
    # need 60 bits from i — hence the scan bounds.
    for i in range(2, n - 59):
        seg = bits[i : i + 8]
        if not (
            np.array_equal(seg, LNAV_PREAMBLE_BITS)
            or np.array_equal(seg, 1 - LNAV_PREAMBLE_BITS)
        ):
            continue
        tlm = decode_data_word(bits, i)
        how = decode_data_word(bits, i + 30)
        if tlm is None or how is None:
            continue
        out.append((i, (how >> 7) & 0x1FFFF))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iq_file")
    ap.add_argument("--bits", type=int, default=8, choices=(8, 16))
    ap.add_argument("--rate", type=float, default=3_000_000.0)
    ap.add_argument("--max-doppler", type=float, default=5_000.0)
    ap.add_argument("--backend", default="numpy", choices=BACKENDS,
                    help="torch = run the search grid on --device")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="Torch device of --backend torch (default cuda; "
                         "without a card it raises)")
    args = ap.parse_args(argv)

    x = load_iq(args.iq_file, args.bits)
    dets = acquire(x, args.rate, max_doppler_hz=args.max_doppler,
                   backend=args.backend, device=args.device)
    print(f"{len(dets)} PRNs acquired:")
    for d in dets:
        print(
            f"  PRN{d.prn:3d}  doppler {d.doppler_hz:+7.0f} Hz  "
            f"code phase {d.code_phase_chips:7.1f} chips  snr {d.snr:6.1f}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
