"""Software GPS receiver: track, demodulate, decode, and fix position.

A copy of the JAX package's ``receiver.py`` (host NumPy; it imports no
JAX), whose acquisition is this package's :mod:`acquire`.

The reference's ultimate QA step is physical — feed the RF output to a
real GPS receiver and check it obtains a fix at the simulated location
(SURVEY §4 item 2). This module closes that loop entirely in software,
*without* using any simulator internals: starting from the raw IQ file it

  1. acquires PRNs (FFT code-phase search, :mod:`gpssim_tpu_torch.acquire`),
  2. tracks each one (carrier-aided code tracking with a correlation-apex
     code discriminator + Costas carrier loop),
  3. demodulates the 50 bps nav bits and frame-syncs on the TLM preamble,
  4. decodes ephemerides and iono/UTC data from the LNAV words — the bit
     inverse of navmsg.eph2sbf (reference gps.c:617-884),
  5. measures pseudoranges from the decoded TOW + tracked chip timeline,
  6. solves the navigation equations (Gauss-Newton with Sagnac and
     Klobuchar corrections, reference gps.c:1972-2026 observation model).

Usage:  python -m gpssim_tpu_torch.receiver iqdata.bin --bits 8 --rate 3000000
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .acquire import Detection, acquire, load_iq
from .core.almanac import Almanac
from .core.atmosphere import IonoUtc, ionospheric_delay
from .core.cacode import ca_table
from .core.constants import (
    CA_SEQ_LEN,
    CARR_TO_CODE,
    CODE_FREQ,
    LAMBDA_L1,
    OMEGA_EARTH,
    PI,
    POW2_12,
    POW2_M5,
    POW2_M11,
    POW2_M19,
    POW2_M20,
    POW2_M21,
    POW2_M23,
    POW2_M24,
    POW2_M27,
    POW2_M29,
    POW2_M30,
    POW2_M31,
    POW2_M33,
    POW2_M38,
    POW2_M43,
    POW2_M50,
    POW2_M55,
    SPEED_OF_LIGHT,
)
from .core.frames import ecef2neu, ltcmat, neu2azel, xyz2llh
from .core.gpstime import GpsTime
from .core.navmsg import LNAV_PREAMBLE_BITS, decode_data_word
from .core.orbits import EphemerisSet, satpos

CHIP_RATE = float(CODE_FREQ)  # 1.023e6 chips / SV-second

_PREAMBLE_BITS = LNAV_PREAMBLE_BITS


def _chips_pm1(prn: int) -> np.ndarray:
    """C/A chips of one PRN as ±1 float64."""
    return ca_table()[prn - 1].astype(np.float64) * 2.0 - 1.0


def _resolve_rollover(value: int, hint: int, period: int) -> int:
    """Resolve a truncated week counter to the era nearest ``hint``."""
    return value + ((hint - value + period // 2) // period) * period


def _satpos_gps(eph: EphemerisSet, taus: np.ndarray, svs: np.ndarray):
    """satpos at GPS time for decoded SV-clock transmit times.

    The decoded transmit times run on each SV's clock; convert to GPS
    time before evaluating the orbit (an uncorrected spec-limit 1 ms
    clock offset would shift the satellite ~4 m along track). One pass
    suffices: d(clk)/dt ~ af1 is negligible over |clk|."""
    _, _, clk0 = satpos(eph, taus, svs)
    return satpos(eph, taus - clk0[:, 0], svs)


# --------------------------------------------------------------------------
# Tracking
# --------------------------------------------------------------------------


@dataclass
class TrackedChannel:
    """One PRN's tracking result over the whole stream."""

    prn: int
    sample_rate: float
    seg_len: int  # samples per tracking segment
    cp_meas: np.ndarray  # (K,) measured absolute chips at segment starts
    f_chip: np.ndarray  # (K,) chips/sample per segment
    doppler_hz: float  # final carrier Doppler estimate
    bits: np.ndarray  # (B,) demodulated nav bits
    bit0_period: int  # absolute code-period index of bits[0]'s first period
    lock_quality: float  # mean |prompt| coherence over the run

    def chips_at(self, sample: float, fit_window_s: float = 1.5) -> float:
        """Measured transmitted chip count at a (fractional) sample index.

        Fits a line to the per-segment code-phase measurements in a window
        ending at ``sample`` and evaluates it there: the per-segment apex
        measurements carry cross-PRN correlation bias that rotates at the
        inter-satellite Doppler differences, so a ~1.5 s fit averages it
        out (chip-rate curvature over the window is < 1e-3 chips)."""
        fit_segments = max(
            4, int(round(fit_window_s * self.sample_rate / self.seg_len))
        )
        k = min(int(sample) // self.seg_len, len(self.cp_meas) - 1)
        k0 = max(0, k - fit_segments + 1)
        ks = np.arange(k0, k + 1)
        if len(ks) < 4:
            return float(
                self.cp_meas[k] + (sample - k * self.seg_len) * self.f_chip[k]
            )
        # Remove the per-segment NCO prediction, fit the small residual.
        s_rel = ks * self.seg_len - sample
        pred0 = self.cp_meas[k] + s_rel * self.f_chip[k]
        resid = self.cp_meas[ks] - pred0
        c = np.polyfit(s_rel, resid, 1)
        return float(self.cp_meas[k] + np.polyval(c, 0.0))


def fine_doppler(
    x: np.ndarray, det: Detection, sample_rate: float, span_ms: int = 120
) -> float:
    """Refine acquisition Doppler to sub-Hz by a phase-slope fit.

    Open-loop: wipe code at the acquisition phase, integrate 1 ms prompts,
    square to strip the data modulation, and fit the unwrapped phase slope.
    """
    n = int(round(sample_rate * 1e-3))
    span_ms = min(span_ms, len(x) // n)
    chips2 = _chips_pm1(det.prn)

    t = np.arange(span_ms * n, dtype=np.float64)
    f_chip = (CHIP_RATE + det.doppler_hz * CARR_TO_CODE) / sample_rate
    cpv = det.code_phase_chips + t * f_chip
    code = chips2[(cpv % CA_SEQ_LEN).astype(np.int64)]
    lo = np.exp(-2j * np.pi * det.doppler_hz * t / sample_rate)
    prompts = (x[: span_ms * n] * code * lo).reshape(span_ms, n).sum(axis=1)

    sq = prompts * prompts  # data-stripped: phase advances at 2*df
    ph = np.unwrap(np.angle(sq)) / (4.0 * np.pi)  # cycles of df
    k = np.arange(span_ms, dtype=np.float64) * 1e-3  # seconds
    slope = np.polyfit(k, ph, 1)[0]
    return det.doppler_hz + float(slope)


def track(
    x: np.ndarray,
    det: Detection,
    sample_rate: float,
    seg_periods: int = 10,
) -> TrackedChannel:
    """Track one PRN through the stream.

    Code: carrier-aided NCO with a per-segment correlation-apex
    discriminator (the correlation function of the unfiltered BPSK signal
    is an exact triangle, so the apex from three lags is the measured code
    phase). Carrier: Costas loop on per-period prompts. Returns the
    measured chip timeline used for pseudorange extraction.
    """
    fs = float(sample_rate)
    n = int(round(fs * 1e-3))
    if abs(fs * 1e-3 - n) > 1e-9:
        raise ValueError(f"sample_rate {fs} must be a multiple of 1 kHz")
    chips2 = _chips_pm1(det.prn)

    fd = fine_doppler(x, det, fs)
    f_chip = (CHIP_RATE + fd * CARR_TO_CODE) / fs
    cp = float(det.code_phase_chips)
    ph = 0.0

    seg = seg_periods * n
    n_seg = len(x) // seg
    total_periods = int(len(x) * f_chip / CA_SEQ_LEN) + 3

    prompt = np.zeros(total_periods, dtype=np.complex128)
    pcount = np.zeros(total_periods, dtype=np.int64)
    cp_meas = np.zeros(n_seg)
    f_chips = np.zeros(n_seg)
    coh = 0.0

    tseg = np.arange(seg, dtype=np.float64)
    text = np.arange(-2, seg + 2, dtype=np.float64)  # 2-sample apron
    for k in range(n_seg):
        xs = x[k * seg : (k + 1) * seg]
        cpv = cp + tseg * f_chip
        lo = np.exp(-2j * np.pi * (ph + tseg * fd / fs))
        z = xs * lo

        # Lag correlations (lags in samples; 1 sample <= 1 chip). A lag-L
        # replica is the lag-0 code shifted L samples, so one code lookup
        # over an extended window serves all five correlators. The
        # discriminator is COHERENT (each lag projected on the prompt
        # phasor): cross-PRN leakage then rotates at the inter-satellite
        # Doppler beat and averages out of the timeline fit, whereas an
        # envelope discriminator would keep a phase-insensitive bias.
        code_ext = chips2[
            ((cp + text * f_chip) % CA_SEQ_LEN).astype(np.int64)
        ]
        cvec = np.array(
            [z @ code_ext[2 - L : 2 - L + seg] for L in (-2, -1, 0, 1, 2)]
        )
        proj = (cvec * cvec[2].conjugate()).real / (abs(cvec[2]) + 1e-12)
        pk = int(np.argmax(proj[1:4])) + 1  # keep a neighbor on each side
        y0, ym, yp = proj[pk], proj[pk - 1], proj[pk + 1]
        # Exact triangle-apex form, bounded: with s = peak minus the
        # SMALLER neighbor, |frac| <= 0.5 for any inputs, so one noisy
        # segment cannot throw an unbounded outlier into the timeline
        # fit (the midpoint form (yp-ym)/(2*(y0-(ym+yp)/2)) is unbounded
        # when an excluded outer lag rivals the interior peak).
        s = y0 - min(ym, yp)
        frac = 0.0 if s <= 0 else (yp - ym) / (2.0 * s)
        apex = (pk - 2) + float(np.clip(frac, -1.0, 1.0))
        delta_chips = -apex * f_chip  # measured (true - NCO) code phase

        # Measured timeline for this segment; advance the NCO over the
        # segment and apply the (clamped) deadbeat correction.
        cp_meas[k] = cp + delta_chips
        f_chips[k] = f_chip

        # Per-period prompt accumulation on the measured timeline.
        y = z * code_ext[2 : 2 + seg]
        # Clip: a near-zero starting phase with a negative correction
        # would index period -1 and wrap the prompt slice.
        pid = np.clip(
            ((cpv + delta_chips) // CA_SEQ_LEN).astype(np.int64),
            0, total_periods - 1,
        )
        rel = pid - pid[0]
        nbins = int(rel[-1]) + 1
        seg_re = np.bincount(rel, weights=y.real, minlength=nbins)
        seg_im = np.bincount(rel, weights=y.imag, minlength=nbins)
        segprompt = seg_re + 1j * seg_im
        prompt[pid[0] : pid[0] + nbins] += segprompt
        pcount[pid[0] : pid[0] + nbins] += np.bincount(rel, minlength=nbins)

        cp += seg * f_chip + np.clip(delta_chips, -0.4, 0.4)

        # Costas: combine this segment's periods coherently, sign-stripped.
        signs = np.where(segprompt.real >= 0, 1.0, -1.0)
        csum = (segprompt * signs).sum()
        coh += abs(csum.real) / (abs(csum) + 1e-12)
        e = np.arctan2(csum.imag, csum.real) / (2.0 * np.pi)  # cycles
        ph = (ph + seg * fd / fs + 0.7 * e) % 1.0
        fd += e * (1000.0 / seg_periods) * 0.25
        f_chip = (CHIP_RATE + fd * CARR_TO_CODE) / fs

    # Bits from kept (≥90 % populated) periods.
    full = 0.9 * n
    kept = np.nonzero(pcount > full)[0]
    signs = np.where(prompt[kept].real >= 0, 1, 0).astype(np.int64)

    # Bit sync: transitions vote for the 20 ms boundary phase.
    trans = kept[1:][signs[1:] != signs[:-1]]
    if len(trans) == 0:
        raise RuntimeError(f"PRN{det.prn}: no bit transitions, cannot sync")
    phases = trans % 20
    b0 = int(np.bincount(phases, minlength=20).argmax())

    first = kept[0] + ((b0 - kept[0]) % 20)
    nbits = int((kept[-1] + 1 - first) // 20)
    bits = np.zeros(nbits, dtype=np.uint8)
    for i in range(nbits):
        lo_, hi_ = first + i * 20, first + (i + 1) * 20
        sel = kept[(kept >= lo_) & (kept < hi_)]
        bits[i] = 1 if prompt[sel].real.sum() >= 0 else 0

    return TrackedChannel(
        prn=det.prn,
        sample_rate=fs,
        seg_len=seg,
        cp_meas=cp_meas,
        f_chip=f_chips,
        doppler_hz=fd,
        bits=bits,
        bit0_period=int(first),
        lock_quality=float(coh / max(n_seg, 1)),
    )


# --------------------------------------------------------------------------
# LNAV decoding (bit inverse of navmsg.eph2sbf, reference gps.c:617-884)
# --------------------------------------------------------------------------


def _sx(v: int, bits: int) -> int:
    """Sign-extend a ``bits``-wide field."""
    v &= (1 << bits) - 1
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


@dataclass
class DecodedFrames:
    """LNAV words grouped by subframe, plus frame timing."""

    # subframe id (1..3) → 10×24-bit data words; {4: {page_svid: words}}
    subframes: dict = field(default_factory=dict)
    pages4: dict = field(default_factory=dict)
    pages5: dict = field(default_factory=dict)
    # (bit_offset_into_stream, tow_count) per decoded subframe
    tows: list = field(default_factory=list)


def decode_frames(bits: np.ndarray) -> DecodedFrames:
    """Frame-sync a demodulated bit stream and extract all LNAV words.

    Scans for the TLM preamble, parity-checks all ten words of each
    subframe (IS-GPS-200 D29*/D30* chaining), de-inverts data per D30*,
    and files the 24-bit data words by subframe/page."""
    out = DecodedFrames()
    n = len(bits)
    i = 2
    while i <= n - 300:
        seg = bits[i : i + 8]
        if not (
            np.array_equal(seg, _PREAMBLE_BITS)
            or np.array_equal(seg, 1 - _PREAMBLE_BITS)
        ):
            i += 1
            continue
        words = []
        for w in range(10):
            data = decode_data_word(bits, i + 30 * w)
            if data is None:
                break
            words.append(data)
        if len(words) < 10:
            i += 1
            continue

        how = words[1]
        tow = (how >> 7) & 0x1FFFF
        sfid = (how >> 2) & 0x7
        out.tows.append((i, tow))
        if sfid in (1, 2, 3):
            out.subframes[sfid] = words
        elif sfid == 4:
            out.pages4[(words[2] >> 16) & 0x3F] = words
        elif sfid == 5:
            out.pages5[(words[2] >> 16) & 0x3F] = words
        i += 300
    return out


def decode_ephemeris(
    frames: DecodedFrames, prn: int, week_hint: int, eph: EphemerisSet
) -> None:
    """Decode subframes 1-3 into ``eph`` slot ``prn - 1``.

    Exact bit inverse of navmsg.eph2sbf subframes 1-3 (reference
    gps.c:706-740); scale factors per IS-GPS-200 Table 20-I/20-III."""
    sv = prn - 1
    sf1 = frames.subframes[1]
    sf2 = frames.subframes[2]
    sf3 = frames.subframes[3]

    wn10 = (sf1[2] >> 14) & 0x3FF
    iodc = ((sf1[2] & 0x3) << 8) | (sf1[7] >> 16)
    tgd = _sx(sf1[6], 8)
    toc = sf1[7] & 0xFFFF
    af2 = _sx(sf1[8] >> 16, 8)
    af1 = _sx(sf1[8], 16)
    af0 = _sx(sf1[9] >> 2, 22)

    iode = sf2[2] >> 16
    crs = _sx(sf2[2], 16)
    deltan = _sx(sf2[3] >> 8, 16)
    m0 = _sx(((sf2[3] & 0xFF) << 24) | sf2[4], 32)
    cuc = _sx(sf2[5] >> 8, 16)
    ecc = ((sf2[5] & 0xFF) << 24) | sf2[6]
    cus = _sx(sf2[7] >> 8, 16)
    sqrta = ((sf2[7] & 0xFF) << 24) | sf2[8]
    toe = sf2[9] >> 8

    cic = _sx(sf3[2] >> 8, 16)
    omega0 = _sx(((sf3[2] & 0xFF) << 24) | sf3[3], 32)
    cis = _sx(sf3[4] >> 8, 16)
    inc0 = _sx(((sf3[4] & 0xFF) << 24) | sf3[5], 32)
    crc = _sx(sf3[6] >> 8, 16)
    aop = _sx(((sf3[6] & 0xFF) << 24) | sf3[7], 32)
    omegadot = _sx(sf3[8], 24)
    idot = _sx(sf3[9] >> 2, 14)

    week = _resolve_rollover(wn10, week_hint, 1024)

    eph.vflg[sv] = True
    eph.toc_week[sv] = week
    eph.toc_sec[sv] = toc * 16.0
    eph.toe_week[sv] = week
    eph.toe_sec[sv] = toe * 16.0
    eph.iodc[sv] = iodc
    eph.iode[sv] = iode
    eph.tgd[sv] = tgd * POW2_M31
    eph.af0[sv] = af0 * POW2_M31
    eph.af1[sv] = af1 * POW2_M43
    eph.af2[sv] = af2 * POW2_M55
    eph.crs[sv] = crs * POW2_M5
    eph.crc[sv] = crc * POW2_M5
    eph.cuc[sv] = cuc * POW2_M29
    eph.cus[sv] = cus * POW2_M29
    eph.cic[sv] = cic * POW2_M29
    eph.cis[sv] = cis * POW2_M29
    eph.deltan[sv] = deltan * POW2_M43 * PI
    eph.m0[sv] = m0 * POW2_M31 * PI
    eph.ecc[sv] = ecc * POW2_M33
    eph.sqrta[sv] = sqrta * POW2_M19
    eph.omg0[sv] = omega0 * POW2_M31 * PI
    eph.inc0[sv] = inc0 * POW2_M31 * PI
    eph.aop[sv] = aop * POW2_M31 * PI
    eph.omgdot[sv] = omegadot * POW2_M43 * PI
    eph.idot[sv] = idot * POW2_M43 * PI


def decode_iono_utc(
    frames: DecodedFrames, week_hint: int | None = None
) -> IonoUtc:
    """Decode subframe 4 page 18 (SVID 56) iono/UTC parameters.

    Inverse of the page-18 packing (reference gps.c:805-817). With a
    week_hint, the truncated 8-bit UTC reference week is resolved to a
    full week (mod-256 era), matching the RINEX-parsed IonoUtc."""
    iono = IonoUtc()
    words = frames.pages4.get(56)
    if words is None:
        return iono
    iono.enable = True
    iono.vflg = True
    iono.alpha0 = _sx(words[2] >> 8, 8) * POW2_M30
    iono.alpha1 = _sx(words[2], 8) * POW2_M27
    iono.alpha2 = _sx(words[3] >> 16, 8) * POW2_M24
    iono.alpha3 = _sx(words[3] >> 8, 8) * POW2_M24
    iono.beta0 = _sx(words[3], 8) * 2048.0
    iono.beta1 = _sx(words[4] >> 16, 8) * 16384.0
    iono.beta2 = _sx(words[4] >> 8, 8) * 65536.0
    iono.beta3 = _sx(words[4], 8) * 65536.0
    iono.A1 = _sx(words[5], 24) * POW2_M50
    iono.A0 = _sx((words[6] << 8) | (words[7] >> 16), 32) * POW2_M30
    iono.tot = ((words[7] >> 8) & 0xFF) * 4096
    wnt8 = words[7] & 0xFF
    if week_hint is not None:
        wnt8 = _resolve_rollover(wnt8, week_hint, 256)
    iono.wnt = wnt8
    iono.dtls = _sx(words[8] >> 16, 8)
    return iono


def decode_almanac(frames: DecodedFrames, week_hint: int) -> Almanac:
    """Decode almanac pages (SF5 pages 1-24 for PRN 1-24, SF4 pages for
    PRN 25-32) plus the SF5 page-25 toa/wna reference.

    Bit inverse of the reference's almanac page packing (gps.c:772-803,
    831-883); scale factors per IS-GPS-200 Table 20-VI. Note a full
    almanac needs the whole 25-frame page cycle (12.5 min of signal)."""
    alm = Almanac()

    wna = None
    toa_sec = None
    p25 = frames.pages5.get(51)
    if p25 is not None:
        toa_sec = float((p25[2] >> 8) & 0xFF) * POW2_12
        wna = _resolve_rollover(p25[2] & 0xFF, week_hint, 256)

    pages = {s: w for s, w in frames.pages5.items() if 1 <= s <= 24}
    pages.update({s: w for s, w in frames.pages4.items() if 25 <= s <= 32})
    for svid, w in pages.items():
        a = alm.sv[svid - 1]
        a.svid = svid
        a.valid = 1
        a.e = float(w[2] & 0xFFFF) * POW2_M21
        toa8 = (w[3] >> 16) & 0xFF
        a.toa = GpsTime(
            wna if wna is not None else week_hint,
            toa_sec if toa_sec is not None else toa8 * POW2_12,
        )
        a.delta_i = _sx(w[3], 16) * POW2_M19
        a.omegadot = _sx(w[4] >> 8, 16) * POW2_M38
        a.sqrta = float(w[5]) * POW2_M11
        a.omega0 = _sx(w[6], 24) * POW2_M23
        a.aop = _sx(w[7], 24) * POW2_M23
        a.m0 = _sx(w[8], 24) * POW2_M23
        af0 = _sx((((w[9] >> 16) & 0xFF) << 3) | ((w[9] >> 2) & 0x7), 11)
        a.af0 = af0 * POW2_M20
        a.af1 = _sx(w[9] >> 5, 11) * POW2_M38
    if pages:
        alm.valid = 1
    return alm


# --------------------------------------------------------------------------
# Pseudoranges + navigation solution
# --------------------------------------------------------------------------


@dataclass
class Observation:
    prn: int
    tau_sv: float  # transmit time (SV clock, second of week)
    pr_rel: float  # c * (t_nom - tau_sv): pseudorange up to a common bias


def measure_pseudoranges(
    channels: list[TrackedChannel], frames_by_prn: dict, sample_idx: int
) -> tuple[list[Observation], float]:
    """Transmit times / relative pseudoranges at a common received sample.

    For each tracked channel, the decoded HOW TOW anchors the absolute SV
    time of one TLM preamble bit; the measured chip timeline carries it to
    ``sample_idx`` at 1.023 Mchip per SV second (IS-GPS-200: the code is
    generated at a fixed rate in SV time; Doppler only changes the
    *received* rate). Returns (observations, t_nom) where t_nom is the
    nominal receive time (second of week) the relative pseudoranges are
    referenced to; the nav solve estimates the true offset from it."""
    raw = []
    for ch in channels:
        frames = frames_by_prn[ch.prn]
        if not frames.tows:
            continue
        bit_off, tow = frames.tows[0]
        pre_period = ch.bit0_period + 20 * bit_off
        cp_pre = pre_period * float(CA_SEQ_LEN)
        cp_m = ch.chips_at(float(sample_idx))
        tau = (tow * 6.0 - 6.0) + (cp_m - cp_pre) / CHIP_RATE
        raw.append((ch.prn, tau))
    if not raw:
        raise RuntimeError(
            "no channel decoded a TOW (stream too short for frame sync?)"
        )
    # Nominal receive time: mean flight time is ~76 ms (GPS MEO).
    t_nom = max(t for _, t in raw) + 0.076
    obs = [
        Observation(prn, tau, SPEED_OF_LIGHT * (t_nom - tau))
        for prn, tau in raw
    ]
    return obs, t_nom


@dataclass
class Fix:
    xyz: np.ndarray  # ECEF solution [m]
    llh: np.ndarray  # lat/lon [rad], height [m]
    clock_bias_m: float  # receiver clock bias [m]
    t_rx: float  # solved receive time (second of week)
    nsats: int
    residual_rms_m: float
    prns: list
    vel: np.ndarray | None = None  # ECEF velocity [m/s] (velocity_solve)
    clock_drift_mps: float | None = None


def pvt_solve(
    obs: list[Observation],
    eph: EphemerisSet,
    iono: IonoUtc,
    t_nom: float,
    iterations: int = 10,
    raim: bool = True,
) -> Fix:
    """Navigation solution with RAIM-style outlier rejection.

    Iterative leave-one-out: drop the satellite whose removal most
    improves the residual RMS, while the improvement is decisive (a
    single large error smears across all residuals in the full solve, so
    thresholding the full-solve residuals would mask it). Keeps >= 5."""
    fix, resid = _pvt_solve_once(obs, eph, iono, t_nom, iterations)

    def rms(r):
        return float(np.sqrt((r**2).mean()))

    while raim and len(obs) > 5:
        trials = [
            _pvt_solve_once(
                obs[:i] + obs[i + 1 :], eph, iono, t_nom, iterations
            )
            for i in range(len(obs))
        ]
        best = int(np.argmin([rms(r) for _, r in trials]))
        if rms(resid) <= max(0.5, 2.5 * rms(trials[best][1])):
            break
        obs = obs[:best] + obs[best + 1 :]
        fix, resid = trials[best]
    return fix


def _pvt_solve_once(
    obs: list[Observation],
    eph: EphemerisSet,
    iono: IonoUtc,
    t_nom: float,
    iterations: int = 10,
) -> tuple[Fix, np.ndarray]:
    """Gauss-Newton navigation solution (4 unknowns: x, y, z, c*dt).

    Mirrors the simulator's observation model in reverse: satellite
    positions at measured transmit times, Sagnac rotation over the flight
    time (gps.c:1995-1998), SV clock + relativistic - tgd correction
    (gps.c:559,607) and Klobuchar iono (gps.c:1893-1964) from *decoded*
    parameters only."""
    if len(obs) < 4:
        raise ValueError(f"need >= 4 satellites, have {len(obs)}")
    svs = np.array([o.prn - 1 for o in obs])
    taus = np.array([o.tau_sv for o in obs])
    pr_rel = np.array([o.pr_rel for o in obs])

    pos_tx, _, clk = _satpos_gps(eph, taus, svs)
    # Pseudoranges corrected for the SV clock (receiver-side standard).
    pr = pr_rel + SPEED_OF_LIGHT * clk[:, 0]

    p = np.zeros(3)
    b = 0.0
    resid = np.zeros(len(obs))
    for _ in range(iterations):
        tof = (pr - b) / SPEED_OF_LIGHT
        xrot = pos_tx[:, 0] + pos_tx[:, 1] * OMEGA_EARTH * tof
        yrot = pos_tx[:, 1] - pos_tx[:, 0] * OMEGA_EARTH * tof
        sat = np.stack([xrot, yrot, pos_tx[:, 2]], axis=-1)

        los = sat - p
        rho = np.sqrt((los * los).sum(axis=-1))
        unit = los / rho[:, None]

        iono_m = np.zeros(len(obs))
        if iono.enable and iono.vflg and np.linalg.norm(p) > 6.0e6:
            llh = xyz2llh(p)
            tmat = ltcmat(llh)
            neu = ecef2neu(los, tmat)
            azel = neu2azel(neu)
            iono_m = ionospheric_delay(
                iono, t_nom - b / SPEED_OF_LIGHT, llh, azel
            )

        resid = pr - iono_m - (rho + b)
        A = np.concatenate([unit, -np.ones((len(obs), 1))], axis=1)
        dx, *_ = np.linalg.lstsq(A, -resid, rcond=None)
        p = p + dx[:3]
        b = b + dx[3]
        if np.linalg.norm(dx[:3]) < 1e-4:
            break

    fix = Fix(
        xyz=p,
        llh=xyz2llh(p),
        clock_bias_m=float(b),
        t_rx=t_nom - b / SPEED_OF_LIGHT,
        nsats=len(obs),
        residual_rms_m=float(np.sqrt((resid**2).mean())),
        prns=[o.prn for o in obs],
    )
    return fix, resid


def velocity_solve(
    fix: Fix,
    channels: list[TrackedChannel],
    obs: list[Observation],
    eph: EphemerisSet,
) -> Fix:
    """Receiver velocity + clock drift from tracked carrier Dopplers.

    Range-rate LSQ: -lambda_L1 * f_d = u . (v_sat - v_rx) + c*drift, with
    unit vectors from the position fix and satellite velocities from the
    ephemeris (the same model whose negative the simulator transmits:
    f_carr = -rhodot/lambda, gps.c:2042). Fills fix.vel/clock_drift_mps."""
    by_prn = {c.prn: c for c in channels}
    use = [o for o in obs if o.prn in fix.prns and o.prn in by_prn]
    if len(use) < 4:
        return fix
    svs = np.array([o.prn - 1 for o in use])
    taus = np.array([o.tau_sv for o in use])
    fds = np.array([by_prn[o.prn].doppler_hz for o in use])

    pos, vel, _ = _satpos_gps(eph, taus, svs)
    los = pos - fix.xyz
    u = los / np.linalg.norm(los, axis=-1)[:, None]

    # u . v_rx - c*drift = u . v_sat + lambda * f_d
    A = np.concatenate([u, -np.ones((len(use), 1))], axis=1)
    b = (u * vel).sum(axis=-1) + LAMBDA_L1 * fds
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    fix.vel = sol[:3]
    fix.clock_drift_mps = float(sol[3])
    return fix


# --------------------------------------------------------------------------
# End-to-end chain
# --------------------------------------------------------------------------


def receiver_fix(
    x: np.ndarray,
    sample_rate: float,
    week_hint: int,
    measure_at: int | None = None,
    min_snr: float = 12.0,
    max_channels: int | None = None,
    iono: IonoUtc | None = None,
) -> tuple[Fix, list[TrackedChannel], EphemerisSet, IonoUtc]:
    """Full receiver chain on a baseband stream → navigation fix.

    ``iono``: externally-provided Klobuchar parameters (e.g. from RINEX,
    the way a warm-started receiver uses cached iono data). When None —
    or when the provided set is invalid (``vflg`` false, e.g. a RINEX
    file without ION ALPHA/BETA headers) — the parameters are decoded
    over the air from subframe 4 page 18 instead, which only transmits
    once per 25-page almanac cycle (~12.5 min), so short captures of an
    iono-on scenario otherwise solve uncorrected (~5-15 m bias at L1)."""
    dets = acquire(x, sample_rate, snr_threshold=min_snr)
    if not dets:
        raise RuntimeError("no PRNs acquired")
    if max_channels is not None:
        dets = dets[:max_channels]  # acquire() sorts by SNR

    channels = []
    frames_by_prn = {}
    eph = EphemerisSet()
    for det in dets:
        ch = track(x, det, sample_rate)
        frames = decode_frames(ch.bits)
        if {1, 2, 3} <= set(frames.subframes) and frames.tows:
            decode_ephemeris(frames, ch.prn, week_hint, eph)
            channels.append(ch)
            frames_by_prn[ch.prn] = frames
    if len(channels) < 4:
        raise RuntimeError(
            f"only {len(channels)} channels decoded ephemeris; need 4"
        )
    eph.finalize()

    if iono is None or not iono.vflg:
        # No (valid) warm-start data: fall back to the over-the-air
        # page-18 decode rather than silently solving uncorrected.
        iono = IonoUtc()
        for frames in frames_by_prn.values():
            got = decode_iono_utc(frames, week_hint=week_hint)
            if got.vflg:
                iono = got
                break

    if measure_at is None:
        measure_at = (len(x) // channels[0].seg_len - 1) * channels[0].seg_len
    obs, t_nom = measure_pseudoranges(channels, frames_by_prn, measure_at)
    fix = pvt_solve(obs, eph, iono, t_nom)
    fix = velocity_solve(fix, channels, obs, eph)
    return fix, channels, eph, iono


def main(argv=None) -> int:
    import argparse

    from .core.constants import R2D

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iq_file")
    ap.add_argument("--bits", type=int, default=8, choices=(8, 16))
    ap.add_argument("--rate", type=float, default=3_000_000.0)
    ap.add_argument(
        "--week",
        type=int,
        default=2560,
        help="approximate current full GPS week, used only to resolve the "
        "broadcast 10-bit week's 1024-week rollover (any value within "
        "512 weeks of the truth works; default covers 2019-2038)",
    )
    ap.add_argument(
        "--nav-iono",
        metavar="rinex",
        help="warm-start Klobuchar parameters from this RINEX nav file "
        "(a short capture cannot decode page 18 over the air; without "
        "iono data an iono-on scenario solves with a ~5-15 m bias)",
    )
    args = ap.parse_args(argv)

    iono = None
    if args.nav_iono:
        import sys

        from .core.ephemeris import read_rinex_nav

        iono = read_rinex_nav(args.nav_iono).ionoutc
        if not iono.vflg:
            print(
                f"warning: {args.nav_iono} carries no ION ALPHA/BETA "
                "headers; falling back to over-the-air page-18 decode",
                file=sys.stderr,
            )
    x = load_iq(args.iq_file, args.bits)
    fix, channels, _, iono = receiver_fix(
        x, args.rate, week_hint=args.week, iono=iono
    )
    print(f"{len(channels)} channels tracked: {fix.prns}")
    print(f"iono applied: {iono.vflg}"
          + (" (warm start)" if args.nav_iono else ""))
    print(
        f"fix: lat {fix.llh[0] * R2D:.6f}  lon {fix.llh[1] * R2D:.6f}  "
        f"h {fix.llh[2]:.1f} m"
    )
    print(
        f"     ECEF [{fix.xyz[0]:.1f}, {fix.xyz[1]:.1f}, {fix.xyz[2]:.1f}] "
        f"clock bias {fix.clock_bias_m:.1f} m  "
        f"residual RMS {fix.residual_rms_m:.2f} m"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
