"""Device-rate stream verification: open-loop matched filter at truth.

The counterpart of the JAX package's ``qa.py``. The full software receiver
(receiver.py) closes the QA loop blind: it needs nothing but the bytes,
and takes tracking-loop time to do it. This module is the fast companion
for the cases where the truth trajectory is known (it came from this
simulator): correlate every channel of every block against its own plan's
code/carrier replica, per millisecond, with torch ops on the device. Each
active channel's per-ms coherent correlation magnitude must equal gain·A
per sample (the stream is gain·A·cis θ and the conjugate replica includes
code, carrier AND data bits); anything that corrupts the stream (dropped
blocks, byte damage, wrong phases, swapped channels, a broken kernel)
collapses the ratio.

This is a detector, not parity machinery: replicas run in float32 on the
device (real arithmetic, no complex and no TF32); the bit-exact contracts
live in ops/ and the tests.

    python -m gpssim_tpu_torch.qa capture.bin -e brdc.22n -l ... -d 10
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from .config import SimConfig
from .core.constants import COS_TABLE_512, SIN_TABLE_512
from .ops.synth_numpy import carrier_fraction, chips_and_bits
from .scenario import Simulation

MS_PER_BLOCK = 100  # 0.1 s block = 100 coherent 1 ms windows

# Effective sinusoid amplitude of the integer carrier tables (their
# fundamental Fourier coefficient): the synthesized sample is
# gain·table[..]·cis θ, so the conjugate-replica coherent
# correlation measures gain·_TABLE_AMP per sample.
_TABLE_AMP = float(abs(
    ((np.asarray(COS_TABLE_512, dtype=np.float64)
      + 1j * np.asarray(SIN_TABLE_512, dtype=np.float64))
     * np.exp(-2j * np.pi * np.arange(512) / 512.0)).mean()
))

# Worst-case normalized cross-correlation between two C/A Gold codes over
# one full period (the three-valued IS-GPS-200 spectrum: the largest
# magnitude is 65/1023 at zero Doppler difference). A channel's per-ms
# matched filter sees every OTHER active channel through this bound, so
# the worst-millisecond floor must budget for it — with ~8 near-equal-gain
# channels the stacked interference alone legitimately reaches ~0.45 of
# the wanted peak in an unlucky millisecond (observed 0.478 residual
# ratio on a clean, oracle-bit-exact stream).
_CA_CROSS_MAX = 65.0 / 1023.0


def min_ratio_floor(gains, active, c, tolerance: float = 0.25) -> float:
    """Worst-single-millisecond acceptance floor for channel ``c`` of a
    block: 1 - 2*tolerance minus the stacked worst-case Gold cross-
    correlation leakage of every other active channel, never below 0.1
    (zeroed/garbage/mis-phased samples collapse the coherent ratio to
    ~0 and still fail outright)."""
    interf = _CA_CROSS_MAX * float(
        sum(gains[j] for j in range(len(gains)) if active[j] and j != c)
    ) / gains[c]
    return max(1.0 - 2.0 * tolerance - interf, 0.1)


@dataclass
class ChannelReport:
    prn: int
    mean_ratio: float  # measured |corr| / predicted gain·A, over all ms
    min_ratio: float   # worst single millisecond
    ok: bool


@dataclass
class StreamReport:
    blocks: int
    channels: list[ChannelReport]
    ok: bool


def correlate(iq_re, iq_im, chips, frac, ms_per_block: int):
    """|per-ms coherent correlation| on one device, float32 throughout.

    iq_re, iq_im: f32 (B, N); chips: int16 (B, C, N) chips times data
    bits; frac: f32 (B, C, N) carrier phase in cycles. Returns f32
    (B, C, ms_per_block). Wipes carrier and code, iq · ca·db · e^{-j2πφ},
    with the replica's real and imaginary planes apart, then sums each
    millisecond's products. One block's (C, N) intermediates live at a
    time."""
    import torch

    B, C, N = chips.shape
    ms_len = N // ms_per_block
    used = ms_len * ms_per_block
    out = torch.empty((B, C, ms_per_block), dtype=torch.float32,
                      device=chips.device)
    for b in range(B):
        ang = frac[b] * (-2.0 * math.pi)
        ch = chips[b].to(torch.float32)
        rep_re = ch * torch.cos(ang)
        rep_im = ch * torch.sin(ang)
        x_re, x_im = iq_re[b], iq_im[b]
        pr = x_re * rep_re - x_im * rep_im
        pi = x_re * rep_im + x_im * rep_re
        re = pr[:, :used].reshape(C, ms_per_block, ms_len).sum(-1)
        im = pi[:, :used].reshape(C, ms_per_block, ms_len).sum(-1)
        out[b] = torch.sqrt(re * re + im * im) / ms_len
    return out


def _block_correlations(plans, iq, num_samples, int_nco=False, *, device):
    """|per-ms coherent correlation| for every (block, channel, ms).

    iq: complex64[B, N]. Returns (mags f32[B, C, MS], gains f64[B, C],
    active bool[B, C], prn i64[B, C]). Replica trajectories come from the
    SAME closed-form helpers the synthesizer uses
    (ops/synth_numpy.chips_and_bits / carrier_fraction), so the verifier
    cannot drift from the thing it verifies. The replicas are built on
    the host; they and the capture cross to ``device`` once per call.
    """
    import torch

    B = len(plans)
    C = plans[0].num_channels

    chips = np.zeros((B, C, num_samples), dtype=np.int16)
    carr_frac = np.zeros((B, C, num_samples), dtype=np.float32)
    gains = np.zeros((B, C))
    active = np.zeros((B, C), dtype=bool)
    prn = np.zeros((B, C), dtype=np.int64)
    for b, plan in enumerate(plans):
        for c in range(C):
            if not plan.active[c]:
                continue
            code_ca, data_bit = chips_and_bits(plan, c)
            chips[b, c] = (code_ca * data_bit).astype(np.int16)
            carr_frac[b, c] = carrier_fraction(
                plan, c, int_nco
            ).astype(np.float32)
            gains[b, c] = plan.gain[c]
            active[b, c] = True
            prn[b, c] = plan.prn[c]

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    mags = correlate(on(iq.real), on(iq.imag), on(chips), on(carr_frac),
                     MS_PER_BLOCK).cpu().numpy()
    return mags, gains, active, prn


def verify_stream(
    path: str,
    cfg: SimConfig,
    max_blocks: int | None = None,
    tolerance: float = 0.25,
    chunk_blocks: int = 10,
) -> StreamReport:
    """Verify an IQ capture against the scenario that should have produced
    it. ``cfg`` is the scenario config (the file's bits/rate come from
    it; the correlations run on ``cfg.device``, and ``cuda`` without a card
    raises); per-channel coherent power must be within ``tolerance`` of the
    plan-predicted gain·A in EVERY millisecond. The capture is processed
    in ``chunk_blocks`` batches, so memory stays bounded for hour-scale
    files. Raises if the scenario cannot cover the whole capture (use
    ``max_blocks`` to verify a prefix deliberately) or if no channel was
    ever active — a verifier must never pass vacuously."""
    from .config import CarrierMode
    from .runner import resolve_device

    device = resolve_device(cfg)
    bits = cfg.sample_format.value
    dtype = np.int8 if bits == 8 else np.int16
    num_samples = cfg.samples_per_epoch
    block_items = 2 * num_samples
    total_blocks = os.path.getsize(path) // (block_items * dtype().nbytes)
    if total_blocks == 0:
        raise ValueError(f"{path}: no complete blocks")
    n_blocks = total_blocks
    if max_blocks is not None:
        n_blocks = min(n_blocks, max_blocks)

    sim = Simulation(cfg)
    int_nco = cfg.carrier_mode is CarrierMode.INT_NCO
    scale = 16.0 if bits == 8 else 1.0  # 8-bit output is accumulator >> 4

    reports: dict[int, list[tuple[float, float]]] = {}
    verified = 0
    with open(path, "rb") as fp:
        while verified < n_blocks:
            want = min(chunk_blocks, n_blocks - verified)
            plans = []
            for _ in range(want):
                plan = sim.step()
                if plan is None:
                    break
                plans.append(plan)
            if len(plans) < want and verified + len(plans) < n_blocks:
                raise ValueError(
                    f"{path} has {n_blocks} blocks but the scenario only "
                    f"produces {verified + len(plans)} — a verifier must "
                    "not pass unchecked data; set the scenario duration "
                    "to cover the capture (or pass max_blocks to verify "
                    "a prefix deliberately)"
                )
            if not plans:
                break
            raw = np.frombuffer(
                fp.read(len(plans) * block_items * dtype().nbytes),
                dtype=dtype,
            ).astype(np.float32) * scale
            iq = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
            iq = iq.reshape(len(plans), num_samples)

            mags, gains, active, prn = _block_correlations(
                plans, iq, num_samples, int_nco=int_nco, device=device
            )
            for b in range(len(plans)):
                for c in range(mags.shape[1]):
                    if not active[b, c]:
                        continue
                    # The stream is complex (I + jQ = gain·A·cis θ), so
                    # the conjugate-replica correlation measures the FULL
                    # amplitude.
                    pred = gains[b, c] * _TABLE_AMP
                    r = mags[b, c] / pred
                    floor = min_ratio_floor(
                        gains[b], active[b], c, tolerance
                    )
                    reports.setdefault(int(prn[b, c]), []).append(
                        (float(np.mean(r)), float(np.min(r)),
                         bool(np.min(r) > floor))
                    )
            verified += len(plans)

    if not reports:
        raise ValueError(
            "no active channels in the verified span — nothing was "
            "actually checked (wrong nav file / start time?)"
        )

    channels = []
    all_ok = True
    for p, vals in sorted(reports.items()):
        mean_r = float(np.mean([v[0] for v in vals]))
        min_r = float(np.min([v[1] for v in vals]))
        # The worst-millisecond floor budgets for cross-channel Gold-code
        # interference per block (min_ratio_floor): with many near-equal-
        # gain channels a clean, bit-exact stream legitimately dips ~0.45
        # below 1.0 in an unlucky millisecond. The mean check (averaged
        # over every ms, where the leakage integrates toward zero) keeps
        # its tight ±tolerance either way, so corruption — zeroed or
        # garbage samples, wrong phases — still collapses the metric far
        # below both bounds.
        ok = abs(mean_r - 1.0) < tolerance and all(v[2] for v in vals)
        all_ok = all_ok and ok
        channels.append(ChannelReport(p, mean_r, min_r, ok))
    return StreamReport(blocks=verified, channels=channels, ok=all_ok)


def main(argv=None) -> int:
    """CLI: verify a capture against the scenario flags that produced it.

    Takes the full simulator option surface (same parser as the
    simulator, ``--device`` included) plus the capture path:
    ``python -m gpssim_tpu_torch.qa capture.bin -e brdc.22n -l ... -d 10``
    """
    from .cli import args_to_config, build_parser

    p = build_parser()
    p.prog = "gpssim-torch-qa"
    p.add_argument("capture", help="IQ capture file to verify")
    p.add_argument("--qa-tolerance", type=float, default=0.25,
                   metavar="frac",
                   help="Allowed deviation of coherent power from the "
                        "plan prediction (default 0.25)")
    p.add_argument("--qa-max-blocks", type=int, default=None, metavar="n",
                   help="Verify only the first n blocks")
    args = p.parse_args(argv)
    for flag in ("use_ftp", "resume", "fleet", "tui", "interactive",
                 "realtime"):
        if getattr(args, flag, None):
            p.error(f"--{flag.replace('_', '-')} is a simulator option; "
                    "the verifier replays the scenario from the flags "
                    "and needs an explicit -e/--nav-file")
    cfg = args_to_config(args)
    if cfg.nav_file is None:
        p.error("GPS ephemeris file is not specified (-e/--nav-file)")
    rep = verify_stream(args.capture, cfg, max_blocks=args.qa_max_blocks,
                        tolerance=args.qa_tolerance)
    for ch in rep.channels:
        print(f"PRN{ch.prn:2d}: power ratio mean {ch.mean_ratio:.3f} "
              f"min {ch.min_ratio:.3f} "
              f"[{'OK' if ch.ok else 'FAIL'}]")
    print(f"{rep.blocks} blocks: {'VERIFIED' if rep.ok else 'FAILED'}")
    return 0 if rep.ok else 1


if __name__ == "__main__":  # pragma: no cover
    import sys as _sys

    _sys.exit(main())
