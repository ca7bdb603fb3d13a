"""Command-line entry point of the PyTorch/CUDA package.

Mirrors the reference's argp option surface (help.h:20-53, parse callbacks
gps-sim.c:35-177) and adds framework-specific execution options (synth
backend, torch device, sample rate, output path, checkpointing). Run as
``python -m gpssim_tpu_torch [options]``.

Realtime pacing, interactive control, the curses dashboard, fleets and
the RINEX/almanac download are not ported yet: their flags raise
``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import math
import sys
import time as _time

from .config import (
    CarrierMode,
    LocationConfig,
    SampleFormat,
    SimConfig,
    SynthBackend,
    TargetConfig,
)
from .core.constants import USER_MOTION_SIZE
from .core.gpstime import DateTime

#: sinks that drive SDR hardware through their C libraries (not ported yet)
_HARDWARE_SINKS = ("hackrf", "plutosdr")


def _parse_start(arg: str) -> tuple[DateTime, bool]:
    """'now' or 'YYYY/MM/DD,hh:mm:ss' → (DateTime, time_overwrite).

    Validation bounds match the reference (gps-sim.c:106-114)."""
    if arg == "now":
        gmt = _time.gmtime()
        return (
            DateTime(
                gmt.tm_year, gmt.tm_mon, gmt.tm_mday,
                gmt.tm_hour, gmt.tm_min, float(gmt.tm_sec),
            ),
            True,
        )
    try:
        date_s, time_s = arg.split(",")
        y, m, d = (int(v) for v in date_s.split("/"))
        hh, mm, sec_s = time_s.split(":")
        dt = DateTime(y, m, d, int(hh), int(mm), float(sec_s))
    except ValueError:
        raise SystemExit(
            f"ERROR: invalid date/time {arg!r}; expected "
            "YYYY/MM/DD,hh:mm:ss or 'now'"
        ) from None
    if (
        dt.y <= 1980 or not 1 <= dt.m <= 12 or not 1 <= dt.d <= 31
        or not 0 <= dt.hh <= 23 or not 0 <= dt.mm <= 59
        or not 0.0 <= dt.sec < 60.0
    ):
        raise SystemExit("ERROR: Invalid date and time.")
    return dt, False


def _parse_triple(arg: str, what: str) -> tuple[float, float, float]:
    try:
        a, b, c = (float(v) for v in arg.split(","))
        return a, b, c
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid {what} {arg!r}; expected three comma-separated numbers"
        ) from None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpssim-tpu-torch",
        description=(
            "GPS L1 C/A signal simulator on PyTorch and CUDA: generates an "
            "IQ data stream from RINEX broadcast ephemerides."
        ),
    )
    from . import __version__

    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {__version__}")
    # --- reference-parity options (help.h:20-53) ---
    p.add_argument("-e", "--nav-file", metavar="filename",
                   help="RINEX navigation file for GPS ephemeris (required)")
    p.add_argument("-f", "--use-ftp", action="store_true",
                   help="Download the RINEX file and almanac (not ported)")
    p.add_argument("-l", "--geo-loc", metavar="lat,lon,height",
                   help="Latitude, Longitude, Height (static mode), e.g. "
                        "35.681298,139.766247,10.0")
    p.add_argument("-s", "--start", metavar="date,time",
                   help="Scenario start time YYYY/MM/DD,hh:mm:ss "
                        "('now' for actual time)")
    p.add_argument("-I", "--disable-iono", action="store_true",
                   help="Disable ionospheric delay for spacecraft scenario")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Show verbose output and details about simulated "
                        "channels")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="Interactive mode (not ported)")
    p.add_argument("-d", "--duration", type=float, metavar="seconds",
                   help="Duration in seconds")
    p.add_argument("-t", "--target", metavar="dist,bearing,height",
                   help="Target distance [m], bearing [deg] and height [m]")
    p.add_argument("-p", "--ppb", type=int, default=0, metavar="ppb",
                   help="Oscillator error in ppb (default 0)")
    p.add_argument("-3", "--rinex3", action="store_true",
                   help="Use RINEX v3 navigation data format")
    p.add_argument("-r", "--radio", default="none", metavar="name",
                   help="Sink type (none, null, iqfile, tcp)")
    p.add_argument("--iq16", action="store_true",
                   help="IQ sample size 16 bit (default 8 bit)")
    p.add_argument("-m", "--motion", metavar="filename",
                   help="User motion file (dynamic mode): 10 Hz t,x,y,z ECEF "
                        "CSV, or an NMEA $--GGA log")
    p.add_argument("--disable-almanac", action="store_true",
                   help="Disable transmission of almanac information")
    # --- framework options ---
    p.add_argument("--backend", choices=[b.value for b in SynthBackend],
                   default=SynthBackend.CUDA.value,
                   help="Synthesis backend (default cuda: the hand-written "
                        "kernel; torch: its plain PyTorch version)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Torch device for the cuda/torch backends (default "
                        "cuda; without a card it raises)")
    p.add_argument("--sample-rate", type=int, default=None, metavar="sps",
                   help="Output sample rate (default 3000000; any rate down "
                        "to ~1.03 Msps)")
    p.add_argument("--tcp-addr", default="127.0.0.1:4729", metavar="host:port",
                   help="destination for the tcp streaming radio (-r tcp)")
    p.add_argument("--out-file", default="iqdata.bin", metavar="path",
                   help="Output path for the iqfile sink (default iqdata.bin)")
    p.add_argument("--int-nco", action="store_true",
                   help="Integer-NCO carrier phase (reference's "
                        "non-FLOAT_CARR_PHASE mode)")
    p.add_argument("--no-parity-exact", action="store_true",
                   help="Disable reference-quirk emulation (e.g. channel "
                        "reallocation at the initial position)")
    p.add_argument("--dispatch-blocks", type=int, default=None, metavar="n",
                   help="Blocks per kernel launch on the cuda/torch path "
                        "(default 25)")
    p.add_argument("--realtime", action="store_true",
                   help="Pace generation at wall-clock rate (not ported)")
    p.add_argument("--tui", action="store_true",
                   help="Curses dashboard (not ported)")
    p.add_argument("--fleet", metavar="roster.csv",
                   help="One scenario per roster row (not ported)")
    p.add_argument("--almanac-file", metavar="path",
                   help="SEM almanac file (default: almanac.sem when almanac "
                        "enabled)")
    p.add_argument("--checkpoint", metavar="path",
                   help="Write a resumable state snapshot every 30 s of "
                        "signal")
    p.add_argument("--resume", metavar="path",
                   help="Resume a scenario from a snapshot written by "
                        "--checkpoint (of this package or of gpssim_tpu)")
    p.add_argument("--profile-dir", metavar="path",
                   help="Write a torch.profiler trace of the run into this "
                        "directory")
    p.add_argument("--metrics-file", metavar="path",
                   help="Append a JSONL metrics record (throughput, "
                        "position, channels) at each 30 s-of-signal "
                        "boundary crossing")
    p.add_argument("--noise-std", type=float, default=0.0, metavar="lsb",
                   help="Add deterministic AWGN with this std (output LSB "
                        "units); 0 (default) keeps the bit-exact clean signal")
    p.add_argument("--noise-seed", type=int, default=0, metavar="n",
                   help="Seed for --noise-std")
    return p


def _refuse_unported(args: argparse.Namespace) -> None:
    unported = [
        flag for flag, on in (
            ("--realtime", args.realtime), ("-i/--interactive",
                                            args.interactive),
            ("--tui", args.tui), ("--fleet", args.fleet),
            ("-f/--use-ftp", args.use_ftp),
            ("-r " + args.radio, args.radio in _HARDWARE_SINKS),
        ) if on
    ]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported to the PyTorch/CUDA package "
            "yet; see ROADMAP.md"
        )


def args_to_config(args: argparse.Namespace) -> SimConfig:
    """Translate parsed args into a SimConfig, applying reference semantics."""
    cfg = SimConfig()
    cfg.nav_file = args.nav_file
    cfg.rinex_version = 3 if args.rinex3 else 2
    cfg.verbose = args.verbose
    cfg.ionosphere_enable = not args.disable_iono
    cfg.almanac_enable = not args.disable_almanac
    cfg.almanac_file = args.almanac_file
    cfg.ppb = args.ppb
    if not math.isfinite(args.noise_std) or args.noise_std < 0:
        raise SystemExit("ERROR: --noise-std must be a finite value >= 0")
    cfg.noise_std_lsb = args.noise_std
    cfg.noise_seed = args.noise_seed
    cfg.backend = SynthBackend(args.backend)
    cfg.device = args.device
    cfg.carrier_mode = CarrierMode.INT_NCO if args.int_nco else CarrierMode.FLOAT
    cfg.parity_exact = not args.no_parity_exact
    cfg.out_file = args.out_file
    cfg.tcp_addr = args.tcp_addr
    cfg.checkpoint_file = args.checkpoint
    cfg.profile_dir = args.profile_dir
    cfg.metrics_file = args.metrics_file
    if args.dispatch_blocks is not None:
        cfg.dispatch_blocks = args.dispatch_blocks
    if args.sample_rate is not None:
        cfg.sample_rate = args.sample_rate
    if args.iq16:
        cfg.sample_format = SampleFormat.SC16
    cfg.sink = args.radio

    if args.geo_loc:
        lat, lon, height = _parse_triple(args.geo_loc, "location")
        cfg.location = LocationConfig(lat, lon, height)
    else:
        # Reference default location is 0,0,0 (gps-sim.c:193-195).
        cfg.location = LocationConfig(0.0, 0.0, 0.0)
    if args.target:
        dist, bearing, height = _parse_triple(args.target, "target")
        # Bearing stored in millidegrees exactly as the reference does
        # (gps-sim.c:148).
        cfg.target = TargetConfig(dist, bearing * 1000.0, height, valid=True)
    if args.start:
        cfg.start, cfg.time_overwrite = _parse_start(args.start)
    if args.duration is not None:
        if args.duration < 0.0 or args.duration > USER_MOTION_SIZE / 10.0:
            raise SystemExit("ERROR: Invalid duration.")
        # epochs = round(seconds * 10) (gps-sim.c:131-141)
        cfg.duration_sec = int(args.duration * 10.0 + 0.5) / 10.0
    else:
        # Reference default runs the full motion buffer: 24 h
        # (gps-sim.c:190, USER_MOTION_SIZE epochs).
        cfg.duration_sec = USER_MOTION_SIZE / 10.0
    if args.motion:
        cfg.motion_file = args.motion
    return cfg


def run(argv: list[str] | None = None):
    """Parse ``argv`` and run; returns (exit code, RunStats or None)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    _refuse_unported(args)

    if args.radio == "none" and not args.resume:
        # The reference exits listing supported radios when none is chosen
        # (sdr.c:48-55).
        print("No radio selected (-r/--radio); supported sinks are: "
              "iqfile, null, tcp", file=sys.stderr)
        return 1, None

    if args.resume:
        from .checkpoint import load_checkpoint

        # The checkpoint carries the scenario; only where to write the next
        # checkpoint and which torch device to run on come from the flags.
        cfg, sim = load_checkpoint(args.resume)
        cfg.device = args.device
        if args.checkpoint:
            cfg.checkpoint_file = args.checkpoint
    else:
        cfg = args_to_config(args)
        if cfg.nav_file is None:
            parser.error("GPS ephemeris file is not specified (-e/--nav-file)")
        sim = None

    from .app import run_app

    return run_app(cfg, sim=sim)


def main(argv: list[str] | None = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
