"""Command-line entry point of the PyTorch/CUDA package.

Mirrors the reference's argp option surface (help.h:20-53, parse callbacks
gps-sim.c:35-177) and adds framework-specific execution options (synth
backend, torch device, sample rate, output path, checkpointing). Run as
``python -m gpssim_tpu_torch [options]``.

``--fleet roster.csv`` runs one scenario per roster row through one
batched pipeline (fleet.py). ``--realtime`` paces a run (or a fleet) at
the wall-clock rate under the realtime supervisor, with
``--realtime-policy`` choosing its response to a deficit. ``-i`` steers
the position live from the keyboard under the curses dashboard (``--tui``
shows the dashboard alone), ``-r hackrf`` and ``-r plutosdr`` transmit
through libhackrf and libiio, and ``-f`` downloads the hourly RINEX
navigation file before the run.
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

    # argp gives the reference --version/--usage for free (README usage
    # table); mirror them.
    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("--usage", action="help", help=argparse.SUPPRESS)
    p.add_argument("-?", action="help", help=argparse.SUPPRESS,
                   dest="help_alias")  # argp's -? (help.h usage table)
    # --- reference-parity options (help.h:20-53) ---
    p.add_argument("-e", "--nav-file", metavar="filename",
                   help="RINEX navigation file for GPS ephemeris (required)")
    p.add_argument("-f", "--use-ftp", action="store_true",
                   help="Pull current RINEX navigation file and almanac from "
                        "online sources")
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
                   help="Use interactive mode (live position control)")
    p.add_argument("-a", "--amplifier", action="store_true",
                   help="Enable TX amplifier (hardware sinks; default OFF)")
    p.add_argument("-g", "--gain", type=int, default=0, metavar="gain",
                   help="Initial TX gain, HackRF: 0-47 dB, Pluto: -80-0 dB "
                        "(default 0)")
    p.add_argument("-d", "--duration", type=float, metavar="seconds",
                   help="Duration in seconds")
    p.add_argument("-t", "--target", metavar="dist,bearing,height",
                   help="Target distance [m], bearing [deg] and height [m]")
    p.add_argument("-p", "--ppb", type=int, default=0, metavar="ppb",
                   help="Oscillator error in ppb (default 0)")
    p.add_argument("-3", "--rinex3", action="store_true",
                   help="Use RINEX v3 navigation data format")
    p.add_argument("-r", "--radio", default="none", metavar="name",
                   help="Sink/SDR device type (none, null, iqfile, tcp, "
                        "hackrf, plutosdr)")
    p.add_argument("--iq16", action="store_true",
                   help="IQ sample size 16 bit (default 8 bit)")
    p.add_argument("-U", "--uri", metavar="uri", help="ADALM-Pluto URI")
    p.add_argument("-N", "--network", default=None, metavar="host",
                   help="ADALM-Pluto network IP or hostname (default: local "
                        "USB context first, then pluto.local — "
                        "sdr_pluto.c:140-156)")
    p.add_argument("-m", "--motion", metavar="filename",
                   help="User motion file (dynamic mode): 10 Hz t,x,y,z ECEF "
                        "CSV, or an NMEA $--GGA log")
    p.add_argument("--disable-almanac", action="store_true",
                   help="Disable transmission of almanac information")
    p.add_argument("--station", metavar="id",
                   help="Ground-station ID for RINEX FTP download (random if "
                        "omitted)")
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
                   help="Pace generation at wall-clock rate (TX use case)")
    p.add_argument("--realtime-policy", default="failover",
                   choices=["failover", "fail", "warn"],
                   help="Response to a sustained sub-1x realtime deficit: "
                        "fail over to the native sequential engine "
                        "(default), raise an attributed error, or log and "
                        "keep counting")
    p.add_argument("--tui", action="store_true",
                   help="Curses dashboard (auto-enabled with --interactive "
                        "on a TTY)")
    p.add_argument("--fleet", metavar="roster.csv",
                   help="One scenario per roster row (lat,lon,height"
                        "[,out_file]) through one batched pipeline; member "
                        "files default to <out-file stem>_m<i><ext>, tcp "
                        "members stream to consecutive ports from "
                        "--tcp-addr; with --realtime the fleet paces as "
                        "one pipeline")
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
                   help="Write a torch.profiler trace of the run "
                        "(trace.json) into this directory, with the "
                        "pipeline's gpssim.<stage>#<window> spans")
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
    cfg.interactive = args.interactive
    cfg.backend = SynthBackend(args.backend)
    cfg.device = args.device
    cfg.carrier_mode = CarrierMode.INT_NCO if args.int_nco else CarrierMode.FLOAT
    cfg.parity_exact = not args.no_parity_exact
    cfg.realtime = args.realtime
    cfg.realtime_policy = args.realtime_policy
    cfg.out_file = args.out_file
    cfg.tcp_addr = args.tcp_addr
    cfg.tx_gain = args.gain
    cfg.tx_amplifier = args.amplifier
    cfg.use_ftp = args.use_ftp
    cfg.station_id = args.station
    cfg.pluto_uri = args.uri
    cfg.pluto_hostname = args.network
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
    # Hardware sinks force their sample format (sdr_hackrf.c:44-48 8-bit,
    # sdr_pluto.c:106-110 16-bit) and Pluto doubles baseband gain
    # (gps.c:2759-2763).
    if cfg.sink == "hackrf":
        cfg.sample_format = SampleFormat.SC08
    elif cfg.sink == "plutosdr":
        cfg.sample_format = SampleFormat.SC16
        cfg.pluto_gain_boost = True

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
        cfg.interactive = False  # motion file overrides (gps-sim.c:63-68)
    return cfg


def _print_fleet_summary(cfgs, stats) -> None:
    total_blocks = sum(st.blocks for st in stats)
    wall = max((st.wall_seconds for st in stats), default=0.0)
    for i, (c, st) in enumerate(zip(cfgs, stats)):
        target = (c.out_file if c.sink == "iqfile"
                  else c.tcp_addr if c.sink == "tcp" else c.sink)
        print(f"fleet member {i}: {st.blocks * 0.1:.1f} s of signal "
              f"→ {target}")
    if wall > 0:
        print(f"fleet aggregate: {total_blocks * 0.1 / wall:.1f}x "
              f"realtime across {len(cfgs)} members")


def run(argv: list[str] | None = None):
    """Parse ``argv`` and run; returns (exit code, RunStats or None), or
    (exit code, per-member RunStats list) for a fleet."""
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.radio == "none" and not args.resume:
        # The reference exits listing supported radios when none is chosen
        # (sdr.c:48-55). 'null' remains available as an explicit discard
        # sink for benchmarking.
        from .io.sinks import _REGISTRY

        print("No radio selected (-r/--radio); supported sinks are: "
              + ", ".join(sorted(set(_REGISTRY) - {"none"})),
              file=sys.stderr)
        return 1, None

    if args.fleet:
        if args.resume:
            parser.error(
                "--fleet cannot combine with --resume (a fleet checkpoint "
                "carries its roster: resume it with --resume alone)"
            )
        if args.metrics_file or args.profile_dir:
            # Refuse rather than silently skip: a fleet run the user
            # believes is metered or profiled must not lose that without
            # notice. (--checkpoint is supported: one file for the fleet.)
            parser.error(
                "--fleet does not support --metrics-file or --profile-dir; "
                "run members through run_simulation for metered or "
                "profiled runs"
            )

    if args.resume:
        from .checkpoint import (
            is_fleet_checkpoint, load_checkpoint, load_fleet_checkpoint,
        )

        # The checkpoint carries the scenario; only where to write the next
        # checkpoint and which torch device to run on come from the flags.
        if is_fleet_checkpoint(args.resume):
            # A fleet snapshot carries every member: resume the whole fleet.
            from .fleet import run_fleet

            cfgs, sims, _blocks = load_fleet_checkpoint(args.resume)
            for c in cfgs:
                c.device = args.device
                if args.checkpoint:
                    c.checkpoint_file = args.checkpoint
            stats = run_fleet(cfgs, sims=sims)
            _print_fleet_summary(cfgs, stats)
            return 0, stats
        cfg, sim = load_checkpoint(args.resume)
        cfg.device = args.device
        if args.checkpoint:
            cfg.checkpoint_file = args.checkpoint
    else:
        cfg = args_to_config(args)
        if cfg.use_ftp:
            from .io.fetch import FetchError, fetch_rinex

            try:
                cfg.nav_file = fetch_rinex(cfg.station_id, cfg.rinex_version)
            except FetchError as e:
                # Network failure is a reportable condition (reference
                # prints red status and exits, gps.c:2456-2466), not a
                # traceback.
                parser.error(f"RINEX download failed: {e}")
        if cfg.nav_file is None:
            parser.error("GPS ephemeris file is not specified (-e/--nav-file)")
        sim = None

    if args.fleet:
        if cfg.interactive or args.tui:
            parser.error(
                "--fleet cannot combine with --interactive/--tui "
                "(per-scenario features; run members through "
                "run_simulation)"
            )
        from .fleet import member_configs, parse_fleet_file, run_fleet

        try:
            cfgs = member_configs(cfg, parse_fleet_file(args.fleet))
            stats = run_fleet(cfgs)
        except ValueError as e:
            parser.error(str(e))
        _print_fleet_summary(cfgs, stats)
        return 0, stats

    from .app import run_app

    return run_app(cfg, sim=sim, use_tui=args.tui or cfg.interactive)


def main(argv: list[str] | None = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
