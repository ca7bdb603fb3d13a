"""Application orchestration: config → simulation → run (headless or TUI).

Re-design of the reference's main() lifecycle (gps-sim.c:267-418): build the
scenario, create the sink, run the generator, surface status — with
checkpointing, metrics and torch profiling the reference never had.
"""

from __future__ import annotations

import contextlib
import os
import sys

from .config import SimConfig
from .core.constants import R2D
from .io.sinks import make_configured_sink as _make_configured_sink
from .runner import run_simulation
from .scenario import Simulation


@contextlib.contextmanager
def _maybe_profile(profile_dir: str | None):
    """torch.profiler over the run (CPU, and the card when there is one);
    the trace lands in ``profile_dir/trace.json`` (chrome trace format)."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _verbose_block_hook(cfg: SimConfig, out=sys.stderr):
    """Per-30 s checkpoint, channel table print (reference
    gps.c:2911-2928) and metrics record."""
    from .tui import format_channel_rows, format_position

    state = {"saved_at": 0, "printed_at": 0, "metrics_at": 0}

    def hook(stats, sim, plan):
        # Act on every crossing of a 30 s boundary (robust to the batched
        # runner reporting several blocks per callback).
        if cfg.checkpoint_file and stats.blocks // 300 > state["saved_at"]:
            from .checkpoint import capture_state, write_state

            state["saved_at"] = stats.blocks // 300
            # Prefer the runner's drain-time snapshot: the pipelined
            # planner runs ahead of the written blocks.
            snap = getattr(sim, "consistent_snapshot", None)
            write_state(
                cfg.checkpoint_file,
                snap if snap is not None else capture_state(sim),
            )
        if cfg.verbose and stats.blocks // 300 > state["printed_at"]:
            state["printed_at"] = stats.blocks // 300
            print(
                f"[{stats.blocks * 0.1:8.1f} s] {format_position(sim)} "
                f"({stats.samples_per_second / 1e6:.2f} Msps)",
                file=out,
            )
            for row in format_channel_rows(sim):
                print(row, file=out)
        # One record per callback that crosses a 30 s boundary (drain
        # granularity: large dispatch windows report fewer, larger steps).
        if cfg.metrics_file and stats.blocks // 300 > state["metrics_at"]:
            state["metrics_at"] = stats.blocks // 300
            import json

            # Position/channels must match the blocks the record covers;
            # on the pipelined path the live sim has planned ahead, so use
            # the runner's drain-time snapshot when present.
            snap = getattr(sim, "consistent_snapshot", None)
            if snap is not None:
                from .core.frames import xyz2llh

                llh = xyz2llh(snap["xyz_prev"])
                prns = [int(p) for p in snap["ch_prn"] if p > 0]
            else:
                llh = sim.current_llh()
                prns = [ch.prn for ch in sim.channels.chan if ch.prn > 0]
            rec = {
                "signal_s": round(stats.blocks * 0.1, 1),
                "blocks": stats.blocks,
                "wall_s": round(stats.wall_seconds, 3),
                "msps": round(stats.samples_per_second / 1e6, 3),
                "realtime_x": round(stats.realtime_factor, 2),
                "retries": stats.retries,
                "lat": float(llh[0]) * R2D,
                "lon": float(llh[1]) * R2D,
                "height": float(llh[2]),
                "channels": prns,
            }
            with open(cfg.metrics_file, "a") as fp:
                fp.write(json.dumps(rec) + "\n")

    return hook


def run_app(cfg: SimConfig, sim: Simulation | None = None,
            use_tui: bool = False):
    """Run a scenario, under the curses dashboard when ``use_tui`` and
    stdout is a terminal, else headless; returns (exit code, RunStats).
    Under the TUI the RunStats are its worker's (``TuiApp.stats``)."""
    if sim is None:
        sim = Simulation(cfg)

    if cfg.verbose:
        llh = sim.current_llh()
        print(
            f"Start {sim.g0.week}:{sim.g0.sec:.1f}  "
            f"location {llh[0] * R2D:.6f},{llh[1] * R2D:.6f},{llh[2]:.1f}  "
            f"{sim.num_blocks} blocks @ {cfg.sample_rate / 1e6:.1f} Msps",
            file=sys.stderr,
        )

    sink = _make_configured_sink(cfg)

    rc = 0
    with _maybe_profile(cfg.profile_dir):
        if use_tui and sys.stdout.isatty():
            from .tui import TuiApp

            app = TuiApp(cfg, sim, sink)
            # Verbose output goes into the TUI status log — printing to
            # stderr would scribble over the active curses screen. The
            # run is on the TUI's worker thread: no signal handlers ('x'
            # stops it).
            rc = app.run(on_block=_verbose_block_hook(cfg, out=app.log))
            stats = app.stats
        else:
            # Clean shutdown on SIGINT/SIGTERM: finish the in-flight
            # window, drain the sink, write the final checkpoint (the
            # reference installs the same handlers, gps-sim.c:273-275).
            import signal

            stop_flag = {"stop": False}

            def _sig(signum, frame):
                if stop_flag["stop"]:
                    # Second signal: stop being graceful (a wedged device
                    # call must remain interruptible).
                    for s, h in prev.items():
                        signal.signal(s, h)
                    raise KeyboardInterrupt
                stop_flag["stop"] = True

            prev = {}
            for s in (signal.SIGINT, signal.SIGTERM):
                try:
                    prev[s] = signal.signal(s, _sig)
                except ValueError:  # not the main thread
                    pass
            try:
                stats = run_simulation(
                    cfg, sink=sink, sim=sim,
                    on_block=_verbose_block_hook(cfg),
                    stop=lambda: stop_flag["stop"],
                )
            finally:
                for s, h in prev.items():
                    signal.signal(s, h)
            if stop_flag["stop"]:
                rc = 130

    if stats is not None:
        _print_summary(cfg, sink, stats)
    if cfg.checkpoint_file:
        from .checkpoint import capture_state, write_state

        # On an interrupted pipelined run the planner may be ahead of the
        # written blocks; prefer the runner's last drain-time snapshot.
        snap = getattr(sim, "consistent_snapshot", None)
        write_state(
            cfg.checkpoint_file,
            snap if snap is not None else capture_state(sim),
        )
    return rc, stats


def _print_summary(cfg: SimConfig, sink, stats) -> None:
    print(
        f"done: {stats.blocks} blocks ({stats.blocks * 0.1:.1f} s of "
        f"signal) in {stats.wall_seconds:.2f} s wall "
        f"= {stats.samples_per_second / 1e6:.2f} Msps "
        f"(x{stats.realtime_factor:.1f} realtime)",
        file=sys.stderr,
    )
    if cfg.realtime:
        print(f"realtime: {stats.underruns} sink underruns, "
              f"{stats.failovers} failovers, {stats.failbacks} failbacks",
              file=sys.stderr)
    # A sink that counts underruns says directly whether it starved; its
    # wall time also streams out the FIFO's lead after the last block, so
    # its realtime factor sits just under 1 on a healthy run.
    counted = hasattr(sink, "underruns")
    if cfg.realtime and (stats.underruns if counted
                         else stats.realtime_factor < 1.0):
        print(
            "WARNING: output fell behind real time — a TX sink would "
            "underrun. Usual causes: a first-run kernel build, or a slow "
            "host<->device link.",
            file=sys.stderr,
        )
