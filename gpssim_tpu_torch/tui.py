"""Curses dashboard + interactive key loop.

Re-design of the reference's ncurses GUI and main-thread key dispatch
(gui.c, gps-sim.c:332-414): one dashboard window showing scenario status,
live position/heading/speed, the channel table, and a scrolling status log,
with the reference's key bindings (gui.h:25-32):

  a / d   bearing -/+ 0.127 deg        w / s   vertical speed +/- 1 m/s
  e / q   speed +/- 0.01 m/s units     t / g   TX gain +/- 1 dB
  TAB     cycle dashboard/sky view     F1-F3   dashboard
  x       exit

The generator runs in a worker thread (the reference's GPS thread); the
curses loop owns the terminal and mutates the shared interactive state the
scenario reads each epoch — formalized here through Simulation.set_* hooks
instead of the reference's unsynchronized struct fields. The worker sets
up the device path's CUDA streams itself (``runner._run_batched``): stream
contexts are per thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .core.constants import R2D


class StatusLog:
    """Scrolling status log (reference gui_status_wprintw, gui.c:376-390)."""

    def __init__(self, maxlen: int = 200):
        self.lines: deque[str] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def write(self, msg: str) -> None:
        with self._lock:
            for line in str(msg).rstrip("\n").splitlines():
                self.lines.append(line)

    def tail(self, n: int) -> list[str]:
        with self._lock:
            return list(self.lines)[-n:]


def format_channel_rows(sim) -> list[str]:
    """Verbose channel table (reference gps.c:2677-2685 / 2911-2928)."""
    # The windowed planner defers channel write-back; pull it current so
    # the displayed az/el/rho match the last planned block.
    sync = getattr(sim, "_sync_channels", None)
    if sync is not None:
        sync()
    rows = []
    for i, ch in enumerate(sim.channels.chan):
        if ch.prn <= 0:
            continue
        az, el = ch.azel
        rows.append(
            f"  {i:2d}  PRN{ch.prn:3d}  az {az * R2D:6.1f}  el {el * R2D:5.1f}"
            f"  rho {ch.rho0_range:14.3f}  iono {ch.rho0_iono:7.3f}"
        )
    return rows


def format_sky_rows(sim) -> list[str]:
    """Per-PRN sky table — the reference's EPHEMERIS panel ('PRN  AZ
    ELEV  EPH   SIM', gui.c:203; the reference never populates its rows —
    this view fills them in): azimuth/elevation from the current
    position, broadcast-ephemeris validity, and whether the PRN is
    currently simulated on a channel."""
    from .core.orbits import check_sat_visibility

    eph = sim.nav.sets[sim.ieph]
    state, azel = check_sat_visibility(eph, sim.grx.sec, sim._xyz_prev)
    alloc = sim.channels.allocated_sat
    rows = []
    for sv in range(len(state)):
        if state[sv] < 0:  # no valid ephemeris
            rows.append(f"PRN{sv + 1:3d}      -      -    -    -")
            continue
        az, el = azel[sv, 0] * R2D, azel[sv, 1] * R2D
        rows.append(
            f"PRN{sv + 1:3d}  {az:5.1f}  {el:5.1f}    Y    "
            f"{'Y' if alloc[sv] >= 0 else '-'}"
        )
    return rows


def format_almanac_date(sim) -> str:
    """The LS_FIX 'Almanac date' field (reference gps.c:2652-2656): the
    time-of-almanac of the last valid SV, or the disabled notice."""
    alm = getattr(sim, "alm", None)
    toa = None
    if alm is not None and alm.valid:
        for a in alm.sv:
            if a.valid != 0:
                toa = a.toa  # last valid SV wins, like the reference loop
    if toa is None:
        return "Almanac date: Disabled or invalid."
    from .core.gpstime import gps2date

    t = gps2date(toa)
    return (
        f"Almanac date: {t.y:4d}/{t.m:02d}/{t.d:02d},"
        f"{t.hh:02d}:{t.mm:02d}:{t.sec:02.0f}"
    )


def format_position(sim) -> str:
    llh = sim.current_llh()
    return (
        f"Lat {llh[0] * R2D:11.6f}  Lon {llh[1] * R2D:11.6f}  "
        f"Hgt {llh[2]:8.1f} m"
    )


class TuiApp:
    """Dashboard over a running simulation."""

    def __init__(self, cfg, sim, sink):
        self.cfg = cfg
        self.sim = sim
        self.sink = sink
        self.log = StatusLog()
        self.stats = None
        self.stop_flag = threading.Event()
        self.gain = cfg.tx_gain
        # Reference target_t units: speed counts 0.01 m/s (gps-sim.c:386-393),
        # bearing in millidegrees.
        self._speed_units = 0.0
        self.show_help = False
        # 0 = dashboard, 1 = sky/ephemeris view. TAB cycles (the
        # reference's gui_toggle_current_panel, gps-sim.c:352-353);
        # F1-F3 return to the dashboard (its TRACK/LS_FIX/KF_FIX panels
        # are merged into the one dashboard here).
        self.view = 0

    # --- key handling (gps-sim.c:332-414) -----------------------------
    def handle_key(self, ch: int) -> None:
        ia = self.sim.interactive
        if self.show_help and ch not in (ord("x"), ord("X")):
            # Any key dismisses the popup (gps-sim.c:407-414).
            self.show_help = False
            return
        if ch in (ord("x"), ord("X")):
            self.stop_flag.set()
        elif ch in (ord("h"), ord("H"), ord("?"), ord("i"), ord("I")):
            self.show_help = True
        elif ch == 9:  # TAB: cycle panels (gps-sim.c:352-353)
            self.view = (self.view + 1) % 2
        elif ch in (265, 266, 267):  # F1/F2/F3 (gps-sim.c:355-361)
            self.view = 0
        elif ch == ord("a"):
            b = ia.bearing_millideg - 127.0
            if b < 0:
                b = 360000.0
            self.sim.set_motion(bearing_deg=b / 1000.0)
        elif ch == ord("d"):
            b = ia.bearing_millideg + 127.0
            if b > 360000:
                b = 0.0
            self.sim.set_motion(bearing_deg=b / 1000.0)
        elif ch == ord("w"):
            self.sim.set_motion(vertical_speed=ia.vertical_speed + 1)
        elif ch == ord("s"):
            self.sim.set_motion(vertical_speed=ia.vertical_speed - 1)
        elif ch == ord("e"):
            self._speed_units += 1.0
            self.sim.set_motion(velocity=self._speed_units / 100.0)
        elif ch == ord("q"):
            self._speed_units = max(0.0, self._speed_units - 1.0)
            self.sim.set_motion(velocity=self._speed_units / 100.0)
        elif ch == ord("t"):
            self.gain = self.sink.set_gain(self.gain + 1)
            self.log.write(f"Gain: {self.gain}dB")
        elif ch == ord("g"):
            self.gain = self.sink.set_gain(self.gain - 1)
            self.log.write(f"Gain: {self.gain}dB")

    # --- rendering ------------------------------------------------------
    def render(self, scr) -> None:
        import curses

        scr.erase()
        h, w = scr.getmaxyx()
        sim, ia = self.sim, self.sim.interactive

        def put(y, x, s, attr=0):
            # Clamp x too: addnstr past the window edge raises
            # curses.error on narrow terminals (e.g. the sky view's
            # second column at x=35).
            if 0 <= y < h and 0 <= x < w - 1:
                scr.addnstr(y, x, s, max(0, w - x - 1), attr)

        put(0, 1, "gpssim-tpu-torch — GPS L1 C/A signal simulator",
            curses.A_BOLD)
        st = self.stats
        if st is not None:
            put(1, 1,
                f"signal {st.blocks * 0.1:9.1f} s   wall {st.wall_seconds:8.1f} s"
                f"   {st.samples_per_second / 1e6:8.2f} Msps"
                f"   x{st.realtime_factor:7.1f} realtime")
        put(2, 1,
            f"backend {self.cfg.backend.value}   sink {self.sink.name}"
            f"   {self.cfg.sample_format.value}-bit"
            f"   gain {self.gain} dB")
        put(3, 1, format_almanac_date(sim))
        put(4, 1, format_position(sim), curses.A_BOLD)
        put(5, 1,
            f"heading {ia.bearing_millideg / 1000.0:7.3f} deg   "
            f"speed {ia.velocity * 3.6:6.2f} km/h   "
            f"vspeed {ia.vertical_speed:5.1f} m/s")
        if self.view == 1:
            # Sky/ephemeris view (reference EPHEMERIS panel) in 2 columns.
            put(7, 1, "PRN     az     el  eph  sim" + " " * 6
                + "PRN     az     el  eph  sim", curses.A_BOLD)
            sky = format_sky_rows(sim)
            half = (len(sky) + 1) // 2
            for k in range(half):
                put(8 + k, 1, sky[k])
                if half + k < len(sky):
                    put(8 + k, 35, sky[half + k])
            log_top = 9 + half
        else:
            put(7, 1, "ch  PRN   azimuth   elev      pseudorange        iono")
            rows = format_channel_rows(sim)
            for k, row in enumerate(rows):
                put(8 + k, 1, row)
            log_top = 9 + len(rows)
        put(log_top, 1, "-" * (w - 2))
        for k, line in enumerate(self.log.tail(h - log_top - 2)):
            put(log_top + 1 + k, 1, line)
        put(h - 1, 1,
            "[a/d] bearing  [w/s] vspeed  [e/q] speed  [t/g] gain  "
            "[TAB] sky  [h] help  [x] exit",
            curses.A_DIM)
        if self.show_help:
            lines = [
                "gpssim-tpu-torch — interactive controls",
                "",
                "  a / d   bearing -/+ 0.127 deg (wraps at 360)",
                "  w / s   vertical speed +/- 1 m/s",
                "  e / q   speed +/- 0.01 m/s units",
                "  t / g   TX gain +/- 1 dB (sink-clamped)",
                "  TAB     toggle sky/ephemeris view (F1-F3 back)",
                "  h/?/i   this help",
                "  x       exit",
                "",
                "any key to close",
            ]
            top = max(1, (h - len(lines)) // 2 - 1)
            left = max(2, (w - 44) // 2)
            for k, line in enumerate(lines):
                put(top + k, left, line.ljust(44), curses.A_REVERSE)
        scr.refresh()

    # --- main loop --------------------------------------------------------
    def run(self, on_block=None) -> int:
        """Run the scenario on the ``gps-gen`` thread under the curses
        dashboard; returns the exit code. ``self.stats`` then holds the
        run's RunStats (those of its last written block, or None, if the
        worker outlived the dashboard's 10 s join)."""
        import curses

        from .runner import run_simulation

        chained = on_block

        def on_block(stats, sim, plan):  # noqa: F811
            self.stats = stats
            if chained is not None:
                chained(stats, sim, plan)

        err: list[BaseException] = []

        def produce():
            try:
                self.stats = run_simulation(
                    self.cfg, sink=self.sink, sim=self.sim,
                    on_block=on_block, stop=self.stop_flag.is_set,
                )
            except BaseException as e:  # surfaced after curses teardown
                err.append(e)
                self.stop_flag.set()

        worker = threading.Thread(target=produce, name="gps-gen", daemon=True)

        def ui(scr):
            curses.curs_set(0)
            scr.nodelay(True)
            worker.start()
            while not self.stop_flag.is_set() and worker.is_alive():
                ch = scr.getch()
                while ch != -1:
                    self.handle_key(ch)
                    ch = scr.getch()
                self.render(scr)
                time.sleep(0.1)  # reference gui_getch timeout (gui.c:326)
            self.stop_flag.set()
            worker.join(timeout=10)

        curses.wrapper(ui)
        if err:
            raise err[0]
        return 0
