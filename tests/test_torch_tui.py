"""The PyTorch/CUDA package's TUI against the JAX package's.

The key map (gps-sim.c:332-414) runs through both packages' ``TuiApp`` on
the same scenario: the interactive state, the gain, the view and the text
they leave must agree, and match the reference's steps (bearing 127
millideg with wrap, vertical speed ±1 m/s, speed in 0.01 m/s units clamped
at 0, gain through the sink's clamp). The helpers' text agrees line for
line. Then the port's CLI runs under a real pseudo-terminal.
"""

import os
import pty
import select
import subprocess
import sys
import time

import numpy as np
import pytest

from gpssim_tpu import tui as jtui
from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.config import SynthBackend as JSynthBackend
from gpssim_tpu.core.almanac import read_sem_almanac as jread_sem_almanac
from gpssim_tpu.io import sinks as jsinks
from gpssim_tpu.scenario import Simulation as JSimulation
from gpssim_tpu_torch import tui
from gpssim_tpu_torch.config import SimConfig, SynthBackend
from gpssim_tpu_torch.core.almanac import read_sem_almanac
from gpssim_tpu_torch.io import sinks
from gpssim_tpu_torch.scenario import Simulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def apps(fixtures_dir):
    """(port, JAX) TuiApps on the same interactive scenario, each over a
    HackRF sink with no device (its gain clamp alone)."""
    kw = dict(nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=0.5,
              almanac_enable=False, interactive=True, tx_gain=46)
    cfg = SimConfig(**kw, backend=SynthBackend.NUMPY)
    jcfg = JSimConfig(**kw, backend=JSynthBackend.NUMPY)
    return (tui.TuiApp(cfg, Simulation(cfg), sinks.HackRfSink()),
            jtui.TuiApp(jcfg, JSimulation(jcfg), jsinks.HackRfSink()))


def state(app) -> dict:
    ia = app.sim.interactive
    return dict(bearing=ia.bearing_millideg, velocity=ia.velocity,
                vspeed=ia.vertical_speed, gain=app.gain,
                help=app.show_help, view=app.view,
                stop=app.stop_flag.is_set(), log=app.log.tail(100))


def press(app, keys) -> list:
    """Press ``keys`` (characters or curses key codes); the state after
    each."""
    out = []
    for k in keys:
        app.handle_key(ord(k) if isinstance(k, str) else k)
        out.append(state(app))
    return out


#: (keys, {step: expected subset of the state after that key})
KEY_CASES = {
    # below 0 wraps to 360000, above 360000 to 0 (gps-sim.c:365-368)
    "bearing_wrap": ("daad", {0: dict(bearing=127.0), 1: dict(bearing=0.0),
                              2: dict(bearing=360000.0),
                              3: dict(bearing=0.0)}),
    # speed/100 (gps-sim.c:386-393), clamped at 0
    "speed_units_clamp": ("eeqqq", {1: dict(velocity=0.02),
                                    4: dict(velocity=0.0)}),
    "vertical_speed": ("wws", {2: dict(vspeed=1.0)}),
    # HackRF 0-47 dB (sdr_hackrf.h:19-20), logged
    "gain_clamped_by_sink": ("tt" + "g" * 60,
                             {0: dict(gain=47), 1: dict(gain=47),
                              61: dict(gain=0)}),
    # any key dismisses the popup and is swallowed
    "help_popup": ("hd", {0: dict(help=True),
                          1: dict(help=False, bearing=0.0)}),
    "exit": ("x", {0: dict(stop=True)}),
    # TAB cycles panels (gps-sim.c:352-353); F1-F3 return to the
    # dashboard (gps-sim.c:355-361)
    "tab_and_fkeys": ([9, 9, 9, 265, 9, 266, 9, 267],
                      {0: dict(view=1), 1: dict(view=0), 2: dict(view=1),
                       3: dict(view=0), 5: dict(view=0), 7: dict(view=0)}),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_keys_equal_jax(apps, case):
    keys, expect = KEY_CASES[case]
    port, jax = (press(app, keys) for app in apps)
    assert port == jax
    for step, want in expect.items():
        got = {k: port[step][k] for k in want}
        assert got == pytest.approx(want), (step, keys)
    if case == "gain_clamped_by_sink":
        assert port[-1]["log"][-1] == "Gain: 0dB"


def test_pluto_gain_clamp_equal_jax():
    for mod in (sinks, jsinks):
        pluto = mod.PlutoSink()
        assert pluto.set_gain(5) == 0 and pluto.set_gain(-100) == -80


def test_sky_rows_equal_jax(apps):
    """The sky view (reference EPHEMERIS panel, gui.c:203) lists all 32
    PRNs; simulated ones are the allocated channels, with their az/el."""
    from gpssim_tpu_torch.core.constants import R2D

    port, jax = apps
    rows = tui.format_sky_rows(port.sim)
    assert rows == jtui.format_sky_rows(jax.sim) and len(rows) == 32
    alloc = port.sim.channels.allocated_sat
    sim_prns = {prn + 1 for prn, slot in enumerate(alloc) if slot >= 0}
    assert sim_prns
    for prn in range(1, 33):
        assert rows[prn - 1].startswith(f"PRN{prn:3d}")
        assert rows[prn - 1].endswith("Y") == (prn in sim_prns)
    prn = min(sim_prns)
    az, el = port.sim.channels.chan[int(alloc[prn - 1])].azel
    assert f"{az * R2D:5.1f}" in rows[prn - 1]
    assert f"{el * R2D:5.1f}" in rows[prn - 1]


def test_status_log_scrolls():
    for mod in (tui, jtui):
        log = mod.StatusLog(maxlen=3)
        for i in range(5):
            log.write(f"line {i}")
        assert log.tail(10) == ["line 2", "line 3", "line 4"]
        log.write("a\nb")
        assert log.tail(2) == ["a", "b"]


def test_format_helpers_equal_jax(apps):
    """Position and channel table after the first plan, and after a few
    planned blocks with edits: the JAX package's text. ``app`` imports
    the same helpers (one home)."""
    from gpssim_tpu_torch import app as tapp

    port, jax = apps
    for keys in ("", "eeeeedddw"):
        press(port, keys)
        press(jax, keys)
        for a in apps:
            next(a.sim.iter_plans())
        pos = tui.format_position(port.sim)
        assert pos == jtui.format_position(jax.sim)
        assert "Lat" in pos and "139." in pos
        rows = tui.format_channel_rows(port.sim)
        assert rows == jtui.format_channel_rows(jax.sim)
        assert rows and all("PRN" in r for r in rows)
    src = open(tapp.__file__).read()
    assert "def format_channel_rows" not in src
    assert "def format_position" not in src


def test_almanac_date_equal_jax(apps, fixtures_dir):
    """The 'Almanac date' field (reference gps.c:2652-2656): the last
    valid SV's toa with an almanac, the disabled notice without."""
    port, jax = apps
    assert tui.format_almanac_date(port.sim) == (
        "Almanac date: Disabled or invalid.")
    port.sim.alm = read_sem_almanac(f"{fixtures_dir}/almanac_test.sem")
    jax.sim.alm = jread_sem_almanac(f"{fixtures_dir}/almanac_test.sem")
    got = tui.format_almanac_date(port.sim)
    assert got == jtui.format_almanac_date(jax.sim)
    assert got.startswith("Almanac date: 20")


@pytest.mark.skipif(not hasattr(pty, "openpty"), reason="needs a pty")
def test_tui_end_to_end(fixtures_dir, tmp_path):
    """``python -m gpssim_tpu_torch -i`` in a pseudo-terminal: the
    dashboard renders on the kernels' plain versions (``--backend cuda
    --device cpu``), TAB, keys and the help popup dispatch, 'x' exits
    cleanly, and whole blocks are written. Bounded by its own deadlines;
    the child is killed if it outlives them."""
    out = str(tmp_path / "tui.bin")
    env = dict(os.environ, TERM="xterm-256color", OMP_NUM_THREADS="1")
    cmd = [
        sys.executable, "-m", "gpssim_tpu_torch",
        "-e", f"{fixtures_dir}/brdc_test.22n", "-i", "-r", "iqfile",
        "--backend", "cuda", "--device", "cpu", "--disable-almanac",
        "--sample-rate", "1030000", "--out-file", out, "-d", "20",
    ]
    m, s = pty.openpty()
    os.set_blocking(m, False)
    p = subprocess.Popen(cmd, stdin=s, stdout=s, stderr=subprocess.PIPE,
                         env=env, cwd=REPO)
    os.close(s)
    buf = b""

    def drain(t):
        nonlocal buf
        end = time.time() + t
        while time.time() < end:
            r, _, _ = select.select([m], [], [], 0.2)
            if r:
                try:
                    buf += os.read(m, 65536)
                except OSError:
                    return

    def drain_until(markers, deadline_s):
        deadline = time.time() + deadline_s
        while time.time() < deadline and not all(mk in buf
                                                  for mk in markers):
            drain(0.5)

    try:
        # the dashboard up and a window written (its stats line shows):
        # 'x' drops the windows in flight, so a run stopped before its
        # first drain writes nothing
        drain_until((b"heading", b"PRN", b"Msps"), 90)
        os.write(m, b"\t")  # TAB -> sky/ephemeris view
        drain_until((b"eph  sim",), 10)
        os.write(m, b"\t")
        drain(0.4)
        for key in (b"d", b"w", b"e", b"h", b"q"):
            os.write(m, key)
            drain(0.4)
        drain_until((b"interactive controls",), 10)
        drain(1)
        os.write(m, b"x")
        drain(2)
        rc = p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
        os.close(m)
    assert rc == 0, p.stderr.read().decode()[-2000:]
    text = buf.decode(errors="replace")
    for marker in ("gpssim-tpu-torch", "heading", "PRN",
                   "interactive controls", "eph  sim"):
        assert marker in text, f"TUI never rendered {marker!r}"
    data = np.fromfile(out, dtype=np.int8)
    assert data.size % 206_000 == 0 and data.size > 0
    assert np.any(data)
