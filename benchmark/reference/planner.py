"""Block plans of a scenario, worked out again from the generated inputs.

A frozen copy of the port's planner (``gpssim_tpu_torch/scenario.py``,
windowed static planning and per-epoch interactive planning), cut to
what the benchmark's deployments use: a static or interactively steered
receiver, one RINEX v2 nav file, an optional SEM almanac, with or
without the reference C's parity quirks. It imports nothing of the port.

Under the reference C's parity (``Receiver.parity_exact``), the one
stage it does not replay is the sequential float64 carrier chain across
blocks (the port runs it in its native engine; a NumPy replay of
every sample of every block is far slower than the window it checks).
Each plan's ``carr_phase`` here is chained in closed form instead, and
``fresh`` marks the slots whose phase is the exact allocation value.
``benchmark/reference/check.py`` holds the program's block-start phases
against this chain within a proven bound, replays sampled chain steps
exactly (``seqwalk``), and synthesizes from the program's phases. In the
port's closed form (``parity_exact=False``) the closed-form chain is the
semantics itself, and the check holds the program's phases to it
exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .core.almanac import Almanac, read_sem_almanac
from .core.channels import ChannelTable
from .core.constants import (
    ANT_PAT_DB,
    MAX_SAT,
    PATH_LOSS_NUMERATOR,
    R2D,
    SECONDS_IN_HOUR,
    SECONDS_IN_WEEK,
    c_round as _c_round,
)
from .core.ephemeris import (
    nav_time_span,
    read_rinex_nav,
    select_ephemeris_set,
)
from .core.frames import ltcmat
from .core.gpstime import DateTime, GpsTime, date2gps, inc_gps_time, sub_gps_time
from .core.motion import InteractiveState, static_xyz
from .core.navmsg import eph2sbf, generate_nav_msg
from .core.ranging import compute_code_phase, compute_range


@dataclass
class Receiver:
    """What the benchmark hands the program for one receiver."""

    nav_file: str
    start: DateTime
    lat: float
    lon: float
    height: float
    sample_rate: int = 3_000_000
    num_channels: int = 12
    ionosphere: bool = True
    almanac_file: str | None = None
    interactive: bool = False
    #: the reference C's quirks and sequential float64 phases (True), or
    #: the port's closed form (``--no-parity-exact``): phases chained and
    #: synthesized in closed form, channels reallocated at the current
    #: position, a freshly allocated satellite's page cycle from page 0
    parity_exact: bool = True
    #: absolute block index -> [set_motion kwargs, ...] applied just
    #: before that block is planned (interactive runs)
    edits: dict = field(default_factory=dict)


@dataclass
class Plan:
    """One 0.1 s block's synthesis inputs (the port's BlockPlan fields)."""

    index: int  # absolute block index (1 = the first block)
    num_samples: int
    delt: float
    active: np.ndarray  # bool[C]
    code_phase: np.ndarray  # f64[C]
    f_code: np.ndarray  # f64[C]
    carr_phase: np.ndarray  # f64[C], closed-form chain
    f_carr: np.ndarray  # f64[C]
    gain: np.ndarray  # f64[C]
    iword: np.ndarray  # i64[C]
    ibit: np.ndarray  # i64[C]
    icode: np.ndarray  # i64[C]
    prn: np.ndarray  # i64[C]
    ca: np.ndarray  # int8[C, 1023]
    dwrd: np.ndarray  # uint32[C, 60]
    fresh: np.ndarray = None  # bool[C]: carr_phase is the allocation value
    since: np.ndarray = None  # i64[C]: blocks chained since that value


def _c_int32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    bad = ~np.isfinite(x) | (x >= 2147483648.0) | (x < -2147483648.0)
    safe = np.trunc(np.where(bad, 0.0, x)).astype(np.int64).astype(np.int32)
    return np.where(bad, np.int32(-(2**31)), safe)


class Planner:
    """Yields the plans of blocks 1, 2, ... of one receiver's scenario."""

    def __init__(self, rx: Receiver):
        self.rx = rx
        self.interactive = InteractiveState()
        nav = read_rinex_nav(rx.nav_file, version=2)
        if nav.neph == 0:
            raise ValueError("no ephemeris in the nav file")
        self.nav = nav
        self.ionoutc = nav.ionoutc
        self.ionoutc.enable = rx.ionosphere
        llh0 = np.array([rx.lat / R2D, rx.lon / R2D, rx.height])
        self.xyz0 = static_xyz(rx.lat, rx.lon, rx.height)
        self.tmat = ltcmat(llh0)

        gmin, gmax = nav_time_span(nav)
        g0 = date2gps(rx.start)
        if sub_gps_time(g0, gmin) < 0.0 or sub_gps_time(gmax, g0) < 0.0:
            raise ValueError("start time outside the nav file")
        self.g0 = g0
        self.ieph = select_ephemeris_set(nav, g0)
        if self.ieph < 0:
            raise ValueError("no current set of ephemerides")

        self.alm = Almanac()
        if rx.almanac_file is not None:
            self.alm = read_sem_almanac(rx.almanac_file)
        if self.alm.valid:
            for sv in range(MAX_SAT):
                a = self.alm.sv[sv]
                if a.valid != 0:
                    dt = sub_gps_time(a.toa, g0)
                    if dt < -4.0 * SECONDS_IN_WEEK or dt > 4.0 * SECONDS_IN_WEEK:
                        raise ValueError("invalid time of almanac")

        self.channels = ChannelTable(rx.num_channels,
                                     parity_exact=rx.parity_exact)
        self.grx = inc_gps_time(g0, 0.0)
        self.channels.allocate(self.alm, nav.sets[self.ieph], self.ionoutc,
                               self.grx, self.xyz0, 0.0)
        self.ant_pat = np.array(
            [math.pow(10.0, -db / 20.0) for db in ANT_PAT_DB])
        self.delt = 1.0 / float(rx.sample_rate)
        self.num_samples = rx.sample_rate // 10
        self.grx = inc_gps_time(self.grx, 0.1)
        self._iumd = 1
        self._xyz_prev = self.xyz0
        self._win = None
        self._prev_prn = None
        self._since = np.zeros(rx.num_channels, dtype=np.int64)

    # -- one block ---------------------------------------------------------
    def next_plan(self) -> Plan:
        iumd = self._iumd
        for kw in self.rx.edits.get(iumd, ()):
            self._set_motion(**kw)
        if self.rx.interactive:
            plan = self._plan_epoch()
        else:
            if self._win is None:
                self._fill_window()
            plan = self._apply_window_epoch()
        self._post_block()
        self._iumd = iumd + 1
        plan.index = iumd
        prn = plan.prn
        fresh = plan.active.copy()
        if self._prev_prn is not None:
            fresh &= (self._prev_prn != prn) | ~self._prev_active
        self._since = np.where(fresh, 0, self._since + 1)
        plan.fresh, plan.since = fresh, self._since.copy()
        self._prev_prn, self._prev_active = prn, plan.active
        return plan

    def _set_motion(self, bearing_deg=None, velocity=None,
                    vertical_speed=None):
        if bearing_deg is not None:
            self.interactive.bearing_millideg = bearing_deg * 1000.0
        if velocity is not None:
            self.interactive.velocity = velocity
        if vertical_speed is not None:
            self.interactive.vertical_speed = vertical_speed

    def _plan_epoch(self) -> Plan:
        grx = self.grx
        xyz = self.interactive.step(self._xyz_prev, self.tmat, 0.1)
        self._xyz_prev = xyz
        C = self.channels.num_channels
        active = np.zeros(C, dtype=bool)
        cp0, f_code, carr0, f_carr, gain = (np.zeros(C) for _ in range(5))
        iword, ibit, icode = (np.zeros(C, dtype=np.int64) for _ in range(3))
        slots = self.channels.active_slots()
        if slots:
            svs = np.array([self.channels.chan[i].prn - 1 for i in slots])
            rho = compute_range(self.nav.sets[self.ieph], self.ionoutc,
                                grx.week, grx.sec, xyz, svs)
            for k, slot in enumerate(slots):
                ch = self.channels.chan[slot]
                ch.azel = (float(rho.azel[k, 0]), float(rho.azel[k, 1]))
                cps = compute_code_phase(
                    np.int64(ch.rho0_g.week), np.float64(ch.rho0_g.sec),
                    np.float64(ch.rho0_range), np.float64(rho.range[k]),
                    np.int64(ch.g0.week), np.float64(ch.g0.sec), 0.1)
                ch.f_carr = float(cps.f_carr)
                ch.f_code = float(cps.f_code)
                ch.code_phase = float(cps.code_phase)
                ch.iword = int(cps.iword)
                ch.ibit = int(cps.ibit)
                ch.icode = int(cps.icode)
                x = 512.0 * 65536.0 * ch.f_carr * self.delt
                ch.carr_phasestep_i = int(
                    _c_int32(float(_c_round(x)) if math.isfinite(x) else x))
                ch.rho0_g = GpsTime(int(rho.g_week[k]), float(rho.g_sec[k]))
                ch.rho0_range = float(rho.range[k])
                ch.rho0_rate = float(rho.rate[k])
                ch.rho0_d = float(rho.d[k])
                ch.rho0_iono = float(rho.iono_delay[k])
                path_loss = PATH_LOSS_NUMERATOR / float(rho.d[k])
                ibs = int((90.0 - float(rho.azel[k, 1]) * R2D) / 5.0)
                active[slot] = True
                cp0[slot] = ch.code_phase
                f_code[slot] = ch.f_code
                carr0[slot] = ch.carr_phase
                f_carr[slot] = ch.f_carr
                gain[slot] = path_loss * self.ant_pat[ibs]
                iword[slot] = ch.iword
                ibit[slot] = ch.ibit
                icode[slot] = ch.icode
        plan = Plan(
            index=0, num_samples=self.num_samples, delt=self.delt,
            active=active, code_phase=cp0, f_code=f_code, carr_phase=carr0,
            f_carr=f_carr, gain=gain, iword=iword, ibit=ibit, icode=icode,
            prn=np.array([c.prn for c in self.channels.chan], dtype=np.int64),
            ca=self.channels.ca_chips(), dwrd=self.channels.dwrd_array())
        end = carr0 + self.num_samples * (f_carr * self.delt)
        end = np.where(active, end - np.floor(end), carr0)
        for slot in slots:
            self.channels.chan[slot].carr_phase = float(end[slot])
        return plan

    def _post_block(self) -> None:
        """Every-30 s nav regeneration, ephemeris advance and channel
        reallocation (under parity at the receiver's first position, the
        reference C's quirk), then advance the receiver time."""
        grx = self.grx
        igrx = int(grx.sec * 10.0 + 0.5)
        if igrx % 300 == 0:
            for ch in self.channels.chan:
                if ch.prn > 0:
                    ch.g0, ch.ipage = generate_nav_msg(
                        grx, ch.sbf, ch.dwrd, ch.ipage, init=False)
            if self.ieph + 1 < self.nav.neph:
                nxt = self.nav.sets[self.ieph + 1]
                for sv in range(MAX_SAT):
                    if nxt.vflg[sv]:
                        dt = sub_gps_time(
                            GpsTime(int(nxt.toc_week[sv]),
                                    float(nxt.toc_sec[sv])), grx)
                        if dt < SECONDS_IN_HOUR:
                            self.ieph += 1
                            eph = self.nav.sets[self.ieph]
                            for ch in self.channels.chan:
                                if ch.prn != 0:
                                    ch.sbf = eph2sbf(eph, ch.prn - 1,
                                                     self.ionoutc, self.alm)
                        break
            where = self.xyz0 if self.rx.parity_exact else self._xyz_prev
            self.channels.allocate(self.alm, self.nav.sets[self.ieph],
                                   self.ionoutc, grx, where, 0.0)
        self.grx = inc_gps_time(grx, 0.1)

    # -- windowed planning of a static receiver ------------------------------
    def _fill_window(self) -> None:
        iumd0 = self._iumd
        igrx0 = int(self.grx.sec * 10.0 + 0.5)
        K = (300 - igrx0 % 300) % 300 + 1
        C = self.channels.num_channels
        gs = []
        g = self.grx
        for _ in range(K):
            gs.append(g)
            g = inc_gps_time(g, 0.1)
        weeks = np.array([t.week for t in gs], dtype=np.int64)
        secs = np.array([t.sec for t in gs], dtype=np.float64)
        xyz = np.broadcast_to(self.xyz0, (K, 3))
        slots = self.channels.active_slots()
        shape = (K, C)
        active = np.zeros(shape, dtype=bool)
        cp0, f_code, carr0, f_carr, gain = (np.zeros(shape) for _ in range(5))
        iword, ibit, icode = (np.zeros(shape, dtype=np.int64)
                              for _ in range(3))
        win: dict = {"slots": slots, "K": K}
        if slots:
            chans = [self.channels.chan[i] for i in slots]
            svs = np.array([c.prn - 1 for c in chans])
            rho = compute_range(self.nav.sets[self.ieph], self.ionoutc,
                                weeks[:, None], secs[:, None],
                                xyz[:, None, :], svs)
            prev_week = np.concatenate(
                [np.array([[c.rho0_g.week for c in chans]]), rho.g_week[:-1]])
            prev_sec = np.concatenate(
                [np.array([[c.rho0_g.sec for c in chans]]), rho.g_sec[:-1]])
            prev_range = np.concatenate(
                [np.array([[c.rho0_range for c in chans]]), rho.range[:-1]])
            cps = compute_code_phase(
                prev_week, prev_sec, prev_range, rho.range,
                np.array([c.g0.week for c in chans], dtype=np.int64),
                np.array([c.g0.sec for c in chans], dtype=np.float64), 0.1)
            fc = cps.f_carr
            x = 512.0 * 65536.0 * fc * self.delt
            stp = _c_int32(np.where(x >= 0.0, np.floor(x + 0.5),
                                    np.ceil(x - 0.5)))
            cstart = np.empty((K, len(slots)))
            cp = np.array([c.carr_phase for c in chans], dtype=np.float64)
            for j in range(K):
                cstart[j] = cp
                c = cp + self.num_samples * (fc[j] * self.delt)
                cp = c - np.floor(c)
            path_loss = PATH_LOSS_NUMERATOR / rho.d
            ibs = ((90.0 - rho.azel[..., 1] * R2D) / 5.0).astype(np.int64)
            active[:, slots] = True
            cp0[:, slots] = cps.code_phase
            f_code[:, slots] = cps.f_code
            carr0[:, slots] = cstart
            f_carr[:, slots] = fc
            gain[:, slots] = path_loss * self.ant_pat[ibs]
            iword[:, slots] = cps.iword
            ibit[:, slots] = cps.ibit
            icode[:, slots] = cps.icode
            win.update(rho=rho, f_carr=fc, f_code=cps.f_code, cps=cps,
                       step_i=stp, chans=chans,
                       carr_next=np.concatenate([cstart[1:], cp[None]]))
        prn = np.array([c.prn for c in self.channels.chan], dtype=np.int64)
        ca = self.channels.ca_chips()
        dwrd = self.channels.dwrd_array()
        win["plans"] = [
            Plan(index=0, num_samples=self.num_samples, delt=self.delt,
                 active=active[j], code_phase=cp0[j], f_code=f_code[j],
                 carr_phase=carr0[j], f_carr=f_carr[j], gain=gain[j],
                 iword=iword[j], ibit=ibit[j], icode=icode[j], prn=prn,
                 ca=ca, dwrd=dwrd)
            for j in range(K)
        ]
        win["pos"] = 0
        self._win = win

    def _apply_window_epoch(self) -> Plan:
        win = self._win
        j = win["pos"]
        win["pos"] = j + 1
        plan = win["plans"][j]
        if win["pos"] >= win["K"]:
            self._sync_channels()
            self._win = None
        return plan

    def _sync_channels(self) -> None:
        """Write the window's last row back onto the channel table, as
        the port does before a 30 s boundary."""
        win = self._win
        j = win["pos"] - 1
        if not win["slots"]:
            return
        rho, cps = win["rho"], win["cps"]
        for k, slot in enumerate(win["slots"]):
            ch = self.channels.chan[slot]
            ch.azel = (float(rho.azel[j, k, 0]), float(rho.azel[j, k, 1]))
            ch.f_carr = float(win["f_carr"][j, k])
            ch.f_code = float(win["f_code"][j, k])
            ch.code_phase = float(cps.code_phase[j, k])
            ch.iword = int(cps.iword[j, k])
            ch.ibit = int(cps.ibit[j, k])
            ch.icode = int(cps.icode[j, k])
            ch.carr_phasestep_i = int(win["step_i"][j, k])
            ch.rho0_g = GpsTime(int(rho.g_week[j, k]), float(rho.g_sec[j, k]))
            ch.rho0_range = float(rho.range[j, k])
            ch.rho0_rate = float(rho.rate[j, k])
            ch.rho0_d = float(rho.d[j, k])
            ch.rho0_iono = float(rho.iono_delay[j, k])
            ch.carr_phase = float(win["carr_next"][j, k])


def plans(rx: Receiver, last: int) -> list[Plan]:
    """The plans of blocks 1 .. ``last`` of ``rx``'s scenario."""
    p = Planner(rx)
    return [p.next_plan() for _ in range(last)]
