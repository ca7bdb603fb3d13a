"""Scenario driver: the epoch loop that turns a config into block plans.

This is the re-design of the reference's GPS thread steady state
(gps_thread_ep, gps.c:2282-2948): setup (ephemeris/almanac/time/channels),
then one BlockPlan per 0.1 s epoch — per-channel pseudoranges, code/carrier
phase parameters, gains, nav-message words — with nav regeneration and
channel reallocation every 30 s. The plans feed any synth backend (NumPy
parity path, XLA, Pallas) and are the unit of time-block parallelism.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .config import CarrierMode, SimConfig
from .core.almanac import Almanac, read_sem_almanac
from .core.atmosphere import IonoUtc
from .core.channels import ChannelTable
from .core.constants import (
    ANT_PAT_DB,
    MAX_SAT,
    c_round as _c_round,
    PATH_LOSS_NUMERATOR,
    R2D,
    SECONDS_IN_HOUR,
    SECONDS_IN_WEEK,
    TX_FREQUENCY,
)
from .core.ephemeris import (
    NavData,
    apply_time_overwrite,
    nav_time_span,
    read_rinex_nav,
    select_ephemeris_set,
)
from .core.frames import ltcmat, xyz2llh
from .core.gpstime import GpsTime, date2gps, inc_gps_time, sub_gps_time
from .core.motion import (
    InteractiveState,
    apply_target_offset,
    read_user_motion,
    static_xyz,
)
from .core.navmsg import eph2sbf, generate_nav_msg, validate_frame
from .core.ranging import compute_code_phase, compute_range
from .ops.plan import BlockPlan


def _c_int32(x: np.ndarray) -> np.ndarray:
    """C `(int)` cast of a double, x86 semantics: out-of-range / NaN →
    INT32_MIN (cvttsd2si). Reachable when consecutive ephemeris sets are
    discontinuous — huge Doppler for one epoch, as in the reference."""
    x = np.asarray(x, dtype=np.float64)
    bad = ~np.isfinite(x) | (x >= 2147483648.0) | (x < -2147483648.0)
    safe = np.trunc(np.where(bad, 0.0, x)).astype(np.int64).astype(np.int32)
    return np.where(bad, np.int32(-(2**31)), safe)


@dataclass
class ScenarioError(Exception):
    message: str

    def __str__(self) -> str:
        return self.message


class Simulation:
    """Owns scenario state and yields per-epoch block plans."""

    def __init__(self, cfg: SimConfig, nav: NavData | None = None):
        self.cfg = cfg
        self.interactive = InteractiveState()

        if nav is None:
            if cfg.nav_file is None:
                raise ScenarioError("GPS ephemeris file is not specified")
            nav = read_rinex_nav(cfg.nav_file, version=cfg.rinex_version)
        if nav.neph == 0:
            raise ScenarioError("No ephemeris available")
        self.nav = nav
        self.ionoutc: IonoUtc = nav.ionoutc
        self.ionoutc.enable = cfg.ionosphere_enable

        # --- trajectory -------------------------------------------------
        llh0 = np.array(
            [cfg.location.lat / R2D, cfg.location.lon / R2D, cfg.location.height]
        )
        xyz0 = static_xyz(cfg.location.lat, cfg.location.lon, cfg.location.height)
        self.tmat = ltcmat(llh0)
        if cfg.target.valid:
            xyz0 = apply_target_offset(
                xyz0,
                llh0,
                cfg.target.distance,
                cfg.target.bearing_millideg,
                cfg.target.height,
            )

        self.numd = cfg.num_epochs
        if cfg.motion_file is not None:
            self.xyz = read_user_motion(cfg.motion_file)
            if len(self.xyz) > self.numd:
                self.xyz = self.xyz[: self.numd]
            self.numd = len(self.xyz)
        else:
            # Static / interactive: trajectory rows are generated on the fly.
            self.xyz = None
        self.xyz0 = xyz0

        # --- scenario time (gps.c:2507-2608) ------------------------------
        gmin, gmax = nav_time_span(nav)
        if cfg.start is not None:
            g0 = date2gps(cfg.start)
            if cfg.time_overwrite:
                apply_time_overwrite(nav, g0)
            else:
                if sub_gps_time(g0, gmin) < 0.0 or sub_gps_time(gmax, g0) < 0.0:
                    raise ScenarioError("Invalid start time")
        else:
            g0 = gmin
        self.g0 = g0

        self.ieph = select_ephemeris_set(nav, g0)
        if self.ieph < 0:
            raise ScenarioError("No current set of ephemerides has been found")

        # --- almanac (gps.c:2610-2657: use_ftp → download, else read
        # ./almanac.sem; failures warn and continue with no almanac) -------
        self.alm = Almanac()
        alm_file = cfg.almanac_file
        if cfg.almanac_enable and alm_file is None:
            if cfg.use_ftp:
                try:
                    from .io.fetch import fetch_almanac

                    alm_file = fetch_almanac()
                except Exception as e:  # network optional
                    import warnings

                    warnings.warn(f"almanac download failed: {e}")
            elif os.path.exists("almanac.sem"):
                alm_file = "almanac.sem"
        if cfg.almanac_enable and alm_file is not None:
            self.alm = read_sem_almanac(alm_file)
        if cfg.almanac_enable and self.alm.valid:
            for sv in range(MAX_SAT):
                a = self.alm.sv[sv]
                if a.valid != 0:
                    dt = sub_gps_time(a.toa, g0)
                    if dt < -4.0 * SECONDS_IN_WEEK or dt > 4.0 * SECONDS_IN_WEEK:
                        raise ScenarioError("Invalid time of almanac")

        # --- channels -----------------------------------------------------
        self.channels = ChannelTable(
            cfg.num_channels, parity_exact=cfg.parity_exact
        )
        self.grx = inc_gps_time(g0, 0.0)
        self.channels.allocate(
            self.alm,
            nav.sets[self.ieph],
            self.ionoutc,
            self.grx,
            self._xyz_at(0),
            0.0,
        )

        # Receiver antenna gain pattern (gps.c:2688-2689); libm pow for parity.
        self.ant_pat = np.array(
            [math.pow(10.0, -db / 20.0) for db in ANT_PAT_DB]
        )

        # Oscillator error model: the reference applies ppb to the hardware
        # LO only (sdr_hackrf.c:136-138); with no LO here it becomes an
        # optional baseband carrier shift, off in parity mode.
        self.f_carr_offset = 0.0
        if cfg.ppb != 0 and not cfg.parity_exact:
            self.f_carr_offset = TX_FREQUENCY * ((1.0e7 - cfg.ppb) / 1.0e7 - 1.0)

        self.delt = 1.0 / float(cfg.sample_rate)
        self.num_samples = cfg.samples_per_epoch

        # Strict sequential-parity chaining: carry block-boundary carrier
        # phase with the reference's per-sample f64 accumulation semantics
        # (gps.c:2820-2826) via the native replay engine.  Integer-NCO mode
        # is exact either way; without the native library the closed-form
        # chain (round-1 contract) is used.
        self.seq_chain = False
        if cfg.parity_exact and cfg.carrier_mode is CarrierMode.FLOAT:
            from .ops.synth_seq import seq_available

            self.seq_chain = seq_available()
        self.grx = inc_gps_time(self.grx, 0.1)
        self._iumd = 1
        self._xyz_prev = self._xyz_at(0)
        self._win = None  # buffered vectorized planning window
        # Set by the pipelined runner while its planner runs ahead: the
        # state snapshot matching the blocks actually written so far.
        self.consistent_snapshot: dict | None = None

    # ------------------------------------------------------------------
    def _xyz_at(self, iumd: int) -> np.ndarray:
        if self.xyz is not None:
            return self.xyz[iumd]
        return self.xyz0

    @property
    def num_blocks(self) -> int:
        return max(self.numd - 1, 0)

    def set_motion(self, bearing_deg=None, velocity=None, vertical_speed=None):
        """Runtime control hook (interactive mode key bindings)."""
        if bearing_deg is not None:
            self.interactive.bearing_millideg = bearing_deg * 1000.0
        if velocity is not None:
            self.interactive.velocity = velocity
        if vertical_speed is not None:
            self.interactive.vertical_speed = vertical_speed

    # ------------------------------------------------------------------
    def _plan_epoch(self, iumd: int) -> BlockPlan:
        cfg = self.cfg
        grx = self.grx

        if cfg.interactive:
            xyz = self.interactive.step(self._xyz_prev, self.tmat, 0.1)
        else:
            xyz = self._xyz_at(iumd)
        self._xyz_prev = xyz

        C = self.channels.num_channels
        active = np.zeros(C, dtype=bool)
        cp0 = np.zeros(C)
        f_code = np.zeros(C)
        carr0 = np.zeros(C)
        f_carr = np.zeros(C)
        carr0_i = np.zeros(C, dtype=np.uint32)
        step_i = np.zeros(C, dtype=np.int32)
        gain = np.zeros(C)
        iword = np.zeros(C, dtype=np.int64)
        ibit = np.zeros(C, dtype=np.int64)
        icode = np.zeros(C, dtype=np.int64)

        slots = self.channels.active_slots()
        if slots:
            svs = np.array([self.channels.chan[i].prn - 1 for i in slots])
            rho = compute_range(
                self.nav.sets[self.ieph],
                self.ionoutc,
                grx.week,
                grx.sec,
                xyz,
                svs,
            )
            for k, slot in enumerate(slots):
                ch = self.channels.chan[slot]
                ch.azel = (float(rho.azel[k, 0]), float(rho.azel[k, 1]))

                cps = compute_code_phase(
                    np.int64(ch.rho0_g.week),
                    np.float64(ch.rho0_g.sec),
                    np.float64(ch.rho0_range),
                    np.float64(rho.range[k]),
                    np.int64(ch.g0.week),
                    np.float64(ch.g0.sec),
                    0.1,
                )
                ch.f_carr = float(cps.f_carr) + self.f_carr_offset
                ch.f_code = float(cps.f_code)
                ch.code_phase = float(cps.code_phase)
                ch.iword = int(cps.iword)
                ch.ibit = int(cps.ibit)
                ch.icode = int(cps.icode)
                x = 512.0 * 65536.0 * ch.f_carr * self.delt
                ch.carr_phasestep_i = int(
                    _c_int32(float(_c_round(x)) if math.isfinite(x) else x)
                )
                ch.rho0_g = GpsTime(int(rho.g_week[k]), float(rho.g_sec[k]))
                ch.rho0_range = float(rho.range[k])
                ch.rho0_rate = float(rho.rate[k])
                ch.rho0_d = float(rho.d[k])
                ch.rho0_iono = float(rho.iono_delay[k])

                # Signal gain: path loss x antenna pattern (gps.c:2748-2763).
                path_loss = PATH_LOSS_NUMERATOR / float(rho.d[k])
                ibs = int((90.0 - float(rho.azel[k, 1]) * R2D) / 5.0)
                ant_gain = self.ant_pat[ibs]
                g = path_loss * ant_gain
                if cfg.pluto_gain_boost:
                    g *= 2
                active[slot] = True
                cp0[slot] = ch.code_phase
                f_code[slot] = ch.f_code
                carr0[slot] = ch.carr_phase
                f_carr[slot] = ch.f_carr
                carr0_i[slot] = np.uint32(ch.carr_phase_i & 0xFFFFFFFF)
                step_i[slot] = np.int32(ch.carr_phasestep_i)
                gain[slot] = g
                iword[slot] = ch.iword
                ibit[slot] = ch.ibit
                icode[slot] = ch.icode

        plan = BlockPlan(
            num_samples=self.num_samples,
            delt=self.delt,
            active=active,
            code_phase=cp0,
            f_code=f_code,
            carr_phase=carr0,
            f_carr=f_carr,
            carr_phase_i=carr0_i,
            carr_step_i=step_i,
            gain=gain,
            iword=iword,
            ibit=ibit,
            icode=icode,
            prn=np.array([c.prn for c in self.channels.chan], dtype=np.int64),
            ca=self.channels.ca_chips(),
            dwrd=self.channels.dwrd_array(),
        )

        # Advance the carried carrier phase to the end of this block.
        if cfg.carrier_mode is CarrierMode.FLOAT:
            if self.seq_chain:
                from .ops.synth_seq import carrier_chain

                end_phase = carrier_chain(
                    carr0, f_carr[None, :], self.num_samples, self.delt
                )[1]
            else:
                end_phase = plan.end_carr_phase()
            for slot in slots:
                self.channels.chan[slot].carr_phase = float(end_phase[slot])
        else:
            end_phase_i = plan.end_carr_phase_i()
            for slot in slots:
                self.channels.chan[slot].carr_phase_i = int(end_phase_i[slot])

        return plan

    # ------------------------------------------------------------------
    def _post_block(self, iumd: int) -> None:
        """Every-30 s nav regen / ephemeris advance / reallocation
        (gps.c:2870-2930), then advance grx."""
        cfg = self.cfg
        grx = self.grx
        igrx = int(grx.sec * 10.0 + 0.5)

        if igrx % 300 == 0:
            for ch in self.channels.chan:
                if ch.prn > 0:
                    ch.g0, ch.ipage = generate_nav_msg(
                        grx, ch.sbf, ch.dwrd, ch.ipage, init=False
                    )
                    # Unconditional runtime parity self-check on every
                    # regenerated frame — the reference validates every
                    # emitted word (validate_parityN from computeChecksum,
                    # gps.c:926-1001, 1070). Corrupt nav bits must never
                    # reach the output stream.
                    bad = validate_frame(ch.dwrd)
                    if bad:
                        raise RuntimeError(
                            f"PRN{ch.prn}: nav parity check failed at "
                            f"words {bad}"
                        )

            # Advance the ephemeris set when the next toc comes within 1 h;
            # the reference checks only the first valid SV of the next set.
            if self.ieph + 1 < self.nav.neph:
                nxt = self.nav.sets[self.ieph + 1]
                for sv in range(MAX_SAT):
                    if nxt.vflg[sv]:
                        dt = sub_gps_time(
                            GpsTime(int(nxt.toc_week[sv]), float(nxt.toc_sec[sv])),
                            grx,
                        )
                        if dt < SECONDS_IN_HOUR:
                            self.ieph += 1
                            eph = self.nav.sets[self.ieph]
                            for ch in self.channels.chan:
                                if ch.prn != 0:
                                    ch.sbf = eph2sbf(
                                        eph, ch.prn - 1, self.ionoutc, self.alm
                                    )
                        break

            # Reference quirk: reallocation uses the *initial* position
            # xyz[0] (gps.c:2909); fixed behind the parity flag.
            realloc_xyz = (
                self._xyz_at(0) if cfg.parity_exact else self._xyz_prev
            )
            self.channels.allocate(
                self.alm,
                self.nav.sets[self.ieph],
                self.ionoutc,
                grx,
                realloc_xyz,
                0.0,
            )

        self.grx = inc_gps_time(grx, 0.1)

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # Windowed vectorized planning (static/motion modes).
    #
    # Between 30 s boundaries the channel set, nav words and ephemeris set
    # are fixed, so every per-epoch quantity of the window is computable in
    # one vectorized f64 pass with IDENTICAL elementwise op order to the
    # sequential path (the goldens assert bit-exactness). Channel state is
    # still applied one epoch at a time when the plan is handed out, so a
    # checkpoint between steps stays consistent ("blocks 1..N done").
    # ------------------------------------------------------------------

    def _fill_window(self) -> None:
        cfg = self.cfg
        iumd0 = self._iumd
        igrx0 = int(self.grx.sec * 10.0 + 0.5)
        K = min(self.numd - iumd0, (300 - igrx0 % 300) % 300 + 1)
        C = self.channels.num_channels

        # grx chain: identical repeated inc_gps_time (ms rounding included).
        gs = []
        g = self.grx
        for _ in range(K):
            gs.append(g)
            g = inc_gps_time(g, 0.1)
        weeks = np.array([t.week for t in gs], dtype=np.int64)
        secs = np.array([t.sec for t in gs], dtype=np.float64)

        if self.xyz is not None:
            xyz = np.asarray(self.xyz[iumd0 : iumd0 + K], dtype=np.float64)
        else:
            xyz = np.broadcast_to(self.xyz0, (K, 3))

        slots = self.channels.active_slots()
        S = len(slots)
        shape = (K, C)
        active = np.zeros(shape, dtype=bool)
        cp0 = np.zeros(shape)
        f_code = np.zeros(shape)
        carr0 = np.zeros(shape)
        f_carr = np.zeros(shape)
        carr0_i = np.zeros(shape, dtype=np.uint32)
        step_i = np.zeros(shape, dtype=np.int32)
        gain = np.zeros(shape)
        iword = np.zeros(shape, dtype=np.int64)
        ibit = np.zeros(shape, dtype=np.int64)
        icode = np.zeros(shape, dtype=np.int64)
        win: dict = {"slots": slots, "K": K}

        if S:
            chans = [self.channels.chan[i] for i in slots]
            svs = np.array([c.prn - 1 for c in chans])
            rho = compute_range(
                self.nav.sets[self.ieph], self.ionoutc,
                weeks[:, None], secs[:, None], xyz[:, None, :], svs,
            )

            # Epoch-to-epoch pseudorange chaining: row j uses row j-1's
            # observation; row 0 uses the channels' pre-window rho0.
            prev_week = np.concatenate(
                [np.array([[c.rho0_g.week for c in chans]]), rho.g_week[:-1]]
            )
            prev_sec = np.concatenate(
                [np.array([[c.rho0_g.sec for c in chans]]), rho.g_sec[:-1]]
            )
            prev_range = np.concatenate(
                [np.array([[c.rho0_range for c in chans]]), rho.range[:-1]]
            )
            cps = compute_code_phase(
                prev_week, prev_sec, prev_range, rho.range,
                np.array([c.g0.week for c in chans], dtype=np.int64),
                np.array([c.g0.sec for c in chans], dtype=np.float64),
                0.1,
            )
            fc = cps.f_carr + self.f_carr_offset
            fcode = cps.f_code
            # (int) round(...) vectorized: C round is half-away-from-zero
            x = 512.0 * 65536.0 * fc * self.delt
            stp = _c_int32(
                np.where(x >= 0.0, np.floor(x + 0.5), np.ceil(x - 0.5))
            )

            # Carrier phase chained across the window's blocks.  In strict
            # parity mode the chain replays the reference's per-sample f64
            # accumulation (native engine); otherwise the closed-form
            # end_carr_phase recurrence (not a cumsum — rounding differs).
            cstart = np.empty((K, S))
            cstart_i = np.empty((K, S), dtype=np.uint32)
            cp = np.array([c.carr_phase for c in chans], dtype=np.float64)
            cpi = np.array(
                [c.carr_phase_i & 0xFFFFFFFF for c in chans], dtype=np.uint64
            )
            if cfg.carrier_mode is CarrierMode.FLOAT and self.seq_chain:
                from .ops.synth_seq import carrier_chain

                chain = carrier_chain(cp, fc, self.num_samples, self.delt)
                cstart[:] = chain[:K]
                cp = chain[K]
                cstart_i[:] = cpi.astype(np.uint32)[None, :]
            else:
                for j in range(K):
                    cstart[j] = cp
                    cstart_i[j] = cpi.astype(np.uint32)
                    if cfg.carrier_mode is CarrierMode.FLOAT:
                        c = cp + self.num_samples * (fc[j] * self.delt)
                        cp = c - np.floor(c)
                    else:
                        cpi = (
                            cpi
                            + np.uint64(self.num_samples)
                            * stp[j].astype(np.int64).astype(np.uint64)
                        ) & np.uint64(0xFFFFFFFF)

            # Signal gain: path loss x antenna pattern (gps.c:2748-2763).
            path_loss = PATH_LOSS_NUMERATOR / rho.d
            ibs = ((90.0 - rho.azel[..., 1] * R2D) / 5.0).astype(np.int64)
            gn = path_loss * self.ant_pat[ibs]
            if cfg.pluto_gain_boost:
                gn = gn * 2

            active[:, slots] = True
            cp0[:, slots] = cps.code_phase
            f_code[:, slots] = fcode
            carr0[:, slots] = cstart
            f_carr[:, slots] = fc
            carr0_i[:, slots] = cstart_i
            step_i[:, slots] = stp
            gain[:, slots] = gn
            iword[:, slots] = cps.iword
            ibit[:, slots] = cps.ibit
            icode[:, slots] = cps.icode

            win.update(
                rho=rho, f_carr=fc, f_code=fcode, cps=cps, step_i=stp,
                carr_end_f=None, chans=chans,
            )
            # State after each epoch: phase at the END of block j is the
            # START of block j+1 (cstart[j+1]); the last epoch's end phase
            # is the live cp/cpi value.
            win["carr_next"] = np.concatenate([cstart[1:], cp[None]], axis=0)
            win["carr_i_next"] = np.concatenate(
                [cstart_i[1:], cpi.astype(np.uint32)[None]], axis=0
            )

        # Shared per-window arrays (nav words fixed between boundaries).
        prn = np.array(
            [c.prn for c in self.channels.chan], dtype=np.int64
        )
        ca = self.channels.ca_chips()
        dwrd = self.channels.dwrd_array()
        win["plans"] = [
            BlockPlan(
                num_samples=self.num_samples,
                delt=self.delt,
                active=active[j],
                code_phase=cp0[j],
                f_code=f_code[j],
                carr_phase=carr0[j],
                f_carr=f_carr[j],
                carr_phase_i=carr0_i[j],
                carr_step_i=step_i[j],
                gain=gain[j],
                iword=iword[j],
                ibit=ibit[j],
                icode=icode[j],
                prn=prn,
                ca=ca,
                dwrd=dwrd,
            )
            for j in range(K)
        ]
        win["xyz"] = xyz
        win["pos"] = 0
        self._win = win

    def _apply_window_epoch(self) -> BlockPlan:
        """Hand out the next buffered plan.

        Channel-state write-back is DEFERRED: every per-epoch field is a
        pure overwrite from the window row (no accumulation), so only the
        last handed-out row matters — ``_sync_channels`` applies it on
        demand (window end, checkpoint capture, TUI reads) instead of
        ~17 Python attribute stores per channel per epoch, which measured
        as ~15% of strict-parity planning cost."""
        win = self._win
        j = win["pos"]
        win["pos"] = j + 1
        self._xyz_prev = np.asarray(win["xyz"][j], dtype=np.float64)
        plan = win["plans"][j]
        if win["pos"] >= win["K"]:
            self._sync_channels()  # window state must land before regen
            self._win = None
        return plan

    def _sync_channels(self) -> None:
        """Write the last handed-out window row back onto the channel
        table (idempotent; no-op between windows or in interactive mode,
        where _plan_epoch writes eagerly)."""
        win = self._win
        if win is None or win["pos"] == 0 or win.get("synced") == win["pos"]:
            return
        win["synced"] = win["pos"]
        j = win["pos"] - 1
        cfg = self.cfg
        if win["slots"]:
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
                ch.rho0_g = GpsTime(
                    int(rho.g_week[j, k]), float(rho.g_sec[j, k])
                )
                ch.rho0_range = float(rho.range[j, k])
                ch.rho0_rate = float(rho.rate[j, k])
                ch.rho0_d = float(rho.d[j, k])
                ch.rho0_iono = float(rho.iono_delay[j, k])
                if cfg.carrier_mode is CarrierMode.FLOAT:
                    ch.carr_phase = float(win["carr_next"][j, k])
                else:
                    ch.carr_phase_i = int(win["carr_i_next"][j, k])

    def step(self) -> BlockPlan | None:
        """Produce the next epoch's plan and advance scenario state past it.

        The plan snapshots all arrays it needs, so state is advanced
        (nav regen / reallocation / grx) before returning — a checkpoint
        taken between steps is always consistent ("blocks 1..N done").
        Returns None when the scenario is exhausted."""
        if self._iumd >= self.numd:
            return None
        iumd = self._iumd
        if self.cfg.interactive:
            plan = self._plan_epoch(iumd)
        else:
            if self._win is None:
                self._fill_window()
            plan = self._apply_window_epoch()
        self._post_block(iumd)
        self._iumd = iumd + 1
        return plan

    def iter_plans(self) -> Iterator[BlockPlan]:
        """Yield one BlockPlan per epoch, iumd = 1 .. numd-1 (gps.c:2703).

        The cursor lives in ``self._iumd`` so a Simulation restored by
        checkpoint.load_checkpoint continues mid-scenario."""
        while (plan := self.step()) is not None:
            yield plan

    @property
    def next_block_index(self) -> int:
        """Absolute epoch index of the next plan ``step`` will produce
        (iumd cursor; stable across checkpoint/resume — used to key the
        deterministic noise stage, noise.py)."""
        return self._iumd

    def current_llh(self) -> np.ndarray:
        return xyz2llh(self._xyz_prev)
