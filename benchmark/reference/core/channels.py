"""Channel state and satellite-to-channel allocation.

The 12 channel slots form a fixed-shape table (prn == 0 means free), exactly
like the reference's slot array — which also keeps shapes static under jit.
The per-channel state here is the complete generator checkpoint: snapshot it
at block boundaries and any device can resume synthesis.

Reference: channel_t gps.h:213-236, allocateChannel gps.c:2164-2235.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .almanac import Almanac
from .atmosphere import IonoUtc
from .cacode import ca_table
from .constants import LAMBDA_L1, MAX_CHAN, MAX_SAT, N_DWRD
from .gpstime import GpsTime
from .navmsg import eph2sbf, generate_nav_msg, validate_frame
from .orbits import EphemerisSet, check_sat_visibility
from .ranging import compute_range


@dataclass
class Channel:
    """One simulated satellite channel (reference channel_t)."""

    prn: int = 0  # 0 = free slot
    f_carr: float = 0.0
    f_code: float = 0.0
    carr_phase: float = 0.0  # cycles in [0, 1)
    carr_phase_i: int = 0  # integer-NCO mode phase (9.16 fixed point)
    carr_phasestep_i: int = 0
    code_phase: float = 0.0  # chips in [0, 1023)
    g0: GpsTime = field(default_factory=lambda: GpsTime(0, 0.0))
    sbf: np.ndarray | None = None  # uint32[53, 10] page buffer
    dwrd: np.ndarray = field(default_factory=lambda: np.zeros(N_DWRD, dtype=np.uint32))
    ipage: int = 0
    iword: int = 0
    ibit: int = 0
    icode: int = 0
    data_bit: int = 0
    code_ca: int = 0
    azel: tuple[float, float] = (0.0, 0.0)
    # Previous-epoch pseudorange (rho0): (week, sec, range, rate, d, az, el, iono)
    rho0_g: GpsTime = field(default_factory=lambda: GpsTime(0, 0.0))
    rho0_range: float = 0.0
    rho0_rate: float = 0.0
    rho0_d: float = 0.0
    rho0_iono: float = 0.0


class ChannelTable:
    """Fixed 12-slot channel table plus the PRN→slot allocation map."""

    def __init__(self, num_channels: int = MAX_CHAN,
                 parity_exact: bool = True):
        self.chan = [Channel() for _ in range(num_channels)]
        self.allocated_sat = np.full(MAX_SAT, -1, dtype=np.int64)
        # Replicate the reference's stale-ipage reallocation quirk (see
        # allocate) only when parity with its byte stream is required;
        # otherwise a freshly allocated satellite starts its almanac
        # cycle at page 0, which is the sane behavior.
        self.parity_exact = parity_exact

    @property
    def num_channels(self) -> int:
        return len(self.chan)

    def active_slots(self) -> list[int]:
        return [i for i, c in enumerate(self.chan) if c.prn > 0]

    def allocate(
        self,
        alm: Almanac,
        eph: EphemerisSet,
        ionoutc: IonoUtc,
        grx: GpsTime,
        xyz: np.ndarray,
        elv_mask_deg: float = 0.0,
    ) -> int:
        """Claim channels for newly visible SVs, free invisible ones.

        Mirrors gps.c:2164-2235 including the geometric carrier-phase
        initialization phase_ini = (2*r_ref - r_xyz)/lambda with r_ref the
        pseudorange from the ECEF origin. Returns number of visible SVs.
        """
        state, azel = check_sat_visibility(eph, grx.sec, xyz, elv_mask_deg)
        nsat = 0
        for sv in range(MAX_SAT):
            if state[sv] == 1:
                nsat += 1
                if self.allocated_sat[sv] == -1:
                    # Visible but not yet allocated: claim first free slot.
                    slot = None
                    for i, c in enumerate(self.chan):
                        if c.prn == 0:
                            slot = i
                            break
                    if slot is not None:
                        c = self.chan[slot]
                        c.prn = sv + 1
                        c.azel = (float(azel[sv, 0]), float(azel[sv, 1]))
                        # C/A chips come from the precomputed constant table.
                        c.sbf = eph2sbf(eph, sv, ionoutc, alm)
                        # Reference quirk: allocateChannel never resets the
                        # slot's ipage (gps.c:2164-2216 sets prn/azel/ca/
                        # sbf/dwrd but NOT ipage), so a satellite allocated
                        # mid-run CONTINUES the 25-page almanac cycle from
                        # whatever page its slot's previous occupant
                        # reached. Resetting to 0 here diverged from the
                        # oracle at the first mid-run reallocation (found
                        # by the hour-scale endurance golden).
                        if not self.parity_exact:
                            c.ipage = 0
                        c.dwrd = np.zeros(N_DWRD, dtype=np.uint32)
                        c.g0, c.ipage = generate_nav_msg(
                            grx, c.sbf, c.dwrd, c.ipage, init=True
                        )
                        # Unconditional parity self-check on every built
                        # frame, like the reference's validate_parityN run
                        # from computeChecksum (gps.c:926-1001, 1070).
                        bad = validate_frame(c.dwrd)
                        if bad:
                            raise RuntimeError(
                                f"PRN{c.prn}: nav parity check failed at "
                                f"words {bad} after allocation"
                            )

                        rho = compute_range(
                            eph, ionoutc, grx.week, grx.sec, xyz, np.array([sv])
                        )
                        c.rho0_g = GpsTime(int(rho.g_week[0]), float(rho.g_sec[0]))
                        c.rho0_range = float(rho.range[0])
                        c.rho0_rate = float(rho.rate[0])
                        c.rho0_d = float(rho.d[0])
                        c.rho0_iono = float(rho.iono_delay[0])
                        r_xyz = float(rho.range[0])

                        rho_ref = compute_range(
                            eph,
                            ionoutc,
                            grx.week,
                            grx.sec,
                            np.zeros(3),
                            np.array([sv]),
                        )
                        r_ref = float(rho_ref.range[0])

                        phase_ini = (2.0 * r_ref - r_xyz) / LAMBDA_L1
                        c.carr_phase = phase_ini - math.floor(phase_ini)
                        c.carr_phase_i = int(
                            512.0 * 65536.0 * (phase_ini - math.floor(phase_ini))
                        )
                        self.allocated_sat[sv] = slot
            elif self.allocated_sat[sv] >= 0:
                # Not visible but allocated: free the slot.
                self.chan[int(self.allocated_sat[sv])].prn = 0
                self.allocated_sat[sv] = -1
        return nsat

    def prn_array(self) -> np.ndarray:
        return np.array([c.prn for c in self.chan], dtype=np.int32)

    def ca_chips(self) -> np.ndarray:
        """int8[num_channels, 1023] chips for active channels (zeros if free)."""
        out = np.zeros((self.num_channels, 1023), dtype=np.int8)
        table = ca_table()
        for i, c in enumerate(self.chan):
            if c.prn > 0:
                out[i] = table[c.prn - 1]
        return out

    def dwrd_array(self) -> np.ndarray:
        return np.stack(
            [c.dwrd for c in self.chan],
            axis=0,
        ).astype(np.uint32)
