"""Checkpoint / resume of a running scenario.

The reference has no checkpointing, but its full generator state is tiny
and explicit: per-channel ``channel_t`` (gps.h:213-236) plus grx, the
ephemeris-set index, and the trajectory cursor (SURVEY §5). That struct is
the snapshot schema here: a resumed run produces the exact remaining sample
stream, bit-for-bit, because every per-sample value derives from this state.

Snapshots are a single ``.npz`` holding the config (JSON) and flat arrays —
no pickle, so files are portable and inspectable.
"""

from __future__ import annotations

import dataclasses
import enum
import json

import numpy as np

from .config import (
    CarrierMode,
    LocationConfig,
    SampleFormat,
    SimConfig,
    SynthBackend,
    TargetConfig,
)
from .core.constants import N_DWRD_SBF, N_SBF_PAGE
from .core.gpstime import DateTime, GpsTime

_CHAN_SCALARS = (
    # (field, dtype) — everything in channel_t that is not an array
    ("prn", np.int64),
    ("f_carr", np.float64),
    ("f_code", np.float64),
    ("carr_phase", np.float64),
    ("carr_phase_i", np.int64),
    ("carr_phasestep_i", np.int64),
    ("code_phase", np.float64),
    ("ipage", np.int64),
    ("iword", np.int64),
    ("ibit", np.int64),
    ("icode", np.int64),
    ("data_bit", np.int64),
    ("code_ca", np.int64),
    ("rho0_range", np.float64),
    ("rho0_rate", np.float64),
    ("rho0_d", np.float64),
    ("rho0_iono", np.float64),
)


def _config_to_json(cfg: SimConfig) -> str:
    def enc(v):
        if isinstance(v, enum.Enum):
            return v.value
        if dataclasses.is_dataclass(v):
            return {f.name: enc(getattr(v, f.name)) for f in dataclasses.fields(v)}
        return v

    return json.dumps(
        {f.name: enc(getattr(cfg, f.name)) for f in dataclasses.fields(SimConfig)}
    )


def _config_from_json(s: str) -> SimConfig:
    raw = json.loads(s)
    cfg = SimConfig()
    for k, v in raw.items():
        if k == "sample_format":
            v = SampleFormat(v)
        elif k == "carrier_mode":
            v = CarrierMode(v)
        elif k == "backend":
            # A checkpoint written by the JAX package names its device
            # backends jax/pallas; both resume on the CUDA kernel here.
            v = SynthBackend("cuda" if v in ("jax", "pallas") else v)
        elif k == "location":
            v = LocationConfig(**v)
        elif k == "target":
            v = TargetConfig(**v)
        elif k == "start" and v is not None:
            v = DateTime(**v)
        setattr(cfg, k, v)
    return cfg


def save_checkpoint(path: str, sim) -> None:
    """Snapshot a Simulation (scenario.Simulation) to ``path`` (.npz)."""
    write_state(path, capture_state(sim))


def capture_state(sim) -> dict:
    """In-memory snapshot of the full generator state (~a few KB).

    Cheap enough to capture at every dispatch boundary; the pipelined
    runner captures right after planning a batch so the snapshot it hands
    to checkpoint hooks matches the blocks actually written, even while
    the planner runs ahead (see runner._run_batched)."""
    # The windowed planner defers channel write-back (scenario.py
    # _sync_channels); materialize it so the snapshot sees live state.
    sync = getattr(sim, "_sync_channels", None)
    if sync is not None:
        sync()
    chans = sim.channels.chan
    C = len(chans)
    arrays: dict[str, np.ndarray] = {}

    for name, dtype in _CHAN_SCALARS:
        arrays[f"ch_{name}"] = np.array(
            [getattr(c, name) for c in chans], dtype=dtype
        )
    arrays["ch_g0_week"] = np.array([c.g0.week for c in chans], dtype=np.int64)
    arrays["ch_g0_sec"] = np.array([c.g0.sec for c in chans], dtype=np.float64)
    arrays["ch_rho0_week"] = np.array(
        [c.rho0_g.week for c in chans], dtype=np.int64
    )
    arrays["ch_rho0_sec"] = np.array(
        [c.rho0_g.sec for c in chans], dtype=np.float64
    )
    arrays["ch_azel"] = np.array([c.azel for c in chans], dtype=np.float64)
    arrays["ch_dwrd"] = sim.channels.dwrd_array()
    sbf = np.zeros((C, N_SBF_PAGE, N_DWRD_SBF), dtype=np.uint64)
    for i, c in enumerate(chans):
        if c.sbf is not None:
            sbf[i] = c.sbf
    arrays["ch_sbf"] = sbf
    arrays["ch_has_sbf"] = np.array(
        [c.sbf is not None for c in chans], dtype=bool
    )
    arrays["allocated_sat"] = sim.channels.allocated_sat.copy()

    arrays["grx"] = np.array([sim.grx.week, sim.grx.sec], dtype=np.float64)
    arrays["g0"] = np.array([sim.g0.week, sim.g0.sec], dtype=np.float64)
    arrays["ieph"] = np.array(sim.ieph, dtype=np.int64)
    arrays["iumd"] = np.array(sim._iumd, dtype=np.int64)
    arrays["xyz_prev"] = np.array(sim._xyz_prev, dtype=np.float64)
    arrays["interactive"] = np.array(
        [
            sim.interactive.bearing_millideg,
            sim.interactive.velocity,
            sim.interactive.vertical_speed,
        ],
        dtype=np.float64,
    )
    arrays["config_json"] = np.array(_config_to_json(sim.cfg))
    return arrays


def write_state(path: str, state: dict) -> None:
    with open(path, "wb") as fp:
        np.savez(fp, **state)


def _restore(z, p: str = ""):
    """Rebuild (SimConfig, Simulation) from snapshot arrays with key
    prefix ``p`` ('' for a single-scenario file, 'mN_' for fleet member
    N)."""
    from .scenario import Simulation

    cfg = _config_from_json(str(z[f"{p}config_json"]))
    sim = Simulation(cfg)

    for i, c in enumerate(sim.channels.chan):
        for name, _ in _CHAN_SCALARS:
            v = z[f"{p}ch_{name}"][i]
            setattr(c, name, type(getattr(c, name))(v))
        c.g0 = GpsTime(
            int(z[f"{p}ch_g0_week"][i]), float(z[f"{p}ch_g0_sec"][i])
        )
        c.rho0_g = GpsTime(
            int(z[f"{p}ch_rho0_week"][i]), float(z[f"{p}ch_rho0_sec"][i])
        )
        c.azel = tuple(z[f"{p}ch_azel"][i])
        c.dwrd = z[f"{p}ch_dwrd"][i].copy()
        c.sbf = (
            z[f"{p}ch_sbf"][i].copy() if z[f"{p}ch_has_sbf"][i] else None
        )
    sim.channels.allocated_sat = z[f"{p}allocated_sat"].copy()

    sim.grx = GpsTime(int(z[f"{p}grx"][0]), float(z[f"{p}grx"][1]))
    sim.g0 = GpsTime(int(z[f"{p}g0"][0]), float(z[f"{p}g0"][1]))
    sim.ieph = int(z[f"{p}ieph"])
    sim._iumd = int(z[f"{p}iumd"])
    sim._xyz_prev = z[f"{p}xyz_prev"].copy()
    ia = z[f"{p}interactive"]
    sim.interactive.bearing_millideg = float(ia[0])
    sim.interactive.velocity = float(ia[1])
    sim.interactive.vertical_speed = float(ia[2])
    return cfg, sim


def load_checkpoint(path: str):
    """Load a snapshot → (SimConfig, Simulation positioned to continue)."""
    z = np.load(path, allow_pickle=False)
    if "fleet_n" in z:
        raise ValueError(
            f"{path} is a FLEET checkpoint "
            f"({int(z['fleet_n'])} members) — load it with "
            "load_fleet_checkpoint / resume it through run_fleet"
        )
    return _restore(z)


def is_fleet_checkpoint(path: str) -> bool:
    with np.load(path, allow_pickle=False) as z:
        return "fleet_n" in z


def capture_fleet_state(sims, blocks) -> dict:
    """Snapshot of every member of a fleet (checkpoint schema = the
    single-scenario channel_t schema per member, keys prefixed mN_),
    plus the per-member written-block counts the snapshot corresponds
    to (VERDICT r4 item 4)."""
    out = {
        "fleet_n": np.array(len(sims), dtype=np.int64),
        "fleet_blocks": np.array(blocks, dtype=np.int64),
    }
    for i, sim in enumerate(sims):
        for k, v in capture_state(sim).items():
            out[f"m{i}_{k}"] = v
    return out


def load_fleet_checkpoint(path: str):
    """Load a fleet snapshot → (cfgs, sims, blocks): one restored
    Simulation per member, positioned to continue, and the per-member
    block counts already written when the snapshot was taken."""
    z = np.load(path, allow_pickle=False)
    if "fleet_n" not in z:
        raise ValueError(
            f"{path} is a single-scenario checkpoint — load it with "
            "load_checkpoint"
        )
    n = int(z["fleet_n"])
    cfgs, sims = [], []
    for i in range(n):
        cfg, sim = _restore(z, f"m{i}_")
        cfgs.append(cfg)
        sims.append(sim)
    return cfgs, sims, z["fleet_blocks"].copy()
