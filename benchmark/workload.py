"""The one traffic generator: a configuration, a traffic mix and a seed in,
the program's inputs out.

A configuration (``configs/<name>.json``) fixes the deployment: sample
rate and format, channels, models, guarantees, members. A traffic mix
(``traffic/<name>.json``) fixes how it is driven: offline or live, the
scenario's length, the ranges the seed draws from, the keys and their
rate. The seed draws, for every member, the start time within the nav
file's day and the receiver's latitude, longitude and height; in a live
mix, the order of the keys and of their gaps. Every seed gets the same
amount of work: a draw is kept only where the receiver sees at least
``num_channels`` satellites at the start and every ``full_step_s`` for
``full_for_s`` after it (every channel busy for as long as a window can
record), and the gaps and keys are fixed multisets whose order the seed
permutes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from .reference.core.ephemeris import read_rinex_nav, select_ephemeris_set
from .reference.core.gpstime import DateTime, date2gps, inc_gps_time
from .reference.core.motion import static_xyz
from .reference.core.orbits import check_sat_visibility

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as fp:
        return json.load(fp)


def data_path(rel: str) -> str:
    """A path in a configuration file, relative to the checkout root."""
    return os.path.join(os.path.dirname(HERE), rel)


@dataclass
class Member:
    start: DateTime
    lat: float
    lon: float
    height: float


@dataclass
class Inputs:
    config: dict
    traffic: dict
    seed: int
    members: list
    #: live mixes: (seconds after the window opens, key) in send order
    keys: list = field(default_factory=list)


def _visible(nav, when: DateTime, xyz) -> int:
    g = date2gps(when)
    ieph = select_ephemeris_set(nav, g)
    if ieph < 0:
        return 0
    state, _ = check_sat_visibility(nav.sets[ieph], g.sec, xyz, 0.0)
    return int(np.sum(state == 1))


def _date(day: DateTime, seconds: int) -> DateTime:
    return DateTime(day.y, day.m, day.d, seconds // 3600,
                    (seconds % 3600) // 60, float(seconds % 60))


def _later(when: DateTime, seconds: float) -> DateTime:
    from .reference.core.gpstime import gps2date

    return gps2date(inc_gps_time(date2gps(when), seconds))


def generate(config: dict, traffic: dict, seed: int) -> Inputs:
    rng = np.random.default_rng(int(seed))
    nav = read_rinex_nav(data_path(config["nav_file"]), version=2)
    day = DateTime(*traffic["day"], 0, 0, 0.0)
    lo, hi = traffic["start_s"]
    off_lo, off_hi = traffic["offset_in_30s"]
    lat_r, lon_r, h_r = (traffic["lat"], traffic["lon"],
                         traffic["height_m"])
    need = config["num_channels"]
    members = []
    for _ in range(config["members"]):
        while True:
            slot = int(rng.integers(lo // 30, hi // 30))
            start = _date(day, slot * 30 + int(rng.integers(off_lo,
                                                            off_hi + 1)))
            lat = float(rng.uniform(*lat_r))
            lon = float(rng.uniform(*lon_r))
            h = float(rng.uniform(*h_r))
            xyz = static_xyz(lat, lon, h)
            if all(_visible(nav, _later(start, t), xyz) >= need
                   for t in range(0, traffic["full_for_s"] + 1,
                                  traffic["full_step_s"])):
                break
        members.append(Member(start, round(lat, 6), round(lon, 6),
                              round(h, 2)))
    keys = []
    if traffic["mode"] == "live":
        m = traffic["gap_levels"]
        # gaps spread evenly over [0.5, 1.5] / rate: mean 1 / rate
        gaps = (0.5 + (np.arange(m) + 0.5) / m) / traffic["keys_per_s"]
        gap_q, key_q, t = [], [], 0.0
        for _ in range(traffic["max_keys"]):
            if not gap_q:
                gap_q = [float(g) for g in rng.permutation(gaps)]
            if not key_q:
                key_q = [str(k) for k in rng.permutation(
                    list(traffic["keys"]))]
            t += gap_q.pop()
            keys.append((t, key_q.pop()))
    return Inputs(config, traffic, int(seed), members, keys)


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a well-spread 64-bit hash of ``x``."""
    x &= 2**64 - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return x ^ (x >> 31)


def compare_rule(inputs: Inputs, member: int):
    """Which blocks of a member the check compares, fixed before the run
    from the seed: the first two, the three around each 30 s boundary
    (nav words regenerated, channels reallocated), and one in
    ``compare_every`` of the rest, drawn by a hash of the seed and the
    block index (1 = the first block)."""
    every = int(inputs.traffic["compare_every"])
    igrx0 = int(date2gps(inputs.members[member].start).sec * 10.0 + 0.5)
    key = _mix64(inputs.seed * 64 + member)

    def chosen(k: int) -> bool:
        if k <= 2 or every <= 1 or (igrx0 + k) % 300 in (0, 1, 2):
            return True
        return _mix64(key ^ k) % every == 0

    return chosen
