"""The plain reference against the port, on the CPU, for a few blocks of
each configuration: the plans, the phase recurrences, and the bytes."""

import os

import numpy as np
import pytest
import torch

from benchmark.fingerprint import fingerprint, fingerprints
from benchmark.reference import planner, seqwalk, synth
from benchmark.reference.core.gpstime import DateTime as RefDate

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAV = os.path.join(ROOT, "benchmark", "data", "brdc_daily.22n")
ALM = os.path.join(ROOT, "benchmark", "data", "almanac_test.sem")
# 08:21:50 at Paris: the first 30 s boundary falls after block 100 and
# brings a newly visible satellite into a channel
START = (2022, 1, 1, 8, 21, 50.0)
WHERE = (48.85, 2.35, 35.0)


def port_sim(parity, rate=3_000_000, interactive=False, edits=None):
    from gpssim_tpu_torch.config import LocationConfig, SimConfig
    from gpssim_tpu_torch.core.gpstime import DateTime
    from gpssim_tpu_torch.scenario import Simulation

    cfg = SimConfig(nav_file=NAV, almanac_file=ALM, start=DateTime(*START),
                    duration_sec=600.0, location=LocationConfig(*WHERE),
                    sample_rate=rate, parity_exact=parity,
                    interactive=interactive, device="cpu")

    class Replayed(Simulation):
        def step(self):
            for kw in (edits or {}).get(self.next_block_index, ()):
                self.set_motion(**kw)
            return super().step()

    return Replayed(cfg)


def reference(parity, rate=3_000_000, interactive=False, edits=None):
    return planner.Planner(planner.Receiver(
        nav_file=NAV, start=RefDate(*START), lat=WHERE[0], lon=WHERE[1],
        height=WHERE[2], sample_rate=rate, almanac_file=ALM,
        interactive=interactive, parity_exact=parity, edits=edits or {}))


def native_available():
    from gpssim_tpu_torch.ops.synth_seq import seq_available

    return seq_available()


FIELDS = ("active", "code_phase", "f_code", "f_carr", "gain", "iword",
          "ibit", "icode", "prn", "ca", "dwrd")


def c_code_walk(x, d, n):
    vals, wraps, w = [x], [0], 0
    for _ in range(n):
        x = x + d
        if x >= 1023.0:
            x = x - 1023.0
            w += 1
        vals.append(x)
        wraps.append(w)
    return vals, wraps


def c_carrier_walk(x, d, n):
    vals = [x]
    for _ in range(n):
        x = x + d
        if x >= 1.0:
            x = x - 1.0
        elif x < 0.0:
            x = x + 1.0
        vals.append(x)
    return vals


@pytest.mark.parametrize("seed", range(6))
def test_seqwalk_replays_the_c_recurrences(seed):
    rng = np.random.default_rng(seed)
    n = 7000
    x0, d = rng.uniform(0, 1023), rng.uniform(0.3, 1.0)
    vals, wraps = seqwalk.code_walk(x0, d, n)
    want_v, want_w = c_code_walk(x0, d, n)
    assert vals.tolist() == want_v and wraps.tolist() == want_w
    p0 = rng.uniform(0, 1)
    dp = rng.choice([-1, 1]) * rng.uniform(1e-4, 2e-3)
    assert seqwalk.carrier_walk(p0, dp, n).tolist() == c_carrier_walk(
        p0, dp, n)
    assert seqwalk.carrier_end(p0, dp, n) == c_carrier_walk(p0, dp, n)[-1]


@pytest.mark.parametrize("parity", [True, False])
def test_planner_matches_the_port_across_a_boundary(parity):
    sim, ref = port_sim(parity), reference(parity)
    e_blk = (300_000 + 64) * 2.0**-53 + 2.0**-40
    fresh_after = []
    for _ in range(130):
        p, q = sim.step(), ref.next_plan()
        for f in FIELDS:
            assert np.array_equal(getattr(p, f), getattr(q, f)), f
        on = q.active
        if parity:
            d = p.carr_phase[on] - q.carr_phase[on]
            d -= np.round(d)
            assert np.all(np.abs(d) <= q.since[on] * e_blk)
            assert np.array_equal(p.carr_phase[q.fresh],
                                  q.carr_phase[q.fresh])
        else:
            assert np.array_equal(p.carr_phase[on], q.carr_phase[on])
        if q.index > 1 and q.fresh.any():
            fresh_after.append(q.index)
    assert fresh_after, "no reallocation in the planned span"


@pytest.mark.parametrize("parity", [True, False])
def test_interactive_planner_replays_edits(parity):
    edits = {3: [{"bearing_deg": 45.0}], 7: [{"velocity": 30.0}],
             8: [{"vertical_speed": 4.0}, {"velocity": 12.5}]}
    sim = port_sim(parity, interactive=True, edits=edits)
    ref = reference(parity, interactive=True, edits=edits)
    for _ in range(20):
        p, q = sim.step(), ref.next_plan()
        for f in FIELDS:
            assert np.array_equal(getattr(p, f), getattr(q, f)), f
    assert ref.interactive.velocity == 12.5


def test_strict_bytes_equal_the_native_sequential_replay():
    if not native_available():
        pytest.skip("the port's native engine is not built")
    from gpssim_tpu_torch.ops.synth_seq import synth_block_seq_native

    sim, ref = port_sim(True), reference(True)
    plans = [(sim.step(), ref.next_plan()) for _ in range(103)]
    picked = [plans[i] for i in (0, 1, 101, 102)]
    out, _ = synth.synth_bytes([q for _, q in picked],
                               np.stack([p.carr_phase for p, _ in picked]),
                               "cpu")
    for (p, _), row in zip(picked, out.numpy()):
        assert np.array_equal(row, synth_block_seq_native(p, bits=8))


def port_plain_bytes(plans):
    """The port's plain PyTorch kernel on its own packed arguments."""
    from gpssim_tpu_torch.ops.args import (LANES, collate_plans,
                                           needs_wide_window, pack_args,
                                           unpack_args)
    from gpssim_tpu_torch.ops.synth_torch import synth_blocks_batch_torch

    packed, spec = pack_args(collate_plans(plans, compact=True,
                                           compact_multiple=4).args)
    n = plans[0].num_samples
    return synth_blocks_batch_torch(
        unpack_args(torch.from_numpy(packed), spec),
        n_rows=-(-n // LANES), num_samples=n, out_bits=8,
        wide=needs_wide_window(plans[0].delt)).numpy()


@pytest.mark.parametrize("rate", [3_000_000, 1_030_000])
def test_closed_form_bytes_equal_the_port_plain_kernel(rate):
    sim, ref = port_sim(False, rate), reference(False, rate)
    plans = [(sim.step(), ref.next_plan()) for _ in range(103)]
    picked = [plans[i] for i in (0, 57, 101, 102)]
    want = port_plain_bytes([p for p, _ in picked])
    qs = [q for _, q in picked]
    got = synth.fixed_point_bytes(qs, np.stack([q.carr_phase for q in qs]),
                                  "cpu").numpy()
    assert np.array_equal(got, want)
    low = synth.fixed_point_bytes(qs, np.stack([q.carr_phase for q in qs]),
                                  "cpu", dtype=torch.float32).numpy()
    assert all(not np.array_equal(a, b) for a, b in zip(low, want))


def test_fingerprint_sees_every_single_byte_change():
    rng = np.random.default_rng(7)
    block = rng.integers(-128, 128, 600_000, dtype=np.int8)
    base = fingerprint(block)
    for pos in (0, 1, 7, 8, 12345, 599_999):
        for delta in (1, -128, 77):
            changed = block.copy()
            changed[pos] = np.int8((int(changed[pos]) + delta + 128) % 256
                                   - 128)
            if changed[pos] != block[pos]:
                assert fingerprint(changed) != base
    rows = rng.integers(-128, 128, (3, 6000), dtype=np.int8)
    assert fingerprints(torch.from_numpy(rows)) == [fingerprint(r)
                                                    for r in rows]
