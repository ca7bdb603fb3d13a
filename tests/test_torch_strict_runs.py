"""Strict-parity runs of the port's device path (the kernel's plain
version, ``backend=cuda`` on the CPU) through ``runner.run_simulation``
and ``fleet.run_fleet``: every block equals the sequential replay of its
plan (``synth_block_seq_native``, the native backend), and the
corrections' counters on ``RunStats`` agree with what was patched.

* Short real scenarios, one receiver and a fleet of two, in both carrier
  modes, against the native backend's run of each.
* The strict witnesses of ``tests/test_torch_strict_engine.py`` (blocks
  K1 got wrong with the float64-yardstick corrections) handed out by a
  planner as if they were the scenario's blocks: every block is patched
  and equals its replay; a closed-form run writes K1's own bytes and
  counts nothing.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gpssim_tpu_torch import fleet, runner
from gpssim_tpu_torch.config import (CarrierMode, LocationConfig, SimConfig,
                                     SynthBackend)
from gpssim_tpu_torch.io.sinks import NullSink
from gpssim_tpu_torch.ops.synth_seq import (seq_available,
                                            synth_block_seq_native)
from gpssim_tpu_torch.scenario import Simulation

from tests.test_torch_strict_engine import k1_bytes, witnesses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("correct_candidates", "correct_samples", "correct_blocks")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _engines():
    assert seq_available(), "g++ and tools/build_native.sh"


class CaptureSink(NullSink):
    def __init__(self):
        super().__init__()
        self.data = []

    def write(self, block):
        super().write(block)
        self.data.append(np.array(block))


def _cfg(nco: bool, **kw) -> SimConfig:
    base = dict(nav_file=os.path.join(REPO, "fixtures", "brdc_test.22n"),
                duration_sec=0.8, almanac_enable=False, dispatch_blocks=4,
                backend=SynthBackend.CUDA, device="cpu",
                carrier_mode=CarrierMode.INT_NCO if nco
                else CarrierMode.FLOAT)
    return SimConfig(**{**base, **kw})


def _native(cfg: SimConfig) -> list:
    sink = CaptureSink()
    runner.run_simulation(dataclasses.replace(cfg,
                                              backend=SynthBackend.NATIVE),
                          sink=sink)
    return sink.data


def _assert_counts(st) -> None:
    assert 0 <= st.correct_blocks <= st.blocks
    assert st.correct_samples >= st.correct_blocks
    assert st.correct_candidates >= st.correct_samples or (
        st.correct_samples == 0)
    assert st.correct_blocks == 0 or st.correct_samples > 0


@pytest.mark.parametrize("nco", [False, True], ids=["float", "int_nco"])
def test_run_simulation_equals_the_replay(nco):
    cfg = _cfg(nco)
    assert runner.strict_parity_enabled(cfg)
    sink = CaptureSink()
    st = runner.run_simulation(cfg, sink=sink)
    want = _native(cfg)
    assert st.blocks == len(want) == len(sink.data) == 7
    for got, w in zip(sink.data, want):
        assert np.array_equal(got, w)
    _assert_counts(st)
    assert st.correct_candidates > 0  # the screen walked somewhere


@pytest.mark.parametrize("nco", [False, True], ids=["float", "int_nco"])
def test_run_fleet_equals_the_replay(nco):
    cfgs = [_cfg(nco),
            _cfg(nco, location=LocationConfig(-33.8688, 151.2093, 58.0))]
    sinks = [CaptureSink() for _ in cfgs]
    stats = fleet.run_fleet(cfgs, sinks=sinks, window=4)
    for cfg, sink, st in zip(cfgs, sinks, stats):
        want = _native(cfg)
        assert st.blocks == len(want) == len(sink.data)
        for got, w in zip(sink.data, want):
            assert np.array_equal(got, w)
        _assert_counts(st)


def test_closed_form_counts_nothing():
    cfg = _cfg(False, parity_exact=False)
    assert not runner.strict_parity_enabled(cfg)
    st = runner.run_simulation(cfg, sink=NullSink())
    assert st.blocks == 7
    assert [getattr(st, k) for k in COUNTERS] == [0, 0, 0]


# ---------------------------------------------------------------------------
# the witnesses as a scenario's blocks
# ---------------------------------------------------------------------------


def _witness_sim(cfg: SimConfig, plans: list) -> Simulation:
    """A planner of ``cfg`` that hands out ``plans`` as its blocks."""

    class Witnesses(Simulation):
        def iter_plans(self):
            yield from plans

    return Witnesses(cfg)


def _witness_cfg(nco: bool, **kw) -> SimConfig:
    # the witnesses' deployment: 3 Msps, 12 channels, int8
    return _cfg(nco, sample_rate=3_000_000, num_channels=12,
                dispatch_blocks=2, **kw)


@pytest.mark.parametrize("nco", [False, True], ids=["float", "int_nco"])
def test_witnesses_through_run_simulation(nco):
    plans = [w[0] for w in witnesses() if w[1] == nco]
    cfg = _witness_cfg(nco)
    sink = CaptureSink()
    st = runner.run_simulation(cfg, sink=sink, sim=_witness_sim(cfg, plans))
    assert st.blocks == len(plans) == len(sink.data)
    for got, p in zip(sink.data, plans):
        assert np.array_equal(
            got, synth_block_seq_native(p, int_nco=nco, bits=8))
    assert st.correct_blocks == len(plans)
    _assert_counts(st)

    closed = _witness_cfg(nco, parity_exact=False)
    sink = CaptureSink()
    st = runner.run_simulation(closed, sink=sink,
                               sim=_witness_sim(closed, plans))
    assert [getattr(st, k) for k in COUNTERS] == [0, 0, 0]
    for got, p in zip(sink.data, plans):
        assert np.array_equal(got, k1_bytes(p, nco, 8))


def test_witnesses_through_run_fleet():
    plans = [w[0] for w in witnesses() if not w[1]]
    cfgs = [_witness_cfg(False), _witness_cfg(False)]
    parts = [plans[:2], plans[2:]]
    sinks = [CaptureSink() for _ in cfgs]
    stats = fleet.run_fleet(
        cfgs, sinks=sinks, window=2,
        sims=[_witness_sim(c, p) for c, p in zip(cfgs, parts)])
    for part, sink, st in zip(parts, sinks, stats):
        assert st.blocks == len(part) == len(sink.data)
        for got, p in zip(sink.data, part):
            assert np.array_equal(got, synth_block_seq_native(p, bits=8))
        assert st.correct_blocks == len(part)  # booked on its own member
        _assert_counts(st)
