"""The port's collation engine (``ops/collate.cc`` behind
``ops/args.collate_plans``) against the plain NumPy collation and the JAX
package's.

The engine collates and packs a window of block plans in one call. Its
packed int32 window and spec must be byte-equal to ``pack_args`` of the
NumPy path (the compaction below, then ``args_from_arrays``) and to the
JAX package's ``parallel/blocks.collate_plans`` + ``pack_args``; it must
fold a boundary Q44 gain as ``_fold_exact`` does and raise the NumPy
path's errors at the same inputs. ``RunStats.gain_folds`` counts the folds
in both pipeline loops.
"""

import dataclasses
import itertools
import re

import numpy as np
import pytest
import torch

from gpssim_tpu.parallel import blocks as jblocks
from gpssim_tpu_torch import fleet
from gpssim_tpu_torch.config import (
    CarrierMode, LocationConfig, SimConfig, SynthBackend,
)
from gpssim_tpu_torch.core.constants import CODE_FREQ
from gpssim_tpu_torch.io.sinks import NullSink
from gpssim_tpu_torch.ops import args as targs
from gpssim_tpu_torch.ops.plan import BlockPlan
from gpssim_tpu_torch.runner import run_simulation
from gpssim_tpu_torch.scenario import Simulation

#: 250 * g = 100 + 1e-13, which the plain Q44 split truncates to 99
BOUNDARY = (100.0 + 1e-13) / 250.0
_FIELDS = ("active", "code_phase", "f_code", "carr_phase", "f_carr",
           "carr_phase_i", "carr_step_i", "gain", "iword", "ibit", "icode",
           "prn", "dwrd")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_collate(plans, int_nco=False, compact=True, compact_multiple=1):
    """(packed, spec) of the plain NumPy collation: the plans stacked, each
    block's active slots first (a stable argsort), the channel axis cut to
    the window's largest active count, then ``args_from_arrays`` and
    ``pack_args``."""
    fields = {n: np.stack([getattr(p, n) for p in plans]) for n in _FIELDS}
    if compact:
        act = fields["active"]
        k = max(1, int(act.sum(axis=1).max()))
        if compact_multiple > 1:
            k = min(-(-k // compact_multiple) * compact_multiple,
                    act.shape[1])
        order = np.argsort(~act, axis=1, kind="stable")[:, :k]
        for n, v in fields.items():
            idx = order[..., None] if v.ndim == 3 else order
            fields[n] = np.take_along_axis(v, idx, axis=1)
    args = targs.args_from_arrays(
        *(fields[n] for n in _FIELDS), plans[0].num_samples, plans[0].delt,
        int_nco=int_nco)
    return targs.pack_args(args)


def jax_collate(plans, **kw):
    return jblocks.pack_args(jblocks.collate_plans(plans, **kw).args)


def _outcome(fn, *a, **kw):
    """``fn``'s (packed, spec), or its exception's type and message."""
    try:
        return fn(*a, **kw)
    except (ValueError, IndexError) as e:
        return type(e), str(e)


def engine(plans, **kw):
    b = targs.collate_plans(plans, **kw)
    return b.packed, b.spec


def _assert_same(want, got):
    if isinstance(want[0], type):  # an error
        assert got == want
        return
    wp, wspec = want
    gp, gspec = got
    assert gspec == wspec
    assert gp.dtype == wp.dtype == np.int32
    assert gp.shape == wp.shape and np.array_equal(gp, wp)


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

_PLANS: dict = {}


def _fixture_plans(fixtures_dir, **kw):
    """The plans of the 1.5 s fixture scenario (14 blocks)."""
    key = tuple(sorted(kw.items()))
    if key not in _PLANS:
        cfg = SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                        duration_sec=1.5, almanac_enable=False, **kw)
        _PLANS[key] = list(Simulation(cfg).iter_plans())
    return _PLANS[key]


def _fleet_window(fixtures_dir):
    """One 25-block window of an 8-member fleet, round robin."""
    base = SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                     duration_sec=0.5, almanac_enable=False,
                     parity_exact=False)
    rng = np.random.default_rng(8)
    sims = [Simulation(dataclasses.replace(base, location=LocationConfig(
        float(rng.uniform(20, 50)), float(rng.uniform(100, 150)),
        float(rng.uniform(0, 500))))) for _ in range(8)]
    tagged = list(itertools.islice(fleet._interleave_plans(sims), 25))
    assert len({m for m, _ in tagged}) == 8
    return [p for _, p in tagged]


def _negative_doppler(plans):
    out = []
    for p in plans:
        f = np.where(p.active, -np.abs(p.f_carr) - 1234.5, p.f_carr)
        out.append(dataclasses.replace(p, f_carr=f))
    assert any(np.any(p.f_carr < 0) for p in out)
    return out


def _window(case, fixtures_dir):
    """(plans, collate keyword arguments) of a named window."""
    if case == "compact":
        return _fixture_plans(fixtures_dir), dict(compact=True)
    if case == "full":
        return _fixture_plans(fixtures_dir), dict(compact=False)
    if case == "multiple4":
        return _fixture_plans(fixtures_dir), dict(compact_multiple=4)
    if case == "int_nco":
        return (_fixture_plans(fixtures_dir, carrier_mode=CarrierMode.INT_NCO),
                dict(int_nco=True, compact_multiple=4))
    if case == "wide_1.2msps":
        return (_fixture_plans(fixtures_dir, sample_rate=1_200_000),
                dict(compact_multiple=4))
    if case == "padded_tail":
        plans = _fixture_plans(fixtures_dir)[:3]
        return plans + [plans[-1]] * 22, dict(compact_multiple=4)
    if case == "fleet8":
        return _fleet_window(fixtures_dir), dict(compact_multiple=4)
    if case == "strict":
        plans = _fixture_plans(fixtures_dir, parity_exact=True,
                               carrier_mode=CarrierMode.FLOAT)
        return plans, dict(compact_multiple=4)
    if case == "negative_doppler":
        return (_negative_doppler(_fixture_plans(fixtures_dir)),
                dict(compact_multiple=4))
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "compact", "full", "multiple4", "int_nco", "wide_1.2msps", "padded_tail",
    "fleet8", "strict", "negative_doppler",
])
def test_engine_equals_numpy_and_jax(fixtures_dir, case):
    plans, kw = _window(case, fixtures_dir)
    got = engine(plans, **kw)
    _assert_same(numpy_collate(plans, **kw), got)
    _assert_same(jax_collate(plans, **kw), got)
    batch = targs.collate_plans(plans, **kw)
    assert batch.n_blocks == len(plans)
    assert batch.num_samples == plans[0].num_samples
    assert batch.folds.shape == (len(plans),) and not batch.folds.any()
    # the fields the mesh path reads are views of the packed window
    want = jblocks.collate_plans(plans, **kw).args
    assert sorted(batch.args) == sorted(want)
    for k, v in want.items():
        g = batch.args[k]
        assert np.shares_memory(g, batch.packed), k
        assert g.dtype == v.dtype and np.array_equal(g, v), k
    packed, spec = targs.pack_args(batch)  # packed already: no copy
    assert packed is batch.packed and spec == batch.spec


_ZERO_CA = np.zeros((16, 1023), np.int8)


def _fuzz_window(rng):
    """A window of random plans: phases, Dopplers, gains (some on a
    carrier-table magnitude's boundary), data-bit positions, inactive
    slots holding stale values, rates down to the 128-chip window."""
    rate = int(rng.choice([3_000_000, 2_600_000, 1_200_000, 1_030_000]))
    n, delt = rate // 10, 1.0 / rate
    B, C = int(rng.integers(1, 31)), int(rng.choice([4, 12, 16]))
    plans = []
    for _ in range(B):
        active = rng.random(C) < 0.8
        f_carr = rng.uniform(-6000.0, 6000.0, C)
        gain = rng.uniform(0.0, 2.0, C)
        edge = rng.random(C) < 0.2
        T = rng.choice(targs._LUT_MAGS, C)
        gain[edge] = (np.floor(T * gain)[edge] + 1e-13) / T[edge]
        plans.append(BlockPlan(
            num_samples=n, delt=delt, active=active,
            code_phase=rng.uniform(0.0, 1023.0, C),
            f_code=CODE_FREQ + f_carr / 1540.0,
            carr_phase=rng.uniform(0.0, 1.0, C), f_carr=f_carr,
            carr_phase_i=rng.integers(0, 1 << 32, C, dtype=np.uint32),
            carr_step_i=rng.integers(-(1 << 21), 1 << 21, C,
                                     dtype=np.int32),
            gain=gain, iword=rng.integers(0, 58, C),
            ibit=rng.integers(0, 30, C), icode=rng.integers(0, 20, C),
            prn=rng.integers(1, 33, C), ca=_ZERO_CA[:C],
            dwrd=rng.integers(0, 1 << 30, (C, 60), dtype=np.uint32)))
    kw = dict(int_nco=bool(rng.random() < 0.3),
              compact=bool(rng.random() < 0.7),
              compact_multiple=int(rng.choice([1, 2, 4, 8])))
    return plans, kw


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_engine_equals_numpy_and_jax_fuzz(seed):
    """80 random windows a seed: the engine's window (or error) is the
    NumPy path's, and the JAX package's wherever nothing was folded (the
    JAX package raises on a gain that needs a fold)."""
    rng = np.random.default_rng(seed)
    folded = 0
    for _ in range(80):
        plans, kw = _fuzz_window(rng)
        got = _outcome(engine, plans, **kw)
        _assert_same(_outcome(numpy_collate, plans, **kw), got)
        assert not isinstance(got[0], type)
        n = int(targs.collate_plans(plans, **kw).folds.sum())
        folded += n
        if n == 0:
            _assert_same(jax_collate(plans, **kw), got)
    assert folded > 0  # the fold ran


# ---------------------------------------------------------------------------
# The fold and the errors
# ---------------------------------------------------------------------------


def _first_plan(fixtures_dir):
    return _fixture_plans(fixtures_dir)[0]


def test_boundary_gain_folds_as_fold_exact(fixtures_dir):
    """g = (100 + 1e-13)/250 (test_q44_gain_screen_catches_boundary_gain)
    gets _fold_exact's gain_a and gain_b, as in the NumPy path, and counts
    one fold; a physical window counts none."""
    plan = _first_plan(fixtures_dir)
    c = int(np.argmax(plan.active))
    g = plan.gain.copy()
    g[c] = BOUNDARY
    bad = dataclasses.replace(plan, gain=g)
    window = [plan, bad, plan]
    batch = targs.collate_plans(window, compact=False)
    assert batch.folds.tolist() == [0, 1, 0]
    ga, gb = targs._fold_exact(BOUNDARY)
    assert (batch.args["gain_a"][1, c], batch.args["gain_b"][1, c]) == (ga,
                                                                        gb)
    want = targs.plan_to_args(bad)
    assert np.array_equal(batch.args["gain_a"][1], want["gain_a"])
    assert np.array_equal(batch.args["gain_b"][1], want["gain_b"])
    _assert_same(numpy_collate(window, compact=False),
                 (batch.packed, batch.spec))
    assert not targs.collate_plans([plan] * 3).folds.any()


def _broken(plan, case):
    """``plan`` changed so that the collation raises ``case``'s error."""
    c = int(np.argmax(plan.active))

    def at(name, value):
        v = getattr(plan, name).copy()
        v[c] = value
        return dataclasses.replace(plan, **{name: v})

    if case == "q46":  # step * N >= 2^17
        return at("f_code", 1.4e6), targs._Q46_RANGE
    if case == "row_window":  # below ~1.03 Msps: 127 steps reach 127 chips
        return (dataclasses.replace(plan, delt=1e-6, num_samples=100_000),
                targs._ROW_WINDOW)
    if case == "bit_window":  # the code wraps past the 8-bit window
        return at("code_phase", 50_000.0), targs._BIT_WINDOW
    if case == "nav_buffer":  # bit 29 of word 59 plus 7 bits
        return (dataclasses.replace(at("iword", 59), ibit=np.where(
            np.arange(len(plan.active)) == c, 29, plan.ibit)),
            targs._NAV_BUFFER)
    if case == "no_gain":  # fl(5g) = 2 - 2^-52, fl(50g) = 20
        return (at("gain", 0.39999999999999997),
                targs._no_gain(0.39999999999999997))
    raise KeyError(case)


@pytest.mark.parametrize("case", ["q46", "row_window", "bit_window",
                                  "nav_buffer", "no_gain"])
def test_engine_raises_the_numpy_errors(fixtures_dir, case):
    """Each error, with its message, where the NumPy path raises it: a
    window takes its rate from its first plan, so a slow plan after the
    first raises nothing in either."""
    plan = _first_plan(fixtures_dir)
    bad, message = _broken(plan, case)
    with pytest.raises(ValueError, match=re.escape(message)):
        targs.plan_to_args(bad)
    with pytest.raises(ValueError, match=re.escape(message)):
        targs.collate_plans([bad])
    for window in ([bad], [bad, plan, plan], [plan, bad, plan]):
        for kw in (dict(compact=False), dict(compact_multiple=4)):
            _assert_same(_outcome(numpy_collate, window, **kw),
                         _outcome(engine, window, **kw))


# ---------------------------------------------------------------------------
# RunStats.gain_folds
# ---------------------------------------------------------------------------


class BoundaryAt(Simulation):
    """A Simulation whose block ``at`` carries BOUNDARY on its first
    active channel."""

    def __init__(self, cfg, at):
        super().__init__(cfg)
        self.at = at

    def step(self):
        index = self.next_block_index
        plan = super().step()
        if plan is not None and index == self.at:
            g = plan.gain.copy()
            g[int(np.argmax(plan.active))] = BOUNDARY
            plan = dataclasses.replace(plan, gain=g)
        return plan


def _cfg(fixtures_dir, **kw):
    return SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                     duration_sec=0.3, almanac_enable=False,
                     sample_rate=1_030_000, parity_exact=False,
                     backend=SynthBackend.CUDA, device="cpu", **kw)


@pytest.mark.parametrize("boundary", [False, True])
def test_gain_folds_counted_by_run_simulation(fixtures_dir, boundary):
    cfg = _cfg(fixtures_dir)
    sim = Simulation(cfg)
    if boundary:
        sim = BoundaryAt(cfg, sim.next_block_index + 1)
    stats = run_simulation(cfg, sink=NullSink(), sim=sim)
    assert stats.blocks == 2
    assert stats.gain_folds == int(boundary)


@pytest.mark.parametrize("boundary", [False, True])
def test_gain_folds_counted_by_run_fleet(fixtures_dir, boundary):
    cfgs = [_cfg(fixtures_dir, location=LocationConfig(35.68, 139.77, 10.0)),
            _cfg(fixtures_dir, location=LocationConfig(48.86, 2.29, 35.0))]
    sims = [Simulation(cfgs[0]), Simulation(cfgs[1])]
    if boundary:
        sims[1] = BoundaryAt(cfgs[1], sims[1].next_block_index)
    stats = fleet.run_fleet(cfgs, sinks=[NullSink(), NullSink()], sims=sims)
    assert [s.blocks for s in stats] == [2, 2]
    assert [s.gain_folds for s in stats] == [0, int(boundary)]
