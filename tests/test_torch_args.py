"""Host argument builder of the PyTorch/CUDA package against the JAX package.

The port keeps its own copies of the scenario planner and of the kernel
argument builder (``gpssim_tpu_torch.ops.args``). On the 1.5 s fixture
scenario both packages must plan the same blocks and collate and pack them
into the same int32 arrays, key for key, with no tolerance.
"""

import numpy as np
import pytest
import torch

from gpssim_tpu.config import CarrierMode as JCarrierMode
from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.ops import synth_jax as jsynth
from gpssim_tpu.parallel import blocks as jblocks
from gpssim_tpu.scenario import Simulation as JSimulation
from gpssim_tpu_torch.config import CarrierMode, SimConfig
from gpssim_tpu_torch.ops import args as targs
from gpssim_tpu_torch.scenario import Simulation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PLANS: dict = {}


def _plans(fixtures_dir, rate: int, int_nco: bool):
    """(JAX package plans, port plans) of the 1.5 s fixture scenario."""
    key = (rate, int_nco)
    if key not in _PLANS:
        kw = dict(nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=1.5,
                  almanac_enable=False, sample_rate=rate)
        jcfg = JSimConfig(**kw, carrier_mode=(
            JCarrierMode.INT_NCO if int_nco else JCarrierMode.FLOAT))
        tcfg = SimConfig(**kw, carrier_mode=(
            CarrierMode.INT_NCO if int_nco else CarrierMode.FLOAT))
        _PLANS[key] = (list(JSimulation(jcfg).iter_plans()),
                       list(Simulation(tcfg).iter_plans()))
    return _PLANS[key]


def _assert_args_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == g.dtype, k
        assert w.shape == g.shape, k
        assert np.array_equal(w, g), k


@pytest.mark.parametrize("rate,int_nco", [
    (3_000_000, False), (3_000_000, True), (1_200_000, False),
])
def test_port_plans_equal_jax_plans(fixtures_dir, rate, int_nco):
    jplans, tplans = _plans(fixtures_dir, rate, int_nco)
    assert len(jplans) == len(tplans) == 14
    for a, b in zip(jplans, tplans):
        assert sorted(a.__dict__) == sorted(b.__dict__)
        for k, v in a.__dict__.items():
            assert np.array_equal(np.asarray(v), np.asarray(getattr(b, k))), k


@pytest.mark.parametrize("rate,int_nco,kw", [
    (3_000_000, False, dict(compact=True)),
    (3_000_000, False, dict(compact=False)),
    (3_000_000, False, dict(compact=True, compact_multiple=4)),
    (3_000_000, True, dict(compact=True, compact_multiple=4)),
    (1_200_000, False, dict(compact=True, compact_multiple=4)),
], ids=["compact", "full", "multiple4", "int_nco", "wide_1.2msps"])
def test_collate_and_pack_equal_jax(fixtures_dir, rate, int_nco, kw):
    jplans, tplans = _plans(fixtures_dir, rate, int_nco)
    want = jblocks.collate_plans(jplans, int_nco=int_nco, **kw)
    got = targs.collate_plans(tplans, int_nco=int_nco, **kw)
    assert (got.num_samples, got.n_blocks) == (want.num_samples,
                                               want.n_blocks)
    _assert_args_equal(want.args, got.args)
    wp, wspec = jblocks.pack_args(want.args)
    gp, gspec = targs.pack_args(got.args)
    assert wspec == gspec
    assert wp.dtype == gp.dtype == np.int32
    assert np.array_equal(wp, gp)


def test_plan_to_args_equal_jax(fixtures_dir):
    jplans, tplans = _plans(fixtures_dir, 3_000_000, False)
    for a, b in zip(jplans[:4], tplans[:4]):
        _assert_args_equal(jsynth.plan_to_args(a), targs.plan_to_args(b))


@pytest.mark.parametrize("rate", [1_030_000, 1_200_000, 2_046_000,
                                  2_600_000, 3_000_000, 10_000_000])
def test_needs_wide_window_equal_jax(rate):
    assert targs.needs_wide_window(1 / rate) == jsynth.needs_wide_window(
        1 / rate)


def test_chain_carrier_phases_and_ca_table_equal_jax():
    rng = np.random.default_rng(5)
    carr0 = rng.uniform(0, 1, 12)
    f_carr = rng.uniform(-5000, 5000, (25, 12))
    assert np.array_equal(
        jblocks.chain_carrier_phases(carr0, f_carr, 300_000, 1 / 3e6),
        targs.chain_carrier_phases(carr0, f_carr, 300_000, 1 / 3e6),
    )
    prns = np.array([0, 1, 5, 32, -1, 17])
    want = jsynth.packed_ca_for_prns(prns)
    got = targs.packed_ca_for_prns(prns)
    assert want.dtype == got.dtype == np.uint32
    assert np.array_equal(want, got)
    assert np.array_equal(jsynth._LUT_MAGS, targs._LUT_MAGS)


def test_q44_gain_screen_catches_boundary_gain(fixtures_dir):
    """A gain placing a LUT product within 2^-44 of an integer (here
    250*g = 100+1e-13, which Q44 truncates to 99) is caught by the screen:
    the JAX package raises, and the port folds that channel's gain so that
    the kernel's product is the float64 trunc(T*g) for every magnitude T
    (tests/test_torch_strict_gain.py holds the bytes)."""
    cfg = SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                    duration_sec=0.3, almanac_enable=False)
    plan = next(Simulation(cfg).iter_plans())
    good = targs.plan_to_args(plan)  # physical gains pass unfolded
    for k in ("gain_a", "gain_b"):
        assert np.array_equal(good[k], jsynth.plan_to_args(plan)[k])

    bad = type(plan)(**{**plan.__dict__})
    g = bad.gain.copy()
    c = np.argmax(bad.active)
    g[c] = (100.0 + 1e-13) / 250.0
    bad.gain = g
    with pytest.raises(ValueError, match="Q44"):
        jsynth.plan_to_args(bad)
    args = targs.plan_to_args(bad)
    m = targs._LUT_MAGS.astype(np.int64)
    ga, gb = int(args["gain_a"][c]), int(args["gain_b"][c])
    assert np.array_equal((ga * m + ((gb * m) >> 22)) >> 22,
                          np.trunc(targs._LUT_MAGS * g[c]).astype(np.int64))
    assert int(np.trunc(250.0 * g[c])) == 100


def test_unpack_args_round_trips_as_views(fixtures_dir):
    _, tplans = _plans(fixtures_dir, 3_000_000, False)
    args = targs.collate_plans(tplans[:5], compact_multiple=4).args
    packed, spec = targs.pack_args(args)
    t = torch.from_numpy(packed)
    out = targs.unpack_args(t, spec)
    assert sorted(out) == sorted(args)
    lo = t.data_ptr()
    hi = lo + t.numel() * t.element_size()
    for k, v in args.items():
        u = out[k]
        assert u.dtype == torch.int32, k
        assert tuple(u.shape) == v.shape, k
        assert lo <= u.data_ptr() < hi, k  # a view, not a copy
        assert np.array_equal(u.numpy().view(v.dtype), v), k
    # uint32 C/A words keep their bit pattern
    assert args["ca_packed"].dtype == np.uint32
    assert (args["ca_packed"] >= 1 << 31).any()


def test_to_device_keeps_bit_patterns(fixtures_dir):
    _, tplans = _plans(fixtures_dir, 3_000_000, False)
    args = targs.collate_plans(tplans[:2]).args
    dev = targs.to_device(args, "cpu")
    for k, v in args.items():
        assert dev[k].dtype == torch.int32, k
        assert dev[k].is_contiguous(), k
        assert np.array_equal(dev[k].numpy().view(v.dtype), v), k
    with pytest.raises(ValueError, match="32-bit"):
        targs.to_device({"x": np.zeros(3, np.float32)}, "cpu")
