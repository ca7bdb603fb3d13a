"""Synthesis of the PyTorch/CUDA package against the JAX package.

``synth_blocks_batch_torch`` (the plain PyTorch version of the fused
kernel) and ``synth_blocks_batch_cuda`` (the CUDA kernel's wrapper, which
runs the plain version for tensors on the CPU) must give the bytes of the
JAX package's Pallas kernel (interpret mode on the CPU) and of its XLA
synthesizer, with no tolerance: every step is integer arithmetic or float32
evaluated at points proven exact.
"""

import numpy as np
import pytest
import torch

from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.ops import synth_jax as jsynth
from gpssim_tpu.ops.synth_pallas import synth_blocks_batch_pallas
from gpssim_tpu.parallel.blocks import collate_plans as jcollate
from gpssim_tpu.scenario import Simulation as JSimulation
from gpssim_tpu_torch.config import SimConfig
from gpssim_tpu_torch.core.constants import COS_TABLE_512, SIN_TABLE_512
from gpssim_tpu_torch.ops import synth_cuda, synth_torch
from gpssim_tpu_torch.ops.args import (
    LANES, args_from_arrays, collate_plans, needs_wide_window, to_device,
)
from gpssim_tpu_torch.scenario import Simulation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_args(seed, wide, C, nspc, delt):
    """The random-argument blocks of tests/test_synth.py (12 channels, the
    last two inactive), as one-block batches."""
    rng = np.random.default_rng(seed)
    act = np.ones(C, bool)
    act[-2:] = False
    f_code = 1.023e6 * (1 + rng.uniform(-3e-6, 3e-6, C))
    args = args_from_arrays(
        act, rng.uniform(0, 1023, C), f_code, rng.uniform(0, 1, C),
        rng.uniform(-5000, 5000, C), np.zeros(C, np.int64),
        np.zeros(C, np.int64), rng.uniform(50, 300, C),
        rng.integers(0, 29, C), rng.integers(0, 19, C),
        rng.integers(0, 19, C), rng.integers(1, 33, C),
        (rng.integers(0, 1 << 30, (C, 60)).astype(np.uint32) << 2),
        nspc, delt,
    )
    assert needs_wide_window(delt) == wide
    return {k: np.asarray(v)[None] for k, v in args.items()}


def _both(args_np, **kw):
    """(plain version, wrapper on CPU tensors) as numpy."""
    args = to_device(args_np, "cpu")
    a = synth_torch.synth_blocks_batch_torch(args, **kw).numpy()
    b = synth_cuda.synth_blocks_batch_cuda(args, **kw).numpy()
    return a, b


@pytest.mark.parametrize("wide,delt", [(False, 1 / 3.0e6),
                                       (True, 1 / 1.2e6)],
                         ids=["narrow", "wide"])
@pytest.mark.parametrize("bits", [8, 16])
def test_random_args_equal_pallas_fused(wide, delt, bits):
    n_rows, nspc = 128, 15_000
    args = _random_args(23, wide, 12, nspc, delt)
    want = np.asarray(synth_blocks_batch_pallas(
        **args, n_rows=n_rows, num_samples=nspc, wide=wide, out_bits=bits,
        fuse_a=True,
    ))
    a, b = _both(args, n_rows=n_rows, num_samples=nspc, out_bits=bits,
                 wide=wide)
    assert want.dtype == a.dtype == b.dtype
    assert want.dtype == (np.int8 if bits == 8 else np.int16)
    assert want.shape == a.shape == b.shape == (1, 2 * nspc)
    assert np.array_equal(want, a)
    assert np.array_equal(want, b)


@pytest.mark.parametrize("wide,C,n_rows,nspc,delt", [
    (False, 12, 2368, 300_000, 1 / 3.0e6),   # q1 digits
    (True, 12, 192, 20_000, 1 / 1.2e6),      # wide 4-word window
    (False, 12, 4224, 520_000, 1 / 6.0e6),   # q2 digit level (> 4096 rows)
    (False, 16, 128, 15_000, 1 / 3.0e6),     # 16 channels
])
def test_row_bases_equal_jax(wide, C, n_rows, nspc, delt):
    """Stage A alone: the per-(row, channel) bases equal synth_jax's."""
    args = _random_args(11, wide, C, nspc, delt)
    want = jsynth._row_bases(
        *(args[k][0] for k in ("code_l", "carr_l", "nav", "lane_steps",
                                "ca_packed")),
        n_rows, wide=wide,
    )
    t = to_device(args, "cpu")
    got = synth_torch.row_bases(t["code_l"], t["carr_l"], t["nav"],
                                t["ca_packed"], n_rows, wide=wide)
    names = ["f_hi", "f_lo", "c_hi", "c_lo", "sA", "sB"]
    names += ["sC", "sD"] if wide else []
    assert sorted(got) == sorted(names)
    for k in names:
        g = got[k][0].numpy()
        assert g.dtype == np.int32, k
        assert np.array_equal(np.asarray(want[k]), g), k


_FIXTURE_ARGS: dict = {}


def _fixture_window(fixtures_dir, rate):
    """The first 3 fixture blocks at ``rate``, collated by each package."""
    if rate not in _FIXTURE_ARGS:
        kw = dict(nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=0.4,
                  almanac_enable=False, sample_rate=rate)
        jplans = list(JSimulation(JSimConfig(**kw)).iter_plans())[:3]
        tplans = list(Simulation(SimConfig(**kw)).iter_plans())[:3]
        _FIXTURE_ARGS[rate] = (jcollate(jplans).args,
                               collate_plans(tplans).args,
                               jplans[0].num_samples)
    return _FIXTURE_ARGS[rate]


@pytest.mark.parametrize("rate,bits", [
    (3_000_000, 8), (3_000_000, 16), (6_000_000, 16),
], ids=["3msps-8bit", "3msps-16bit", "6msps-q2-16bit"])
def test_fixture_blocks_equal_jax(fixtures_dir, rate, bits):
    jargs, targs_, n = _fixture_window(fixtures_dir, rate)
    n_rows = -(-n // LANES)
    if rate == 6_000_000:
        assert n_rows > 4096  # the q2 row-digit level
    want = np.asarray(jsynth.synth_blocks_batch(
        **jargs, n_rows=n_rows, num_samples=n, out_bits=bits,
    ))
    a, b = _both(targs_, n_rows=n_rows, num_samples=n, out_bits=bits)
    assert want.shape == a.shape == b.shape == (3, 2 * n)
    assert want.dtype == a.dtype == b.dtype
    assert np.array_equal(want, a)
    assert np.array_equal(want, b)


def test_lut_poly_matches_tables():
    """All 512 entries of both carrier tables, from the polynomial."""
    idx = torch.arange(512, dtype=torch.int32)
    ta_s, neg_s, ta_c, neg_c = synth_torch.lut_mag_neg(idx)
    sin_v = torch.where(neg_s, -ta_s, ta_s).numpy()
    cos_v = torch.where(neg_c, -ta_c, ta_c).numpy()
    assert np.array_equal(sin_v, np.array(SIN_TABLE_512))
    assert np.array_equal(cos_v, np.array(COS_TABLE_512))
    lut = synth_torch.lut_tables()
    assert lut.dtype == np.int16
    assert np.array_equal(lut, np.concatenate([SIN_TABLE_512,
                                               COS_TABLE_512]))


def test_gain_trunc_and_finalize_equal_jax():
    rng = np.random.default_rng(3)
    ta = rng.integers(0, 251, 4096).astype(np.int32)
    g = rng.uniform(0.0, 1.99, 4096)
    ga = np.floor(g * (1 << 22)).astype(np.int32)
    gb = (np.floor(g * float(1 << 44)) - ga * float(1 << 22)).astype(np.int32)
    want = np.asarray(jsynth._gain_trunc_mag(ta, ga, gb))
    got = synth_torch.gain_trunc_mag(*(torch.from_numpy(v)
                                       for v in (ta, ga, gb))).numpy()
    assert np.array_equal(want, got)
    assert np.array_equal(got, np.trunc(g * ta).astype(np.int32))

    i_acc = rng.integers(-40000, 40000, (2, 256)).astype(np.int32)
    q_acc = rng.integers(-40000, 40000, (2, 256)).astype(np.int32)
    for bits in (8, 16):
        w = np.asarray(jsynth.finalize_iq(i_acc, q_acc, 250, bits))
        t = synth_torch.finalize_iq(torch.from_numpy(i_acc),
                                    torch.from_numpy(q_acc), 250, bits)
        assert w.dtype == t.numpy().dtype
        assert np.array_equal(w, t.numpy())


def test_wrapper_checks_arguments():
    args = to_device(_random_args(1, False, 12, 15_000, 1 / 3e6), "cpu")
    assert synth_cuda._check_args(args) == (1, 12)
    bad = dict(args, gain_a=args["gain_a"].to(torch.int64))
    with pytest.raises(TypeError, match="int32"):
        synth_cuda._check_args(bad)
    bad = dict(args, nav=args["nav"][:, :2])
    with pytest.raises(ValueError, match="shape"):
        synth_cuda._check_args(bad)
    bad = dict(args, code_l=args["code_l"].transpose(2, 3).contiguous()
               .transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        synth_cuda._check_args(bad)
    args17 = to_device(_random_args(1, False, 17, 15_000, 1 / 3e6), "cpu")
    with pytest.raises(ValueError, match="channels"):
        synth_cuda._check_args(args17)
    missing = {k: v for k, v in args.items() if k != "nav"}
    with pytest.raises(ValueError, match="missing"):
        synth_cuda._check_args(missing)
    meta = {k: torch.empty_like(v, device="meta") for k, v in args.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        synth_cuda.synth_blocks_batch_cuda(meta, n_rows=118,
                                           num_samples=15_000)
