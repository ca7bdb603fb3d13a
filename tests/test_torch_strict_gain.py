"""The Q44 gain split of the collation (``ops/args.args_from_arrays``) at
the gain where it was not truncation-exact.

The kernels compute trunc(T * g) for each carrier-table magnitude T as
floor(T * G / 2^44) from a Q44 gain G split into two 22-bit halves. With
G = floor(g * 2^44) that is one less than the reference C's float64
trunc(T*g) where T*g lies a hair above an integer, and the collation
raised and stopped the run. The witness (``benchmark/tools/
gain_split_fault.py``, the benchmark's ``record.static`` seed 1301000003,
block 54,165): T = 153, g = 0.45751633986928997, T*g = 70 + 1.4e-12.
Such a (block, channel) now gets another G that gives trunc(T*g) for every
magnitude, and the bytes equal the NumPy backend's (``ops/synth_numpy``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gpssim_tpu_torch.config import SimConfig
from gpssim_tpu_torch.core.constants import COS_TABLE_512, SIN_TABLE_512
from gpssim_tpu_torch.ops import args as args_mod
from gpssim_tpu_torch.ops.args import _LUT_MAGS, _fold_exact, plan_to_args
from gpssim_tpu_torch.ops.synth_numpy import synth_block_numpy
from gpssim_tpu_torch.scenario import Simulation

from tests.test_torch_strict_engine import k1_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = 0.45751633986928997
T = 153


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _device_trunc(ga: int, gb: int) -> np.ndarray:
    """floor(T * G / 2^44) for every magnitude, as the kernels form it."""
    m = _LUT_MAGS.astype(np.int64)
    return (ga * m + ((gb * m) >> 22)) >> 22


def _reference_trunc(g: float) -> np.ndarray:
    return np.trunc(_LUT_MAGS * g).astype(np.int64)


def _plain_split(g: float) -> tuple[int, int]:
    ga = int(np.floor(g * 2.0**22))
    return ga, int(np.floor(g * 2.0**44)) - ga * (1 << 22)


def test_the_witness_needs_a_fold():
    assert T in _LUT_MAGS and T * G > 70.0
    plain = _device_trunc(*_plain_split(G))
    want = _reference_trunc(G)
    assert plain[_LUT_MAGS == T] == want[_LUT_MAGS == T] - 1
    assert np.array_equal(_device_trunc(*_fold_exact(G)), want)


@pytest.mark.parametrize("g", [G, 0.30485188, 0.61468602, 1.2345678901234])
def test_fold_is_exact_for_every_magnitude(g):
    ga, gb = _fold_exact(g)
    assert 0 <= gb < 1 << 22
    assert np.array_equal(_device_trunc(ga, gb), _reference_trunc(g))


def test_no_single_gain_raises():
    # fl(5g) = 1.9999999999999998 but fl(50g) = 20.0: trunc gives 1 and
    # 20, and no G has floor(5G/2^44) = 1 and floor(50G/2^44) = 20
    with pytest.raises(ValueError, match="no Q44 gain"):
        _fold_exact(0.39999999999999997)


def _witness_plan():
    """A real first block cut to 12,000 samples, every active channel at
    the witness gain and a carrier fast enough to visit every table
    entry."""
    cfg = SimConfig(nav_file=os.path.join(REPO, "fixtures", "brdc_test.22n"),
                    duration_sec=1.0, almanac_enable=False)
    p = Simulation(cfg).step()
    on = p.active
    f_carr = np.where(on, 4.0e5 + 997.0 * np.arange(p.num_channels), 0.0)
    return dataclasses.replace(p, num_samples=12_000,
                               gain=np.where(on, G, 0.0), f_carr=f_carr)


def test_collation_folds_the_witness_and_bytes_equal_numpy(monkeypatch):
    plan = _witness_plan()
    # magnitude 153 is visited by every channel
    n = np.arange(plan.num_samples)
    for c in np.flatnonzero(plan.active):
        carr = plan.carr_phase[c] + n * (plan.f_carr[c] * plan.delt)
        idx = np.floor((carr - np.floor(carr)) * 512).astype(int)
        seen = np.abs(np.concatenate([COS_TABLE_512[idx],
                                      SIN_TABLE_512[idx]]))
        assert T in seen
    args = plan_to_args(plan)
    on = plan.active
    assert np.all(args["gain_b"][on] == _fold_exact(G)[1])
    got = k1_bytes(plan, False, 16)
    assert np.array_equal(got, synth_block_numpy(plan))

    # without the fold the bytes are not the NumPy backend's
    monkeypatch.setattr(args_mod, "_fold_exact", _plain_split)
    assert not np.array_equal(k1_bytes(plan, False, 16),
                              synth_block_numpy(plan))
