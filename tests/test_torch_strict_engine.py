"""The port's sequential-parity engine (``ops/seq.cc``) against the
sequential replay, sample by sample.

The fused kernel K1 computes each block in the closed form of its plan in
fixed point (Q46 code phase, Q53 carrier phase; ``ops/args.py``), and the
strict-parity corrections patch it into the reference C's bytes (its
sequential float64 phases). The corrections used to compare each screened
candidate with the float64 closed form of the NumPy backend instead: where
K1's fixed point lands on the other side of a chip or carrier-table
boundary than both float64 semantics, no correction was emitted.

* The witnesses (``fixtures/strict_witnesses.npz``) are eight block plans
  of the benchmark's strict recording (``single-3msps-sc8``, ``static``
  traffic, seed 1234567891; six in float and two in integer-NCO carrier
  mode) whose bytes the H100's K1 plus those float64-yardstick corrections
  got wrong (``benchmark/tools/parity_faults.py``'s check). The H100's
  bytes equalled the kernel's plain version, which stands in for it here.
  With the port's corrections each block equals the shared runtime's full
  sequential replay (``synth_block_seq_native``) and the benchmark's
  strict reference; with the shared engine's corrections it does not.
* A seeded fuzz over plans pushed onto chip and carrier-table boundaries
  holds the fast screen, and the sample-major screen, against a full
  evaluation of every sample: K1's plain version against the replay.
* The same plans hold the NumPy backend's float64 mode of the port's
  engine against the shared engine it started from.
* The screen's margins against both closed forms, as ``ops/seq.cc``
  argues them, and K1's rounding on real plans, in exact rationals.
"""

import ctypes
import dataclasses
import os
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from gpssim_tpu_torch.config import SimConfig
from gpssim_tpu_torch.ops import synth_seq
from gpssim_tpu_torch.ops.args import LANES, needs_wide_window, plan_to_args
from gpssim_tpu_torch.ops.plan import BlockPlan
from gpssim_tpu_torch.ops.synth_torch import synth_blocks_batch_torch
from gpssim_tpu_torch.scenario import Simulation

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WITNESSES = os.path.join(REPO, "fixtures", "strict_witnesses.npz")
SEQ_CC = os.path.join(REPO, "gpssim_tpu_torch", "ops", "seq.cc")
FIELDS = ("active", "code_phase", "f_code", "carr_phase", "f_carr",
          "carr_phase_i", "carr_step_i", "gain", "iword", "ibit", "icode",
          "prn", "ca", "dwrd")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _engines():
    assert synth_seq.seq_available(), "g++ and tools/build_native.sh"


def witnesses() -> list:
    """(plan, int_nco, block, wrong byte offsets) of each witness."""
    z = np.load(WITNESSES)
    out = []
    for k in range(len([f for f in z.files if f.endswith("_block")])):
        plan = BlockPlan(num_samples=int(z[f"{k}_num_samples"]),
                         delt=float(z[f"{k}_delt"]),
                         **{f: z[f"{k}_{f}"] for f in FIELDS})
        out.append((plan, bool(z[f"{k}_int_nco"]), int(z[f"{k}_block"]),
                    z[f"{k}_bytes_wrong"]))
    return out


def k1_bytes(plan: BlockPlan, int_nco: bool, bits: int) -> np.ndarray:
    """K1's bytes of ``plan``: the kernel's plain version."""
    args = plan_to_args(plan, int_nco=int_nco)
    t = {k: torch.from_numpy(np.ascontiguousarray(v[None]).view(np.int32))
         for k, v in args.items()}
    out = synth_blocks_batch_torch(
        t, n_rows=-(-plan.num_samples // LANES),
        num_samples=plan.num_samples, out_bits=bits,
        wide=needs_wide_window(plan.delt))
    return out[0].numpy()


def shared_corrections(plan: BlockPlan, int_nco: bool, ref: bool = False):
    """(idx, i16, q16) of the shared runtime's engine
    (native/gpssim_native.cc): the float64 closed form's corrections."""
    lib = synth_seq._shared()
    c, cv = ctypes, ctypes.c_void_p
    fn = lib.gseq_diff_block_ref if ref else lib.gseq_diff_block
    fn.restype = c.c_long
    fn.argtypes = ([c.c_long, c.c_long, c.c_double, c.c_int]
                   + [cv] * 15 + [c.c_long] + [cv] * 5 + [c.c_int])
    arrays = [np.ascontiguousarray(plan.active, np.uint8)] + [
        np.ascontiguousarray(getattr(plan, name), dt)
        for name, dt in synth_seq._FIELDS]
    n_max = 4096
    idx = np.empty(n_max, np.int64)
    i16 = np.empty(n_max, np.int16)
    q16 = np.empty(n_max, np.int16)
    end = np.empty(plan.num_channels, np.float64)
    end_i = np.empty(plan.num_channels, np.uint32)
    n = fn(plan.num_channels, plan.num_samples, plan.delt, int(int_nco),
           *[a.ctypes.data_as(cv) for a in arrays],
           synth_seq._SIN_F64.ctypes.data_as(cv),
           synth_seq._COS_F64.ctypes.data_as(cv), n_max,
           idx.ctypes.data_as(cv), i16.ctypes.data_as(cv),
           q16.ctypes.data_as(cv), end.ctypes.data_as(cv),
           end_i.ctypes.data_as(cv), 0)
    assert n >= 0
    return idx[:n], i16[:n], q16[:n]


# ---------------------------------------------------------------------------
# the witnesses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", range(8))
def test_witness_equals_the_sequential_replay(k):
    plan, nco, block, wrong = witnesses()[k]
    k1 = k1_bytes(plan, nco, 8)
    want = synth_seq.synth_block_seq_native(plan, int_nco=nco, bits=8)

    # the float64 yardstick leaves the block wrong, where the card did
    old = synth_seq.apply_corrections(k1.copy(), 8,
                                      *shared_corrections(plan, nco))
    assert np.array_equal(np.flatnonzero(old != want), wrong), block

    k1.flags.writeable = False  # as runner.fetch_batch hands it out
    [got], cands, patched = synth_seq.correct_window([k1], [plan], 8, nco)
    assert np.array_equal(got, want), block
    assert got is not k1 and got.flags.writeable  # patched: a copy
    assert patched[0] >= 1 and cands[0] >= patched[0]
    if not nco:  # the benchmark's reference speaks float carriers
        from benchmark.reference.synth import synth_bytes

        ref, _flagged = synth_bytes([plan], plan.carr_phase[None], "cpu")
        assert np.array_equal(ref[0].numpy(), want), block


def test_witness_window_counts():
    """One window of every float witness: the same corrections as block by
    block, and the counts the runner books."""
    float_ones = [w for w in witnesses() if not w[1]]
    plans = [w[0] for w in float_ones]
    per_block = [synth_seq.seq_corrections(p)[:3] for p in plans]
    window = synth_seq.seq_corrections_window(plans)
    for a, b in zip(per_block, window):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    blocks = [np.zeros(2 * p.num_samples, np.int8) for p in plans]
    _, cands, patched = synth_seq.correct_window(blocks, plans, 8)
    assert list(patched) == [len(c[0]) for c in window]
    assert np.all(patched >= 1) and np.all(cands >= patched)


# ---------------------------------------------------------------------------
# the fuzz
# ---------------------------------------------------------------------------


def _base_plan() -> BlockPlan:
    cfg = SimConfig(nav_file=os.path.join(REPO, "fixtures", "brdc_test.22n"),
                    duration_sec=1.0, almanac_enable=False)
    return Simulation(cfg).step()


def boundary_plans(seed: int, count: int) -> list:
    """Plans of a real first block, cut to a few thousand samples, whose
    channels each cross a chip boundary and a carrier-table boundary at a
    random sample n within K1's rounding there, (n + 1) * 2^-47 chip and
    n * 2^-54 cycle, of the exact closed form."""
    rng = np.random.default_rng(seed)
    base = _base_plan()
    on = np.flatnonzero(base.active)
    out = []
    for _ in range(count):
        N = int(rng.integers(1000, 6000))
        cp = base.code_phase.copy()
        c0 = base.carr_phase.copy()
        for c in on:
            n = int(rng.integers(1, N))
            x = (rng.integers(0, 1023) - n * base.f_code[c] * base.delt)
            cp[c] = (x + rng.uniform(-1.5, 1.5) * (n + 1) * 2.0**-47) % 1023.0
            n = int(rng.integers(1, N))
            y = rng.integers(0, 512) / 512.0 - n * base.f_carr[c] * base.delt
            c0[c] = (y + rng.uniform(-1.5, 1.5) * n * 2.0**-54) % 1.0
        out.append(dataclasses.replace(base, num_samples=N, code_phase=cp,
                                       carr_phase=c0))
    return out


@pytest.mark.parametrize("nco", [False, True], ids=["float", "int_nco"])
def test_screen_equals_every_sample(nco):
    missed_by_float64 = 0
    for plan in boundary_plans(20261018 + nco, 60):
        k1 = k1_bytes(plan, nco, 16)
        seq = synth_seq.synth_block_seq_native(plan, int_nco=nco, bits=16)
        want = np.flatnonzero((k1 != seq).reshape(-1, 2).any(axis=1))
        for ref in (False, True):
            idx, i16, q16, _, _ = synth_seq.seq_corrections(
                plan, int_nco=nco, _ref=ref)
            assert np.array_equal(idx, want), ref
            assert np.array_equal(i16, seq[2 * want])
            assert np.array_equal(q16, seq[2 * want + 1])
        old = synth_seq.apply_corrections(k1.copy(), 16,
                                          *shared_corrections(plan, nco))
        missed_by_float64 += not np.array_equal(old, seq)
    assert missed_by_float64 > 0  # the fuzz reaches the fault it guards


@pytest.mark.parametrize("nco", [False, True], ids=["float", "int_nco"])
def test_float64_mode_equals_the_shared_engine(nco):
    for plan in boundary_plans(20261020 + nco, 30):
        for ref in (False, True):
            got = synth_seq.seq_corrections(plan, int_nco=nco, _ref=ref,
                                            fixed_point=False)[:3]
            for a, b in zip(got, shared_corrections(plan, nco, ref=ref)):
                assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the margins
# ---------------------------------------------------------------------------


def _margin(name: str) -> float:
    """The value ``ops/seq.cc`` returns from ``name()``: a product of
    literals."""
    src = open(SEQ_CC).read()
    body = re.search(rf"{name}\(\) {{ return ([^;]+); }}", src).group(1)
    value = 1.0
    for lit in body.split("*"):
        value *= float(lit)
    return value


def test_margins_cover_both_closed_forms():
    """At every n, margin(n) against the bounds ``ops/seq.cc`` gives:
    code at least 79 times K1's (n + 1) * 2^-47 and 10 times the
    sequential n * 2^-44; carrier (x512) 10 times K1's n * 2^-54 and 5
    times the sequential n * 2^-53."""
    code = (_margin("code_margin_slope"), _margin("code_margin_const"))
    carr = (_margin("carr_margin_slope"), _margin("carr_margin_const"))
    for n in (0, 1, 1000, 300_000, 1 << 20):
        m = code[0] * n + code[1]
        assert m >= 79.0 * (n + 1) * 2.0**-47
        assert m >= 9.99 * n * 2.0**-44
        m = carr[0] * n + carr[1]
        assert m >= 9.99 * 512 * n * 2.0**-54
        assert m >= 4.99 * 512 * n * 2.0**-53


def test_k1_rounding_within_its_bound():
    """K1's phases, rint(x * 2^q) + n * rint(step * 2^q), against the exact
    closed form of real plans (3 Msps, a whole block), in rationals: the
    error is linear in n, so both ends of the block bound it."""
    plan = _base_plan()
    N = plan.num_samples
    for c in np.flatnonzero(plan.active):
        dc = plan.f_code[c] * plan.delt
        dp = plan.f_carr[c] * plan.delt
        for x0, step, q, bound in (
                (plan.code_phase[c], dc, 46, lambda n: (n + 1) * 2.0**-47),
                (plan.carr_phase[c], dp, 53, lambda n: n * 2.0**-54)):
            e0 = Fraction(int(np.rint(x0 * 2.0**q)), 1 << q) - Fraction(x0)
            e1 = Fraction(int(np.rint(step * 2.0**q)), 1 << q) - Fraction(
                step)
            for n in (0, N):
                assert abs(e0 + n * e1) <= Fraction(bound(n))
