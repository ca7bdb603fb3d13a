"""The stage-B loop that K1 and K2 share (gpssim_tpu_torch/csrc/stage_b.cuh),
emulated in numpy, against the plain version of K2 and the JAX package.

The CUDA kernels cannot run on the CPU; their reformulation of stage B
can. The emulation below follows the kernels step for step: K2's scatter
of a packed row into a channel-major slot, one warp per row with the four
samples t, t+32, t+64, t+96 per thread, the code phase carried one chip
back so that a rotate of the window word puts the chip's bit on bit 1,
the window word picked by selects on that phase, the chip sign as a
multiply by +1 or -1, and the carrier table, addressed in bytes, with the
split-Q44 gain and the carrier sign folded in once per (block, channel).
numpy's uint32 and int32 arrays wrap as the card's registers do. Every
comparison is ``np.array_equal``, with no tolerance; the JAX package's
Pallas kernel runs in interpret mode.
"""

import numpy as np
import pytest
import torch

from gpssim_tpu.ops import synth_jax as jsynth
from gpssim_tpu.ops import synth_pallas as jpallas
from gpssim_tpu_torch.ops import synth_torch
from gpssim_tpu_torch.ops.args import args_from_arrays, to_device

_LUT = synth_torch.lut_tables().astype(np.int32)
_SIN, _COS = _LUT[:512], _LUT[512:]
_U = np.uint32
F_HI, F_LO, C_HI, C_LO, S0 = range(5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gain_tables(gain_a, gain_b):
    """build_gain_tables: split gains (..., C) → int32 (..., C, 512, 2),
    the pair (sgn(cos)·trunc(g·|cos|), sgn(sin)·trunc(g·|sin|)) per index,
    with the int32 wraparound of gain_trunc_mag."""
    ga = np.asarray(gain_a, np.int32)[..., None]
    gb = np.asarray(gain_b, np.int32)[..., None]

    def fold(t):
        mag = np.abs(t)
        m = ((ga * mag) + ((gb * mag) >> 22)) >> 22
        return np.where(t < 0, -m, m)

    return np.stack([fold(_COS), fold(_SIN)], axis=-1)


def stage_b_emulated(packed, lane_steps, gain_a, gain_b, wide):
    """The kernels' stage B over packed bases (B, R, 128) → raw rows
    (i, q), int16 (B, R, 128)."""
    B, R, _ = packed.shape
    C = gain_a.shape[-1]
    n_names = 8 if wide else 6
    tab = gain_tables(gain_a, gain_b).view(_U)  # (B, C, 512, 2)
    # K2's staging: lane L = name*C + c of a packed row → slot[c][name]
    L = np.arange(n_names * C)
    slot = np.zeros((B, R, C, 8), _U)
    slot[:, :, L % C, L // C] = packed.view(_U)[:, :, L]
    return stage_b_loop(slot, lane_steps.view(_U), tab, wide)


def stage_b_loop(slot, ls, tab, wide):
    """stage_b_row over G groups of N rows that share a block's staged
    data: slots uint32 (G, N, C, 8) (channel-major bases), lane steps
    uint32 (G, 4, C), folded tables uint32 (G, C, 512, 2) → raw rows
    (i, q), int16 (G, N, 128)."""
    B, R, C, _ = slot.shape
    thread = np.arange(32, dtype=_U)
    b_idx = np.arange(B)[:, None, None]
    i_acc = np.zeros((B, R, 4, 32), _U)
    q_acc = np.zeros_like(i_acc)
    for c in range(C):
        ph = slot[:, :, c, :, None]  # (B, R, 8, 1): the row's bases
        st = ls[:, :, c, None, None]  # (B, 4, 1, 1): the lane steps
        hb = ph[:, :, F_HI] + _U(31 << 23)  # the code phase one chip back
        for j in range(4):
            n = thread + _U(32 * j)
            lo = ph[:, :, F_LO] + n * st[:, 1]
            H = hb + n * st[:, 0] + (lo >> _U(23))
            s = [ph[:, :, S0 + k] for k in range(4)]
            if wide:
                w01 = np.where(H < _U(63 << 23), s[0], s[1])
                w23 = np.where(H < _U(127 << 23), s[2], s[3])
                w = np.where(H < _U(95 << 23), w01, w23)
            else:
                w = np.where(H < _U(63 << 23), s[0], s[1])
            # rotate right by (H >> 23) mod 32: bit chip_off lands on bit 1
            w64 = w.astype(np.uint64)
            rot = (((w64 << np.uint64(32)) | w64)
                   >> ((H >> _U(23)) & _U(31)).astype(np.uint64))
            sgn = (rot.astype(_U) & _U(2)) - _U(1)
            klo = ph[:, :, C_LO] + n * st[:, 3]
            kH = ph[:, :, C_HI] + n * st[:, 2] + (klo >> _U(23))
            byte = (kH >> _U(18)) & _U(511 << 3)  # the entry's byte offset
            t = tab[b_idx, c, byte // _U(8)]  # (B, R, 32, 2)
            i_acc[:, :, j] += sgn * t[..., 0]
            q_acc[:, :, j] += sgn * t[..., 1]
    # sample t + 32*j of a row is i_acc[..., j, t]
    return tuple(a.reshape(B, R, 128).view(np.int32).astype(np.int16)
                 for a in (i_acc, q_acc))


def _split_gain(g):
    """args.py's split of a gain into Q44 halves (ga, gb)."""
    ga = int(np.floor(g * float(1 << 22)))
    gb = int(np.floor(g * float(1 << 44)) - ga * float(1 << 22))
    return ga, gb


# 0; just below 1; the largest Q44 gain below 2; a gain where ga·|LUT|
# wraps int32
_GAINS = {"zero": (0, 0), "below1": _split_gain(1 - 2.0**-22),
          "below2": _split_gain(2 - 2.0**-44),
          "wrap": ((1 << 31) - 12345, (1 << 22) - 1)}


@pytest.mark.parametrize("gain", list(_GAINS))
def test_folded_table_equals_gain_fold(gain):
    """Every entry of the folded table is gain_trunc_mag of |LUT| with
    the LUT's sign: the plain version's and the JAX package's fold."""
    ga, gb = _GAINS[gain]
    tab = gain_tables(np.array([ga]), np.array([gb]))[0]
    assert tab.shape == (512, 2) and tab.dtype == np.int32
    for col, lut in ((0, _COS), (1, _SIN)):
        ta = torch.from_numpy(np.abs(lut))
        mag = synth_torch.gain_trunc_mag(
            ta, torch.tensor(ga, dtype=torch.int32),
            torch.tensor(gb, dtype=torch.int32)).numpy()
        assert np.array_equal(tab[:, col], np.where(lut < 0, -mag, mag))
        jmag = np.asarray(jsynth._gain_trunc_mag(
            np.abs(lut), np.int32(ga), np.int32(gb)))
        assert np.array_equal(mag, jmag)
        if gain != "wrap":  # the split is truncation-exact below 2
            g = ga / float(1 << 22) + gb / float(1 << 44)
            assert np.array_equal(mag, np.trunc(g * np.abs(lut)))
    if gain == "zero":
        assert not tab.any()


def _random_args(seed, C, nspc, delt):
    """One random block of C channels (the last two inactive), with every
    channel's gain replaced: zero, tiny (every entry 0 or +-1),
    just below 1 and 2, and split gains where ga·|LUT| wraps int32."""
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
    args = {k: np.asarray(v)[None] for k, v in args.items()}
    ga = rng.integers(1 << 23, 1 << 31, C)
    gb = rng.integers(0, 1 << 22, C)
    fixed = [(0, 0), (1 << 15, 0), _GAINS["below1"], _GAINS["below2"]]
    for c, (a, b) in enumerate(fixed):
        ga[c], gb[c] = a, b
    args["gain_a"] = ga.astype(np.int32)[None]
    args["gain_b"] = gb.astype(np.int32)[None]
    return args


@pytest.mark.parametrize("C", [12, 16])
@pytest.mark.parametrize("wide,delt", [(False, 1 / 3.0e6),
                                       (True, 1 / 1.2e6)],
                         ids=["narrow", "wide"])
def test_emulated_loop_equal_plain_and_jax(wide, delt, C):
    """Raw rows in full (all R_pad rows, 28 of them past the samples):
    the emulated loop = stage_b_packed_torch = the JAX package's two-stage
    Pallas kernel, with wrapping gains."""
    n_rows, R_pad = 100, 128
    args = _random_args(31 + C, C, 12_800, delt)
    t = to_device(args, "cpu")
    packed = synth_torch.row_bases_packed(
        t["code_l"], t["carr_l"], t["nav"], t["ca_packed"], R_pad, wide=wide)
    got = stage_b_emulated(packed.numpy(), args["lane_steps"],
                           args["gain_a"], args["gain_b"], wide)
    plain = synth_torch.stage_b_packed_torch(
        packed, t["lane_steps"], t["gain_a"], t["gain_b"], wide=wide)
    want = jpallas.synth_batch_pallas_raw(
        *(args[k] for k in ("code_l", "carr_l", "nav", "lane_steps",
                            "ca_packed", "gain_a", "gain_b")),
        n_rows=n_rows, interpret=True, wide=wide, fuse_a=False)
    for g, p, w in zip(got, plain, want):
        assert g.shape == (1, R_pad, 128) and g.dtype == np.int16
        assert np.array_equal(g, p.numpy())
        assert np.array_equal(g, np.asarray(w))
    # the gains reach the rows: a wrapping channel changes them
    assert got[0].any() and got[1].any()
