"""The two-stage synthesis path of the PyTorch/CUDA package against the JAX
package: the packed-bases producer, stage B over packed bases (the plain
version of K2), the raw rows before the finalize, and the two-stage
wrapper that ``GPSSIM_FUSE_A=0`` selects.

Every comparison is ``np.array_equal``, with no tolerance. The JAX
package's Pallas kernels run in interpret mode on the CPU.
"""

import numpy as np
import pytest
import torch

from gpssim_tpu.ops import synth_jax as jsynth
from gpssim_tpu.ops import synth_pallas as jpallas
from gpssim_tpu_torch.ops import _build, synth_cuda, synth_torch
from gpssim_tpu_torch.ops.args import args_from_arrays, to_device


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_args(seed, C, nspc, delt):
    """Random-argument blocks as tests/test_synth.py makes them (the last
    two channels inactive), as one-block batches."""
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
    return {k: np.asarray(v)[None] for k, v in args.items()}


_PRODUCER_ARGS = ("code_l", "carr_l", "nav", "lane_steps", "ca_packed")


# The five layouts of tests/test_synth.py::test_stage_a2_packed_bit_identical
@pytest.mark.parametrize("wide,C,n_rows,nspc,delt", [
    (False, 12, 2368, 300_000, 1 / 3.0e6),   # fast path, q1 digits
    (True, 12, 192, 20_000, 1 / 1.2e6),      # wide 4-word window
    (False, 12, 4224, 520_000, 1 / 6.0e6),   # q2 digit level (> 4096)
    (False, 16, 128, 15_000, 1 / 3.0e6),     # full 16-channel lanes
    (True, 16, 128, 15_000, 1 / 1.2e6),      # 8 planes x 16 = 128
], ids=["narrow-q1", "wide", "narrow-q2", "narrow-16ch", "wide-16ch"])
def test_packed_producer_equal_jax(wide, C, n_rows, nspc, delt):
    args = _random_args(11, C, nspc, delt)
    want = np.asarray(jpallas.row_bases_packed(
        *(args[k][0] for k in _PRODUCER_ARGS), n_rows, wide=wide))
    t = to_device(args, "cpu")
    got = synth_torch.row_bases_packed(
        t["code_l"], t["carr_l"], t["nav"], t["ca_packed"], n_rows,
        wide=wide)
    assert got.dtype == torch.int32
    assert got.shape == (1, n_rows, 128)
    assert np.array_equal(want, got[0].numpy())


def test_pack_row_bases_layout():
    """Name-major lanes, zero lanes past the last name, zero padded rows:
    the layout reference of the JAX package."""
    args = _random_args(5, 12, 15_000, 1 / 3.0e6)
    jb = {k: np.array(v) for k, v in jsynth._row_bases(
        *(args[k][0] for k in _PRODUCER_ARGS), 100, wide=False).items()}
    want = np.asarray(jpallas.pack_row_bases(jb, 128, False))
    got = synth_torch.pack_row_bases(
        {k: torch.from_numpy(v)[None] for k, v in jb.items()}, 128, False)
    assert np.array_equal(want, got[0].numpy())
    assert synth_torch.base_names(True) == jpallas.base_names(True)
    assert synth_torch.base_names(False) == jpallas.base_names(False)
    assert synth_torch.TILE_R == jpallas.TILE_R
    with pytest.raises(ValueError, match="lane"):
        synth_torch.pack_row_bases(
            {k: torch.zeros((1, 4, 17), dtype=torch.int32)
             for k in synth_torch.base_names(True)}, 64, True)


def _jax_raw(args, n_rows, wide, fuse_a):
    i, q = jpallas.synth_batch_pallas_raw(
        *(args[k] for k in ("code_l", "carr_l", "nav", "lane_steps",
                            "ca_packed", "gain_a", "gain_b")),
        n_rows=n_rows, interpret=True, wide=wide, fuse_a=fuse_a)
    return np.asarray(i), np.asarray(q)


@pytest.mark.parametrize("wide,delt", [(False, 1 / 3.0e6),
                                       (True, 1 / 1.2e6)],
                         ids=["narrow", "wide"])
def test_raw_rows_equal_jax(wide, delt):
    """Raw rows in full (all R_pad rows) of the plain K2, of both forms
    of ``synth_batch_torch_raw`` and of the wrapper on CPU tensors."""
    n_rows, nspc = 100, 12_800  # R_pad = 128: 28 rows past the samples
    args = _random_args(23, 12, nspc, delt)
    want_i, want_q = _jax_raw(args, n_rows, wide, fuse_a=False)
    assert want_i.shape == (1, 128, 128) and want_i.dtype == np.int16
    # the fused Pallas kernel gives the same raw rows
    fi, fq = _jax_raw(args, n_rows, wide, fuse_a=True)
    assert np.array_equal(fi, want_i) and np.array_equal(fq, want_q)

    t = to_device(args, "cpu")
    packed = synth_torch.row_bases_packed(
        t["code_l"], t["carr_l"], t["nav"], t["ca_packed"], 128, wide=wide)
    got = [synth_torch.stage_b_packed_torch(
        packed, t["lane_steps"], t["gain_a"], t["gain_b"], wide=wide)]
    for fuse_a in (False, True):
        got.append(synth_torch.synth_batch_torch_raw(
            t, n_rows=n_rows, wide=wide, fuse_a=fuse_a))
        got.append(synth_cuda.synth_batch_cuda_raw(
            t, n_rows=n_rows, wide=wide, fuse_a=fuse_a))
    for i_rows, q_rows in got:
        assert i_rows.dtype == q_rows.dtype == torch.int16
        assert np.array_equal(i_rows.numpy(), want_i)
        assert np.array_equal(q_rows.numpy(), want_q)


@pytest.mark.parametrize("wide,delt", [(False, 1 / 3.0e6),
                                       (True, 1 / 1.2e6)],
                         ids=["narrow", "wide"])
@pytest.mark.parametrize("bits", [8, 16])
def test_two_stage_wrapper_equal_pallas(wide, delt, bits):
    """``synth_blocks_batch_cuda(fuse_a=False)`` on CPU tensors against
    the JAX package's two-stage Pallas path."""
    n_rows, nspc = 128, 15_000
    args = _random_args(23, 12, nspc, delt)
    want = np.asarray(jpallas.synth_blocks_batch_pallas(
        **args, n_rows=n_rows, num_samples=nspc, wide=wide, out_bits=bits,
        fuse_a=False, interpret=True))
    t = to_device(args, "cpu")
    got = synth_cuda.synth_blocks_batch_cuda(
        t, n_rows=n_rows, num_samples=nspc, out_bits=bits, wide=wide,
        fuse_a=False).numpy()
    assert got.dtype == want.dtype == (np.int8 if bits == 8 else np.int16)
    assert got.shape == want.shape == (1, 2 * nspc)
    assert np.array_equal(want, got)
    # and the fused path's bytes
    fused = synth_cuda.synth_blocks_batch_cuda(
        t, n_rows=n_rows, num_samples=nspc, out_bits=bits, wide=wide,
        fuse_a=True).numpy()
    assert np.array_equal(fused, got)


def test_fuse_a_env_read_at_call_time(monkeypatch):
    """``GPSSIM_FUSE_A=0`` selects the two-stage path at call time, as
    the JAX package's ``_fuse_a_default`` does; the default is fused."""
    calls = []
    real = synth_torch.synth_batch_torch_raw

    def spy(*a, **k):
        calls.append(k["fuse_a"])
        return real(*a, **k)

    monkeypatch.setattr(synth_cuda, "synth_batch_torch_raw", spy)
    monkeypatch.delenv("GPSSIM_FUSE_A", raising=False)
    assert synth_cuda.fuse_a_default()
    t = to_device(_random_args(3, 4, 1_000, 1 / 3.0e6), "cpu")
    kw = dict(n_rows=8, num_samples=1_000, out_bits=8)
    fused = synth_cuda.synth_blocks_batch_cuda(t, **kw)
    assert calls == []  # the fused plain version, not the raw rows
    monkeypatch.setenv("GPSSIM_FUSE_A", "0")
    assert not synth_cuda.fuse_a_default()
    two = synth_cuda.synth_blocks_batch_cuda(t, **kw)
    assert calls == [False]
    assert torch.equal(fused, two)
    monkeypatch.setenv("GPSSIM_FUSE_A", "1")
    synth_cuda.synth_blocks_batch_cuda(t, **kw)
    assert calls == [False]


def test_k2_wrapper_checks_and_cpu_path(monkeypatch):
    """On CPU tensors the K2 wrapper runs its plain version without
    building anything and counts no launch; bad arguments raise."""
    def no_build(*a, **k):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(synth_cuda, "load", no_build)
    t = to_device(_random_args(7, 12, 8_000, 1 / 3.0e6), "cpu")
    packed = synth_torch.row_bases_packed(
        t["code_l"], t["carr_l"], t["nav"], t["ca_packed"], 64)
    before = dict(synth_cuda.launches)
    got = synth_cuda.stage_b_packed_cuda(
        packed, t["lane_steps"], t["gain_a"], t["gain_b"])
    want = synth_torch.stage_b_packed_torch(
        packed, t["lane_steps"], t["gain_a"], t["gain_b"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    synth_cuda.synth_blocks_batch_cuda(t, n_rows=63, num_samples=8_000,
                                       fuse_a=False)
    assert synth_cuda.launches == before
    with pytest.raises(ValueError, match="rows"):
        synth_cuda._check_packed(packed[:, :60], t["lane_steps"],
                                 t["gain_a"], t["gain_b"], False)
    with pytest.raises(TypeError, match="int32"):
        synth_cuda._check_packed(packed.to(torch.int64), t["lane_steps"],
                                 t["gain_a"], t["gain_b"], False)
    with pytest.raises(ValueError, match="lane_steps has shape"):
        synth_cuda._check_packed(packed, t["lane_steps"][:, :, :2],
                                 t["gain_a"], t["gain_b"], False)
    z = torch.zeros((1, 17), dtype=torch.int32)
    with pytest.raises(ValueError, match="channels"):
        synth_cuda._check_packed(packed, torch.zeros((1, 4, 17),
                                                     dtype=torch.int32),
                                 z, z, False)
    meta = packed.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        synth_cuda.stage_b_packed_cuda(meta, t["lane_steps"], t["gain_a"],
                                       t["gain_b"])


def test_nvcc_missing_raises_for_k2(monkeypatch):
    """No compiler means K2 cannot be built: that raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(synth_cuda.SOURCE_K2)
