"""The sharded synthesizer of the PyTorch/CUDA package against the JAX
package's ``make_sharded_synth`` on its 8-device virtual CPU mesh.

The port's meshes name the CPU device several times over, so the block
split, the channel split and the int32 sum of the partial rows all run
here. Every comparison is ``np.array_equal``, with no tolerance.
"""

import numpy as np
import pytest
import torch

from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.ops.synth_numpy import synth_block_numpy
from gpssim_tpu.parallel import shard as jshard
from gpssim_tpu.parallel.blocks import collate_plans as jcollate
from gpssim_tpu.scenario import Simulation as JSimulation
from gpssim_tpu_torch.config import SimConfig
from gpssim_tpu_torch.ops import synth_cuda
from gpssim_tpu_torch.ops.args import LANES, collate_plans
from gpssim_tpu_torch.ops.synth_numpy import quantize_iq
from gpssim_tpu_torch.parallel import shard
from gpssim_tpu_torch.scenario import Simulation

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
_JAX_OUT: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _short(plans):
    """512-sample blocks, as tests/test_sharding.py's ``tiny_plans``."""
    for p in plans:
        p.num_samples = 512
    return plans


@pytest.fixture(scope="module")
def tiny(fixtures_dir):
    """(port batch args, JAX batch args, numpy reference) for the 8
    blocks of a 0.9 s fixture scenario cut to 512 samples each."""
    kw = dict(nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=0.9,
              almanac_enable=False)
    tplans = _short(list(Simulation(SimConfig(**kw)).iter_plans()))
    jplans = _short(list(JSimulation(JSimConfig(**kw)).iter_plans()))
    ref = np.stack([synth_block_numpy(p) for p in jplans])
    return collate_plans(tplans).args, jcollate(jplans).args, ref


def _jax_mesh(jargs, nb, nc, out_bits=16):
    """The JAX package's Pallas mesh path (interpret mode), once per
    mesh shape and width."""
    key = (nb, nc, out_bits)
    if key not in _JAX_OUT:
        mesh = jshard.make_mesh(nb, nc)
        fn = jshard.make_sharded_synth(mesh, -(-512 // LANES), 512,
                                       out_bits=out_bits, kernel="pallas")
        padded, pad = jshard.pad_batch(jshard.pad_channels(jargs, nc), nb)
        out = np.asarray(fn(padded))
        _JAX_OUT[key] = out[:-pad] if pad else out
    return _JAX_OUT[key]


def _port_mesh(targs, nb, nc, kernel, out_bits=16):
    mesh = shard.make_mesh(nb, nc, devices=["cpu"] * (nb * nc))
    fn = shard.make_sharded_synth(mesh, -(-512 // LANES), 512,
                                  out_bits=out_bits, kernel=kernel)
    padded, pad = shard.pad_batch(shard.pad_channels(targs, nc), nb)
    out = fn(padded).result()
    return out[:-pad] if pad else out


@pytest.mark.parametrize("nb,nc", MESHES, ids=[f"{b}x{c}" for b, c in MESHES])
@pytest.mark.parametrize("kernel", shard.KERNELS)
def test_sharded_equal_jax_mesh(tiny, nb, nc, kernel):
    targs, jargs, ref = tiny
    before = dict(synth_cuda.launches)
    got = _port_mesh(targs, nb, nc, kernel)
    assert synth_cuda.launches == before  # CPU devices: plain versions
    assert got.dtype == np.int16 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _jax_mesh(jargs, nb, nc))


@pytest.mark.parametrize("nc", [2, 4])
def test_8bit_quantize_after_channel_sum(tiny, nc):
    """The 8-bit ``>> 4`` applies after the sum of the partial rows:
    shifting the partials first would lose carry bits."""
    targs, jargs, _ = tiny
    ref = np.stack([quantize_iq(r, 8) for r in tiny[2]])
    got = _port_mesh(targs, 8 // nc, nc, "cuda", out_bits=8)
    assert got.dtype == np.int8
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _jax_mesh(jargs, 8 // nc, nc, out_bits=8))


def test_pad_batch_and_channels_equal_jax(tiny):
    targs, jargs, _ = tiny
    for nb, nc in [(4, 1), (2, 8), (8, 5)]:
        tp, tpad = shard.pad_batch(shard.pad_channels(targs, nc), nb)
        jp, jpad = jshard.pad_batch(jshard.pad_channels(jargs, nc), nb)
        assert tpad == jpad
        assert sorted(tp) == sorted(jp)
        for k in tp:
            assert np.array_equal(tp[k], np.asarray(jp[k])), k
    same, pad = shard.pad_batch(targs, 8)
    assert pad == 0 and same is targs
    assert shard.pad_channels(targs, 1) is targs


def test_mesh_layout_and_refusals(tiny):
    mesh = shard.make_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.shape == {"blocks": 2, "chan": 4}
    assert mesh.axis_names == ("blocks", "chan")
    assert all(d == torch.device("cpu") for r in mesh.devices for d in r)
    assert shard.make_mesh(n_chan_shards=2,
                           devices=["cpu"] * 4).shape == {"blocks": 2,
                                                          "chan": 2}
    with pytest.raises(ValueError, match="devices"):
        shard.make_mesh(3, 2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        shard.make_mesh(1, 1, devices=["meta"])
    with pytest.raises(ValueError, match="kernel"):
        shard.make_sharded_synth(mesh, 4, 512, kernel="pallas")
    assert shard.make_sharded_synth(mesh, 4, 512).kernel == "cuda-fused"
    for nb, nc in [(3, 1), (1, 5)]:  # 8 blocks x 12 channels
        fn = shard.make_sharded_synth(
            shard.make_mesh(nb, nc, devices=["cpu"] * (nb * nc)), 4, 512)
        with pytest.raises(ValueError, match="does not split"):
            fn(tiny[0])


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.make_mesh(1, 1)
