"""The PyTorch/CUDA package's entry points (``gpssim_tpu_torch/entry.py``)
on the CPU, against the JAX package's references."""

import numpy as np
import pytest
import torch

from gpssim_tpu_torch import entry


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_entry_cpu_equals_jax_numpy_reference(fixtures_dir):
    from gpssim_tpu.config import SimConfig
    from gpssim_tpu.ops.synth_numpy import synth_block_numpy
    from gpssim_tpu.scenario import Simulation
    from gpssim_tpu_torch.ops import synth_cuda

    fn, ex = entry.entry(device="cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.int32 for t in ex)
    before = dict(synth_cuda.launches)
    out = fn(*ex)
    assert synth_cuda.launches == before  # the plain version, no launch
    assert tuple(out.shape) == (4, 600_000) and out.dtype == torch.int16
    plans = list(Simulation(SimConfig(
        nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=0.5,
        almanac_enable=False, num_channels=12)).iter_plans())[:4]
    ref = np.stack([synth_block_numpy(p) for p in plans])
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("kw", [dict(device="cpu"),
                                dict(devices=["cpu", "cpu"])],
                         ids=["device-cpu", "explicit-list"])
def test_dryrun_multichip_cpu_runs_all_nine_passes(kw):
    """The CPU named twice, by ``device`` or by an explicit list (as one
    card is named twice on a machine with one card): all nine passes, the
    children sharing it over gloo."""
    res = entry.dryrun_multichip(2, **kw)
    assert res["passes"] == [
        "tiny", "wide-window", "two-stage-mesh", "chan4-mesh",
        "full-300000-sample-blocks", "two-stage-full-block", "fleet-mesh",
        "multiproc-dcn", "multiproc-dcn4",
    ]
    assert res["child_launches"] == {"K1": 0, "K2": 0}
    assert res["child_backends"] == {"multiproc-dcn": "gloo",
                                     "multiproc-dcn4": "gloo"}


def test_mesh_pass_fails_on_one_differing_sample(monkeypatch):
    """A pass holds every sample: a reference with one sample changed
    fails it."""
    from gpssim_tpu_torch.ops import synth_numpy
    from gpssim_tpu_torch.parallel.shard import make_mesh

    plans, _ = entry._make_plans(3_000_000, 0.3)
    for p in plans:
        p.num_samples = 256
    mesh = make_mesh(1, 2, devices=["cpu", "cpu"])
    for kernel in ("torch", "cuda"):
        entry._mesh_pass(mesh, plans, 2, 256, kernel)
    good = synth_numpy.synth_block_numpy

    def one_off(plan, int_nco=False):
        out = good(plan, int_nco).copy()
        out[101] += 1
        return out

    monkeypatch.setattr(synth_numpy, "synth_block_numpy", one_off)
    with pytest.raises(AssertionError, match="sequential reference"):
        entry._mesh_pass(mesh, plans, 2, 256, "torch")


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_main_cpu(capsys):
    assert entry.main(["--device", "cpu"]) == 0
    assert "entry OK: (4, 600000) torch.int16" in capsys.readouterr().out
