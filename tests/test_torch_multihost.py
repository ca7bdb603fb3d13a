"""Multi-process runs of the PyTorch/CUDA package over gloo, against the
JAX package's single-process bytes.

Each child imports only ``gpssim_tpu_torch`` and joins a gloo process
group on loopback; CPU devices run the kernels' plain versions. Every
comparison is ``np.array_equal``.
"""

import json
import os

import numpy as np
import pytest
import torch

from gpssim_tpu_torch import entry
from gpssim_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from gpssim_tpu_torch.parallel import multihost
multihost.initialize({coord!r}, 2, int(sys.argv[1]))
from gpssim_tpu_torch.config import SimConfig
cfg = SimConfig(
    nav_file=os.path.join({repo!r}, "fixtures", "brdc_test.22n"),
    duration_sec=0.5, almanac_enable=False, out_file={out!r},
    noise_std_lsb={noise}, noise_seed=5, device="cpu",
)
part = multihost.run_scenario_multihost(cfg, chan_shards=2, window_blocks=4,
                                        devices=["cpu"] * 4)
print(json.dumps({{"part": part}}))
"""


def _jax_bytes(fixtures_dir, path, noise=0.0):
    """The JAX package's single-process stream of the 0.5 s scenario."""
    from gpssim_tpu.config import SimConfig, SynthBackend
    from gpssim_tpu.runner import run_simulation

    run_simulation(SimConfig(
        nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=0.5,
        almanac_enable=False, backend=SynthBackend.NUMPY, sink="iqfile",
        out_file=path, noise_std_lsb=noise, noise_seed=5,
    ))
    return np.fromfile(path, dtype=np.int8)


def _jax_layout_ranges(n_proc, local_devices, chan_shards, n_blocks):
    """Each process's block range in the JAX package's global mesh:
    devices grouped by process, reshaped (-1, chan_shards), so process p
    owns rows [p*L/chan, (p+1)*L/chan) of the padded batch."""
    rows = n_proc * local_devices // chan_shards
    padded = -(-n_blocks // rows) * rows
    per_row = padded // rows
    mine = local_devices // chan_shards
    return [[[min(p * mine * per_row, n_blocks),
              min((p + 1) * mine * per_row, n_blocks)]]
            for p in range(n_proc)]


@pytest.mark.parametrize("noise", [0.0, 2.0])
def test_two_processes_match_jax_single_process(fixtures_dir, tmp_path,
                                                noise):
    out = str(tmp_path / "mh.bin")
    entry.run_children(_CHILD.format(
        repo=REPO, coord=f"tcp://127.0.0.1:{entry._free_port()}", out=out,
        noise=noise), 2, timeout=300)
    multihost.merge_parts(out, 2)
    a = np.fromfile(out, dtype=np.int8)
    b = _jax_bytes(fixtures_dir, str(tmp_path / "ref.bin"), noise)
    assert a.size == b.size == 4 * 2 * 300_000
    assert np.array_equal(a, b)
    want = _jax_layout_ranges(2, 4, 2, 4)
    for pid in range(2):
        with open(f"{out}.part{pid}.idx") as fp:
            idx = json.load(fp)
        assert idx["ranges"] == want[pid], (pid, idx)
        assert idx["total_blocks"] == 4


def test_four_chan_major_processes_match_jax(fixtures_dir, tmp_path):
    """Every channel-sum term on another process: each process's complete
    stream equals the JAX package's sequential reference."""
    out = str(tmp_path / "mh4.bin")
    results = entry.run_children(entry._MH4_CHILD.format(
        repo=REPO, coord=f"tcp://127.0.0.1:{entry._free_port()}", n_proc=4,
        out=out, layout=json.dumps(entry.child_layout(["cpu"], 4, 2))), 4,
        timeout=300)
    # CPU devices run the plain versions over gloo: no kernel launches
    assert entry._children_result(results) == {
        "backend": "gloo", "launches": {"K1": 0, "K2": 0}}
    b = _jax_bytes(fixtures_dir, str(tmp_path / "ref.bin"))
    for pid in range(4):
        a = np.fromfile(f"{out}.p{pid}", dtype=np.int8)
        assert a.size == b.size and np.array_equal(a, b), pid


def test_parity_exact_requires_native_engine(fixtures_dir, monkeypatch):
    """parity_exact without the native sequential engine fails loudly, as
    in the JAX package, before any process group is needed."""
    from gpssim_tpu_torch.config import SimConfig
    from gpssim_tpu_torch.ops import synth_seq

    monkeypatch.setattr(synth_seq, "_lib", lambda: None)
    cfg = SimConfig(
        nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=0.3,
        almanac_enable=False, parity_exact=True,
        out_file="/tmp/never-written.bin",
    )
    with pytest.raises(RuntimeError, match="native sequential engine"):
        multihost.run_scenario_multihost(cfg, chan_shards=2, window_blocks=4)


def test_cuda_without_card_raises(fixtures_dir, monkeypatch):
    from gpssim_tpu_torch.config import SimConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_devices("cuda")
    cfg = SimConfig(
        nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=0.3,
        almanac_enable=False, parity_exact=False,
        out_file="/tmp/never-written.bin",
    )
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.run_scenario_multihost(cfg, chan_shards=2, window_blocks=4)


def test_merge_parts_refuses_a_gap(tmp_path):
    out = str(tmp_path / "x.bin")
    for pid, rng in enumerate(([[0, 1]], [[2, 3]])):
        np.zeros(2 * 4 * (rng[0][1] - rng[0][0]), np.int8).tofile(
            f"{out}.part{pid}")
        with open(f"{out}.part{pid}.idx", "w") as fp:
            json.dump({"ranges": rng, "total_blocks": 3,
                       "samples_per_block": 4, "bits": 8}, fp)
    with pytest.raises(ValueError, match="gap at block 1"):
        multihost.merge_parts(out, 2)
