"""The PyTorch/CUDA package's run loop and CLI against the JAX package.

The port's pipelined batched path (``backend=cuda`` on CPU tensors, which
run the kernel's plain version) must write the iqfile bytes that the JAX
package's batched XLA path writes for the same scenario, with strict parity
on, at 8 and 16 bits and in integer-NCO mode, and must resume byte-exactly
from a checkpoint that the JAX package wrote mid-run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpssim_tpu import checkpoint as jcheckpoint
from gpssim_tpu import runner as jrunner
from gpssim_tpu.config import CarrierMode as JCarrierMode
from gpssim_tpu.config import SampleFormat as JSampleFormat
from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.config import SynthBackend as JSynthBackend
from gpssim_tpu_torch import checkpoint, cli, runner
from gpssim_tpu_torch.config import (
    CarrierMode, SampleFormat, SimConfig, SynthBackend,
)
from gpssim_tpu_torch.ops.synth_seq import seq_available

LOCATION = "35.681298,139.766247,10.0"  # SimConfig's default location
CASES = {
    "strict-8bit": {},
    "strict-16bit": {"sample_format": "SC16"},
    "int-nco": {"carrier_mode": "INT_NCO"},
}
_JAX_RUNS: dict = {}


def _cfgs(fixtures_dir, tmp_path, case, stem):
    kw = dict(nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=1.5,
              almanac_enable=False, dispatch_blocks=5, sink="iqfile")
    opts = CASES[case]
    jcfg = JSimConfig(
        **kw, backend=JSynthBackend.JAX, out_file=str(tmp_path / f"{stem}j"),
        sample_format=JSampleFormat[opts.get("sample_format", "SC08")],
        carrier_mode=JCarrierMode[opts.get("carrier_mode", "FLOAT")],
    )
    tcfg = SimConfig(
        **kw, backend=SynthBackend.CUDA, device="cpu",
        out_file=str(tmp_path / f"{stem}t"),
        sample_format=SampleFormat[opts.get("sample_format", "SC08")],
        carrier_mode=CarrierMode[opts.get("carrier_mode", "FLOAT")],
    )
    return jcfg, tcfg


def _jax_bytes(fixtures_dir, tmp_path_factory, case) -> np.ndarray:
    """The JAX package's iqfile bytes for ``case`` (run once per case)."""
    if case not in _JAX_RUNS:
        d = tmp_path_factory.mktemp("jax")
        jcfg, _ = _cfgs(fixtures_dir, d, case, "full")
        stats = jrunner.run_simulation(jcfg)
        assert stats.blocks == 14
        _JAX_RUNS[case] = np.fromfile(jcfg.out_file, dtype=np.int8)
    return _JAX_RUNS[case]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _strict_parity():
    assert seq_available(), "the native engine (tools/build_native.sh)"


@pytest.mark.parametrize("case", list(CASES))
def test_batched_run_bytes_equal_jax(fixtures_dir, tmp_path,
                                     tmp_path_factory, case):
    want = _jax_bytes(fixtures_dir, tmp_path_factory, case)
    _, tcfg = _cfgs(fixtures_dir, tmp_path, case, "full")
    assert runner.strict_parity_enabled(tcfg)
    stats = runner.run_simulation(tcfg)
    got = np.fromfile(tcfg.out_file, dtype=np.int8)
    assert stats.blocks == 14 and stats.retries == 0
    bits = 16 if case == "strict-16bit" else 8
    assert got.size == 14 * 2 * tcfg.samples_per_epoch * bits // 8
    assert np.array_equal(want, got)


def test_resume_from_jax_checkpoint(fixtures_dir, tmp_path,
                                    tmp_path_factory):
    """The JAX package stops after its first drained window and writes a
    checkpoint; the port resumes from it on the cuda backend, and head +
    tail equal the uninterrupted stream."""
    want = _jax_bytes(fixtures_dir, tmp_path_factory, "strict-8bit")
    jcfg, _ = _cfgs(fixtures_dir, tmp_path, "strict-8bit", "head")
    snaps = []
    jrunner.run_simulation(
        jcfg,
        on_block=lambda st, sim, plan: snaps.append(
            (st.blocks, sim.consistent_snapshot)),
        stop=lambda: len(snaps) >= 1,
    )
    written, snap = snaps[-1]
    assert written == 5
    ckpt = str(tmp_path / "state.npz")
    jcheckpoint.write_state(ckpt, snap)

    cfg, sim = checkpoint.load_checkpoint(ckpt)
    assert cfg.backend is SynthBackend.CUDA  # "jax" in the checkpoint
    cfg.device = "cpu"
    cfg.out_file = str(tmp_path / "tail")
    stats = runner.run_simulation(cfg, sim=sim)
    assert stats.blocks == 14 - written
    head = np.fromfile(jcfg.out_file, dtype=np.int8)
    tail = np.fromfile(cfg.out_file, dtype=np.int8)
    assert np.array_equal(np.concatenate([head, tail]), want)


def test_cli_bytes_equal_jax(fixtures_dir, tmp_path, tmp_path_factory):
    want = _jax_bytes(fixtures_dir, tmp_path_factory, "strict-8bit")
    out = tmp_path / "cli.bin"
    rc = cli.main([
        "-e", f"{fixtures_dir}/brdc_test.22n", "-d", "1.5", "-l", LOCATION,
        "--disable-almanac", "-r", "iqfile", "--backend", "cuda",
        "--device", "cpu", "--out-file", str(out),
    ])
    assert rc == 0
    assert np.array_equal(np.fromfile(out, dtype=np.int8), want)


@pytest.mark.parametrize("backend,device", [
    ("torch", "cpu"), ("cuda", "cpu"), ("numpy", "cuda"),
])
def test_one_block_windows_bytes_equal_jax(fixtures_dir, tmp_path,
                                           tmp_path_factory, backend, device):
    """dispatch_blocks=1: windows of one block on cuda/torch, the
    block-by-block host path on numpy (whatever the device says)."""
    want = _jax_bytes(fixtures_dir, tmp_path_factory, "strict-8bit")
    _, tcfg = _cfgs(fixtures_dir, tmp_path, "strict-8bit", "blk")
    tcfg = dataclasses.replace(tcfg, backend=SynthBackend(backend),
                               device=device, dispatch_blocks=1,
                               duration_sec=0.6)
    stats = runner.run_simulation(tcfg)
    assert stats.blocks == 5
    got = np.fromfile(tcfg.out_file, dtype=np.int8)
    assert np.array_equal(got, want[:got.size])


def test_transient_error_redispatches_same_kernel(fixtures_dir, tmp_path,
                                                  monkeypatch,
                                                  tmp_path_factory):
    """A device error at drain time re-runs the window once on the same
    kernel (counted in stats.retries); out of memory re-raises."""
    want = _jax_bytes(fixtures_dir, tmp_path_factory, "strict-8bit")
    calls = {"n": 0}
    real = runner.InFlight.result

    def flaky(self):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("CUDA error: fake transient fault")
        return real(self)

    monkeypatch.setattr(runner.InFlight, "result", flaky)
    _, tcfg = _cfgs(fixtures_dir, tmp_path, "strict-8bit", "retry")
    stats = runner.run_simulation(tcfg)
    assert stats.retries == 1
    assert np.array_equal(np.fromfile(tcfg.out_file, dtype=np.int8), want)

    def oom(self):
        raise torch.cuda.OutOfMemoryError("fake out of memory")

    monkeypatch.setattr(runner.InFlight, "result", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        runner.run_simulation(tcfg)


@pytest.mark.parametrize("flag", [
    ["-i"], ["-f"],
    ["--tui"],
    ["-r", "hackrf"],
])
def test_unported_options_raise(fixtures_dir, tmp_path, flag, monkeypatch):
    """The options the port once refused now run with the JAX package's
    meaning: the same bytes as its CLI (``-f`` with the download served
    from the fixture, no network), or, for a radio whose library is
    missing, the same error."""
    import ctypes.util

    from gpssim_tpu import cli as jcli
    from gpssim_tpu.io import fetch as jfetch
    from gpssim_tpu_torch.io import fetch

    nav = f"{fixtures_dir}/brdc_test.22n"
    for mod in (fetch, jfetch):
        monkeypatch.setattr(mod, "fetch_rinex", lambda station, version: nav)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    argv = ["-e", nav, "-d", "0.3", "-l", LOCATION, "--disable-almanac",
            "-r", "iqfile"] + flag
    port = ["--device", "cpu", "--out-file", str(tmp_path / "x.bin")]
    jax = ["--backend", "numpy", "--out-file", str(tmp_path / "j.bin")]
    if flag[0] == "-r":
        for main, extra in ((cli.main, port), (jcli.main, jax)):
            with pytest.raises(RuntimeError,
                               match="hackrf hardware not available"):
                main(argv + extra)
        return
    assert cli.main(argv + port) == 0 == jcli.main(argv + jax)
    got = np.fromfile(tmp_path / "x.bin", dtype=np.int8)
    assert got.size == 2 * 600_000
    assert np.array_equal(got, np.fromfile(tmp_path / "j.bin", dtype=np.int8))
    cfg = SimConfig(nav_file=nav, duration_sec=0.3, almanac_enable=False,
                    device="cpu", out_file=str(tmp_path / "r.bin"))
    stats = runner.run_simulation(dataclasses.replace(cfg, interactive=True))
    assert stats.blocks == 2
    assert np.array_equal(np.fromfile(cfg.out_file, dtype=np.int8), got)
