"""Stream verification of the PyTorch/CUDA package (``gpssim_tpu_torch.qa``)
against the JAX package's ``verify_stream``, on the CPU.

Each capture is written once by the port and verified by both packages:
they must agree on the blocks verified, the PRN list and every verdict,
and each mean and min ratio within 1e-4 (float32 sums in a different
order)."""

import dataclasses

import numpy as np
import pytest
import torch

import gpssim_tpu.config as jconfig
import gpssim_tpu_torch.config as tconfig
from gpssim_tpu.qa import verify_stream as jax_verify
from gpssim_tpu_torch.qa import verify_stream
from gpssim_tpu_torch.runner import run_simulation

TOKYO = (35.681298, 139.766247, 10.0)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(fixtures_dir, out, location=TOKYO, duration_sec=1.0, bits=8,
          int_nco=False, **kw):
    """(port config writing with the native engine, JAX config) of one
    scenario."""
    def make(m, **extra):
        return m.SimConfig(
            nav_file=f"{fixtures_dir}/brdc_test.22n", almanac_enable=False,
            sink="iqfile", out_file=out, duration_sec=duration_sec,
            location=m.LocationConfig(*location),
            sample_format=m.SampleFormat(bits),
            carrier_mode=(m.CarrierMode.INT_NCO if int_nco
                          else m.CarrierMode.FLOAT),
            **kw, **extra)

    return (make(tconfig, backend=tconfig.SynthBackend.NATIVE, device="cpu"),
            make(jconfig))


def _both(path, tcfg, jcfg):
    """Both packages' reports on one capture, held to agree."""
    rep = verify_stream(path, tcfg)
    ref = jax_verify(path, jcfg)
    assert rep.blocks == ref.blocks
    assert [c.prn for c in rep.channels] == [c.prn for c in ref.channels]
    for a, b in zip(rep.channels, ref.channels):
        assert a.ok == b.ok, (a, b)
        assert abs(a.mean_ratio - b.mean_ratio) < 1e-4, (a, b)
        assert abs(a.min_ratio - b.min_ratio) < 1e-4, (a, b)
    assert rep.ok == ref.ok
    return rep


@pytest.fixture(scope="module")
def clean(fixtures_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("qa") / "iq.bin")
    tcfg, jcfg = _cfgs(fixtures_dir, out)
    run_simulation(tcfg)
    return out, tcfg, jcfg


def test_clean_stream_verifies(clean):
    rep = _both(*clean)
    assert rep.ok and rep.blocks == 9
    assert len(rep.channels) >= 6
    for ch in rep.channels:
        assert abs(ch.mean_ratio - 1.0) < 0.05, (ch.prn, ch.mean_ratio)


def test_corruption_detected(clean, tmp_path):
    out, tcfg, jcfg = clean
    raw = np.fromfile(out, np.int8)
    raw[1_000_000:1_300_000] = 0  # 50 ms hole mid-stream
    bad = str(tmp_path / "bad.bin")
    raw.tofile(bad)
    rep = _both(bad, tcfg, jcfg)
    assert not rep.ok
    assert min(ch.min_ratio for ch in rep.channels) < 0.1


def test_wrong_scenario_detected(clean, fixtures_dir):
    out, _, _ = clean
    tcfg, jcfg = _cfgs(fixtures_dir, out, location=(40.0, -74.0, 20.0))
    assert not _both(out, tcfg, jcfg).ok


@pytest.mark.parametrize("kw", [
    dict(noise_std_lsb=3.0, noise_seed=4), dict(bits=16), dict(int_nco=True),
], ids=["noisy", "16bit", "int-nco"])
def test_noisy_and_16bit_and_intnco_verify(fixtures_dir, tmp_path, kw):
    out = str(tmp_path / "iq.bin")
    tcfg, jcfg = _cfgs(fixtures_dir, out, duration_sec=0.5, **kw)
    run_simulation(tcfg)
    rep = _both(out, tcfg, jcfg)
    assert rep.ok, (kw, [(c.prn, c.mean_ratio, c.min_ratio)
                         for c in rep.channels])


def test_qa_cli(fixtures_dir, tmp_path, capsys):
    from gpssim_tpu_torch import qa

    out = str(tmp_path / "iq.bin")
    run_simulation(_cfgs(fixtures_dir, out, duration_sec=0.5)[0])
    common = ["-e", f"{fixtures_dir}/brdc_test.22n", "-d", "0.5",
              "--disable-almanac", "--device", "cpu"]
    assert qa.main([out, "-l", "35.681298,139.766247,10.0", *common]) == 0
    assert "VERIFIED" in capsys.readouterr().out
    assert qa.main([out, "-l", "0,0,0", *common]) == 1
    assert "FAILED" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        qa.main([out, "--fleet", "roster.csv", *common])


def test_fleet_outputs_verify(fixtures_dir, tmp_path):
    """Every fleet member's file verifies against its own scenario, and
    against a sibling's scenario it fails (streams are member-specific)."""
    from gpssim_tpu_torch.fleet import run_fleet

    pairs = [_cfgs(fixtures_dir, str(tmp_path / f"m{i}.bin"),
                   location=(35.0 + i, 139.0 - i, 10.0), duration_sec=0.5)
             for i in range(2)]
    run_fleet([dataclasses.replace(t, backend=tconfig.SynthBackend.TORCH)
               for t, _ in pairs], window=4)
    for tcfg, jcfg in pairs:
        assert _both(tcfg.out_file, tcfg, jcfg).ok
    assert not _both(pairs[0][0].out_file, pairs[1][0], pairs[1][1]).ok


def test_cuda_without_card_raises(clean, monkeypatch):
    out, tcfg, _ = clean
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_stream(out, dataclasses.replace(tcfg, device="cuda"))


def test_correlate_matches_float64_on_random_planes():
    """The device correlator against a float64 numpy statement of the same
    sums, on random planes."""
    from gpssim_tpu_torch.qa import correlate

    rng = np.random.default_rng(3)
    B, C, N, ms = 2, 3, 1000, 10
    re, im = (rng.normal(size=(B, N)).astype(np.float32) for _ in range(2))
    chips = rng.choice(np.array([-1, 1], np.int16), size=(B, C, N))
    frac = rng.uniform(0, 50, size=(B, C, N)).astype(np.float32)
    got = correlate(*(torch.from_numpy(a) for a in (re, im, chips, frac)),
                    ms).numpy()
    x = (re + 1j * im)[:, None, :].astype(np.complex128)
    rep = chips * np.exp(-2j * np.pi * frac.astype(np.float64))
    want = np.abs((x * rep).reshape(B, C, ms, N // ms).sum(-1)) / (N // ms)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
