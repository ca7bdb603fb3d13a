"""Acquisition of the PyTorch/CUDA package (``gpssim_tpu_torch.acquire``)
on the CPU, against the JAX package's ``numpy`` and ``jax`` backends.

The torch backend searches the whole (Doppler bin x PRN) grid in
complex64; it must find the same PRNs at the same Doppler bin and code
phase as both JAX-package backends, with SNR within 1e-2 relative."""

import numpy as np
import pytest
import torch

from gpssim_tpu import acquire as jacq
from gpssim_tpu_torch import acquire as tacq
from gpssim_tpu_torch.config import SimConfig, SynthBackend
from gpssim_tpu_torch.runner import run_simulation
from gpssim_tpu_torch.scenario import Simulation


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(fixtures_dir, out, **kw):
    return SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                     almanac_enable=False, backend=SynthBackend.NATIVE,
                     sink="iqfile", out_file=out, **kw)


@pytest.fixture(scope="module")
def generated(fixtures_dir, tmp_path_factory):
    """A 1 s capture written by the port, and its first block's plan."""
    out = str(tmp_path_factory.mktemp("acq") / "iq.bin")
    cfg = _cfg(fixtures_dir, out, duration_sec=1.0)
    first_plan = Simulation(cfg).step()
    run_simulation(cfg)
    return out, first_plan


def _same_detections(got, ref):
    got = {d.prn: d for d in got}
    ref = {d.prn: d for d in ref}
    assert set(got) == set(ref)
    for prn, d in ref.items():
        g = got[prn]
        assert g.doppler_hz == d.doppler_hz, prn
        assert g.code_phase_chips == d.code_phase_chips, prn
        assert abs(g.snr - d.snr) / d.snr < 1e-2, (prn, g.snr, d.snr)


@pytest.mark.parametrize("jax_backend", ["numpy", "jax"])
def test_torch_backend_matches_jax_package(generated, jax_backend):
    out, _ = generated
    x = tacq.load_iq(out, 8)
    assert np.array_equal(x, jacq.load_iq(out, 8))
    _same_detections(tacq.acquire(x, backend="torch", device="cpu"),
                     jacq.acquire(x, backend=jax_backend))


def test_numpy_backend_is_the_jax_packages(generated):
    out, _ = generated
    x = tacq.load_iq(out, 8)
    got, ref = tacq.acquire(x), jacq.acquire(x)
    assert [(d.prn, d.doppler_hz, d.code_phase_chips, d.snr) for d in got] \
        == [(d.prn, d.doppler_hz, d.code_phase_chips, d.snr) for d in ref]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_all_simulated_prns_acquired(generated, backend):
    out, plan = generated
    dets = tacq.acquire(tacq.load_iq(out, 8), backend=backend, device="cpu")
    active = {int(p) for p in plan.prn[plan.active]}
    assert {d.prn for d in dets} == active, "wrong PRN set acquired"
    by_prn = {d.prn: d for d in dets}
    for slot in np.nonzero(plan.active)[0]:
        d = by_prn[int(plan.prn[slot])]
        assert abs(d.doppler_hz - plan.f_carr[slot]) <= 300.0
        err = (d.code_phase_chips - plan.code_phase[slot]) % 1023.0
        assert min(err, 1023.0 - err) <= 2.0


def test_nav_bits_demodulate(fixtures_dir, tmp_path):
    """Coherent demodulation recovers the exact transmitted nav-message
    bits, and gives the JAX package's bits on the same capture."""
    from gpssim_tpu_torch.core.navmsg import data_bit

    out = str(tmp_path / "iq.bin")
    cfg = _cfg(fixtures_dir, out, duration_sec=1.6)
    plans = list(Simulation(cfg).iter_plans())
    run_simulation(cfg)
    x = tacq.load_iq(out, 8)
    slot = int(np.nonzero(plans[0].active)[0][0])
    bits, start_bit = tacq.demodulate_bits(x, plans, slot)
    assert len(bits) >= 70
    dwrd = plans[0].dwrd[slot]
    expect = np.array([
        (data_bit(dwrd, (start_bit + k) // 30, (start_bit + k) % 30) + 1)
        // 2 for k in range(len(bits))
    ], dtype=np.uint8)
    assert np.array_equal(bits, expect)
    jbits, jstart = jacq.demodulate_bits(x, plans, slot)
    assert np.array_equal(bits, jbits) and start_bit == jstart


def test_subframe_tow_decode(fixtures_dir, tmp_path):
    """Preambles 300 bits apart with consecutive TOW counts, consistent
    with the scenario clock, and the JAX package's decode."""
    out = str(tmp_path / "iq.bin")
    cfg = _cfg(fixtures_dir, out, duration_sec=13.0)
    sim = Simulation(cfg)
    g0 = sim.g0
    plans = list(sim.iter_plans())
    run_simulation(cfg)
    x = tacq.load_iq(out, 8)
    slot = int(np.nonzero(plans[0].active)[0][0])
    bits, start_bit = tacq.demodulate_bits(x, plans, slot)
    subframes = tacq.decode_tow(bits)
    assert subframes == jacq.decode_tow(bits)
    assert len(subframes) >= 2
    offs = [o for o, _ in subframes]
    tows = [t for _, t in subframes]
    assert all(b - a == 300 for a, b in zip(offs, offs[1:]))
    assert all(b - a == 1 for a, b in zip(tows, tows[1:]))
    sub_start = g0.sec - 6.0 + (start_bit + offs[0]) * 0.020
    dmod = (tows[0] * 6.0 - (sub_start + 6.0)) % 604800.0
    assert min(dmod, 604800.0 - dmod) < 1e-6


def test_load_iq_tolerates_truncated_half_pair(tmp_path):
    p = str(tmp_path / "odd.bin")
    np.arange(7, dtype=np.int8).tofile(p)
    x = tacq.load_iq(p, 8)
    assert len(x) == 3 and x[0] == 0 + 1j


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_snr_is_shift_invariant_at_buffer_edges(backend):
    n = 3000
    code = tacq._resampled_codes(3e6, n)[4]  # PRN 5
    rng = np.random.default_rng(1)
    x = np.tile(code, 5).astype(np.complex64) * 50.0
    x = x + (rng.normal(size=x.size)
             + 1j * rng.normal(size=x.size)).astype(np.complex64) * 5.0
    snrs = []
    for roll in (0, 1, n - 1, 1234):
        dets = tacq.acquire(np.roll(x, roll), prns=[5], max_doppler_hz=250.0,
                            backend=backend, device="cpu")
        assert len(dets) == 1, roll
        snrs.append(dets[0].snr)
    assert max(snrs) / min(snrs) < 1.1, snrs


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_no_false_positives_on_noise(backend):
    rng = np.random.default_rng(0)
    noise = (rng.normal(size=8 * 3000)
             + 1j * rng.normal(size=8 * 3000)).astype(np.complex64) * 100.0
    assert tacq.acquire(noise, backend=backend, device="cpu") == []


def test_acquire_cli(generated, capsys):
    out, _ = generated
    assert tacq.main([out, "--bits", "8"]) == 0
    numpy_text = capsys.readouterr().out
    assert "PRNs acquired" in numpy_text and "doppler" in numpy_text
    assert tacq.main([out, "--backend", "torch", "--device", "cpu"]) == 0
    torch_text = capsys.readouterr().out
    assert torch_text.splitlines()[0] == numpy_text.splitlines()[0]


def test_backend_validation():
    with pytest.raises(ValueError, match="unknown acquisition backend"):
        tacq.acquire(np.zeros(40_000, np.complex64), backend="jax")


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tacq.acquire(np.zeros(40_000, np.complex64), backend="torch")
    # the NumPy backend never touches a device
    assert tacq.acquire(np.zeros(40_000, np.complex64) + 1) == []
