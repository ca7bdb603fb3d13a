"""The software receiver of the PyTorch/CUDA package
(``gpssim_tpu_torch.receiver``, whose acquisition is the port's) against
the JAX package's, on the CPU.

One 20 s capture written by the port: both packages' ``receiver_fix`` must
give the same fix, bit for bit (position, receive time, PRNs, decoded
ephemerides). Tracking costs ~7 s of one core per channel, so both
receivers track the five strongest channels, with numpy's BLAS on one
thread (more threads only slow the small products of the tracking loop
down). The decode and PVT cases of
the JAX package's receiver tests follow, on the port's functions."""

import contextlib

import numpy as np
import pytest

from gpssim_tpu_torch.acquire import load_iq
from gpssim_tpu_torch.config import LocationConfig, SimConfig, SynthBackend
from gpssim_tpu_torch.core.almanac import Almanac
from gpssim_tpu_torch.core.atmosphere import IonoUtc
from gpssim_tpu_torch.core.constants import OMEGA_EARTH, SPEED_OF_LIGHT
from gpssim_tpu_torch.core.ephemeris import read_rinex_nav
from gpssim_tpu_torch.core.gpstime import GpsTime
from gpssim_tpu_torch.core.navmsg import eph2sbf, generate_nav_msg
from gpssim_tpu_torch.core.orbits import EphemerisSet, satpos
from gpssim_tpu_torch.receiver import (
    Observation, decode_ephemeris, decode_frames, decode_iono_utc, pvt_solve,
    receiver_fix,
)
from gpssim_tpu_torch.runner import run_simulation
from gpssim_tpu_torch.scenario import Simulation

RATE = 2_600_000
CHANNELS = 5
_EPH_FIELDS = ("vflg", "toc_sec", "toe_sec", "toc_week", "iode", "iodc",
               "tgd", "af0", "af1", "af2", "crs", "crc", "cuc", "cus",
               "cic", "cis", "deltan", "omgdot", "idot", "m0", "omg0",
               "inc0", "aop", "ecc", "sqrta")


@pytest.fixture(scope="module")
def rx_scenario(fixtures_dir, tmp_path_factory):
    """20 s static scenario, iono off, written by the port's native
    engine."""
    out = str(tmp_path_factory.mktemp("rx") / "iq.bin")
    cfg = SimConfig(
        nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=20.0,
        sample_rate=RATE, almanac_enable=False, ionosphere_enable=False,
        backend=SynthBackend.NATIVE, sink="iqfile", out_file=out,
        location=LocationConfig(35.681298, 139.766247, 10.0),
    )
    sim = Simulation(cfg)
    truth = np.array(sim.xyz0)
    week = sim.g0.week
    run_simulation(cfg, sim=sim)
    return out, truth, week


def _one_blas_thread():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        return contextlib.nullcontext()
    return threadpool_limits(1, user_api="blas")


def test_fix_equals_jax_receivers(rx_scenario):
    from gpssim_tpu import receiver as jrx
    from gpssim_tpu.acquire import load_iq as jload

    out, truth, week = rx_scenario
    x = load_iq(out, 8)
    assert np.array_equal(x, jload(out, 8))
    with _one_blas_thread():
        fix, chans, eph, iono = receiver_fix(x, RATE, week_hint=week,
                                             max_channels=CHANNELS)
        jfix, jchans, jeph, jiono = jrx.receiver_fix(
            x, RATE, week_hint=week, max_channels=CHANNELS)
    assert np.array_equal(fix.xyz, jfix.xyz)
    assert fix.t_rx == jfix.t_rx
    assert fix.prns == jfix.prns and len(fix.prns) == CHANNELS
    assert np.array_equal(fix.vel, jfix.vel)
    assert [c.prn for c in chans] == [c.prn for c in jchans]
    for name in _EPH_FIELDS:
        assert np.array_equal(getattr(eph, name), getattr(jeph, name)), name
    assert iono.vflg == jiono.vflg
    assert np.linalg.norm(fix.xyz - truth) < 5.0
    assert fix.residual_rms_m < 1.0


def _frame_bits(dwrd):
    return np.array([(int(dwrd[w]) >> (29 - b)) & 1
                     for w in range(60) for b in range(30)], dtype=np.uint8)


def test_lnav_decode_roundtrip(fixtures_dir):
    """decode_frames/decode_ephemeris/decode_iono_utc invert the
    serializer: the decoded words re-encode, page 18 bit-identically."""
    nav = read_rinex_nav(f"{fixtures_dir}/brdc_test.22n")
    eph_true = nav.sets[0]
    sv = int(np.nonzero(eph_true.vflg)[0][0])
    alm = Almanac()
    sbf = eph2sbf(eph_true, sv, nav.ionoutc, alm)
    dwrd = np.zeros(60, dtype=np.uint32)
    generate_nav_msg(GpsTime(eph_true.toc_week[sv], 345600.0), sbf, dwrd,
                     ipage=17, init=True)
    frames = decode_frames(_frame_bits(dwrd))
    tows = [t for _, t in frames.tows]
    assert all(b - a == 1 for a, b in zip(tows, tows[1:]))
    assert {1, 2, 3} <= set(frames.subframes) and 56 in frames.pages4
    rx_eph = EphemerisSet()
    decode_ephemeris(frames, sv + 1, int(eph_true.toc_week[sv]), rx_eph)
    rx_eph.finalize()
    assert int(rx_eph.toc_week[sv]) == int(eph_true.toc_week[sv])
    rx_iono = decode_iono_utc(frames)
    assert rx_iono.vflg
    again = eph2sbf(rx_eph, sv, rx_iono, alm)
    assert np.array_equal(again[3 + 17 * 2], sbf[3 + 17 * 2]), "page 18"


def test_almanac_page_decode_roundtrip(fixtures_dir):
    from gpssim_tpu_torch.core.almanac import read_sem_almanac
    from gpssim_tpu_torch.receiver import DecodedFrames, decode_almanac

    nav = read_rinex_nav(f"{fixtures_dir}/brdc_test.22n")
    eph_true = nav.sets[0]
    sv = int(np.nonzero(eph_true.vflg)[0][0])
    alm = read_sem_almanac(f"{fixtures_dir}/almanac_test.sem")
    sbf = eph2sbf(eph_true, sv, nav.ionoutc, alm)
    g = GpsTime(eph_true.toc_week[sv], 345600.0)
    merged = DecodedFrames()
    for page in range(25):
        dwrd = np.zeros(60, dtype=np.uint32)
        generate_nav_msg(g, sbf, dwrd, ipage=page, init=True)
        frames = decode_frames(_frame_bits(dwrd))
        merged.pages4.update(frames.pages4)
        merged.pages5.update(frames.pages5)
    week = next(int(a.toa.week) for a in alm.sv if a.svid)
    rx_alm = decode_almanac(merged, week_hint=week)
    assert rx_alm.valid
    again = eph2sbf(eph_true, sv, nav.ionoutc, rx_alm)
    rows = [3 + i * 2 for i in (1, 2, 3, 4, 6, 7, 8, 9)]
    rows += [4 + i * 2 for i in range(25)]
    for r in rows:
        assert np.array_equal(again[r], sbf[r]), f"sbf row {r}"
    assert [a.svid for a in rx_alm.sv] == [a.svid for a in alm.sv]


def test_global_bit_inversion_is_transparent(fixtures_dir):
    nav = read_rinex_nav(f"{fixtures_dir}/brdc_test.22n")
    eph_true = nav.sets[0]
    sv = int(np.nonzero(eph_true.vflg)[0][0])
    sbf = eph2sbf(eph_true, sv, nav.ionoutc, Almanac())
    dwrd = np.zeros(60, dtype=np.uint32)
    generate_nav_msg(GpsTime(eph_true.toc_week[sv], 345600.0), sbf, dwrd,
                     ipage=0, init=True)
    bits = _frame_bits(dwrd)
    a, b = decode_frames(bits), decode_frames(1 - bits)
    assert a.subframes.keys() == b.subframes.keys() and len(a.subframes) >= 3
    for k in a.subframes:
        assert a.subframes[k] == b.subframes[k]


def _synthetic_obs(eph, truth, t_rx, iono=None, llh=None):
    """Observations of up to 7 visible satellites from the forward model,
    optionally delayed by the Klobuchar model."""
    from gpssim_tpu_torch.core.atmosphere import ionospheric_delay
    from gpssim_tpu_torch.core.frames import ecef2neu, ltcmat, neu2azel

    obs = []
    for sv in np.nonzero(eph.vflg)[0]:
        pos, _, _ = satpos(eph, t_rx, np.array([sv]))
        if np.dot(pos[0] - truth, truth) < 0:  # below the horizon
            continue
        tau = t_rx - 0.07
        for _ in range(8):
            pos, _, clk = satpos(eph, tau, np.array([sv]))
            tof = t_rx - tau
            sat = np.array([pos[0, 0] + pos[0, 1] * OMEGA_EARTH * tof,
                            pos[0, 1] - pos[0, 0] * OMEGA_EARTH * tof,
                            pos[0, 2]])
            tau = t_rx - np.linalg.norm(sat - truth) / SPEED_OF_LIGHT \
                + clk[0, 0]
        if iono is not None:
            azel = neu2azel(ecef2neu(sat - truth, ltcmat(llh)))
            tau -= float(ionospheric_delay(iono, t_rx, llh,
                                           np.asarray(azel))) / SPEED_OF_LIGHT
        obs.append(Observation(int(sv) + 1, float(tau), 0.0))
        if len(obs) == 7:
            break
    assert len(obs) >= 6, "fixture lacks visible satellites"
    t_nom = max(o.tau_sv for o in obs) + 0.076
    for o in obs:
        o.pr_rel = SPEED_OF_LIGHT * (t_nom - o.tau_sv)
    return obs, t_nom


TRUTH = np.array([-3959617.482, 3350136.615, 3699531.459])


def test_pvt_solver_raim_rejects_outlier(fixtures_dir):
    from gpssim_tpu import receiver as jrx

    eph = read_rinex_nav(f"{fixtures_dir}/brdc_test.22n").sets[0]
    t_rx = float(eph.toc_sec[np.nonzero(eph.vflg)[0][0]]) + 1800.0
    obs, t_nom = _synthetic_obs(eph, TRUTH, t_rx)
    bad = obs[2].prn
    obs[2].pr_rel += 30.0
    off = IonoUtc()
    off.enable = False
    fix = pvt_solve(obs, eph, off, t_nom)
    assert bad not in fix.prns, "outlier not rejected"
    assert np.linalg.norm(fix.xyz - TRUTH) < 0.5
    assert abs(fix.t_rx - t_rx) < 1e-9
    jfix = jrx.pvt_solve(obs, eph, off, t_nom)
    assert np.array_equal(fix.xyz, jfix.xyz) and fix.prns == jfix.prns


def test_pvt_klobuchar_correction(fixtures_dir):
    from gpssim_tpu_torch.core.frames import xyz2llh

    nav = read_rinex_nav(f"{fixtures_dir}/brdc_test.22n")
    eph = nav.sets[0]
    t_rx = float(eph.toc_sec[np.nonzero(eph.vflg)[0][0]]) + 1800.0
    obs, t_nom = _synthetic_obs(eph, TRUTH, t_rx, iono=nav.ionoutc,
                                llh=xyz2llh(TRUTH))
    err_cor = np.linalg.norm(pvt_solve(obs, eph, nav.ionoutc, t_nom).xyz
                             - TRUTH)
    assert err_cor < 1.0
    off = IonoUtc()
    off.enable = False
    err_raw = np.linalg.norm(pvt_solve(obs, eph, off, t_nom).xyz - TRUTH)
    assert err_raw > err_cor + 2.0


def test_receiver_cli(rx_scenario, monkeypatch, capsys):
    """The CLI prints the fix summary (the chain is covered above)."""
    import gpssim_tpu_torch.receiver as rxmod
    from gpssim_tpu_torch.core.frames import xyz2llh

    out, truth, _ = rx_scenario
    called = {}

    def fake_fix(x, rate, week_hint, **kw):
        called["n"] = len(x)
        fix = rxmod.Fix(xyz=truth, llh=xyz2llh(truth), clock_bias_m=1.0,
                        t_rx=0.0, nsats=7, residual_rms_m=0.2,
                        prns=[1, 2, 3, 4, 5, 6, 7])
        return fix, [], EphemerisSet(), IonoUtc()

    monkeypatch.setattr(rxmod, "receiver_fix", fake_fix)
    assert rxmod.main([out, "--bits", "8", "--rate", str(RATE)]) == 0
    text = capsys.readouterr().out
    assert "fix: lat 35.68" in text and "ECEF" in text
    assert called["n"] == 20 * RATE - RATE // 10


def test_package_exports_acquire_and_receiver_fix():
    import gpssim_tpu_torch
    from gpssim_tpu_torch import acquire as acq_mod

    assert gpssim_tpu_torch.receiver_fix is receiver_fix
    assert "acquire" in gpssim_tpu_torch.__all__
    assert callable(acq_mod.acquire)
