"""The PyTorch/CUDA package's radio bindings against the JAX package.

No SDR exists here, so the port's ctypes bindings (``io/hw_hackrf.py``,
``io/hw_pluto.py``) run against the mock shared libraries of
``native/mock_hackrf.c`` and ``native/mock_iio.c``, which implement the
libhackrf/libiio ABI subset and record every call; each test builds its
own copy with ``cc``, since a mock keeps global state. The cases are those
of ``tests/test_hw_bindings.py``; a run into a mock radio through the
port's runner (``backend=cuda`` on the CPU) captures the JAX package's
bytes. Without a library, both packages' sinks raise the same error.
"""

import ctypes
import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.config import SampleFormat as JSampleFormat
from gpssim_tpu.config import SynthBackend as JSynthBackend
from gpssim_tpu.io import sinks as jsinks
from gpssim_tpu.runner import run_simulation as jrun_simulation
from gpssim_tpu_torch.config import SampleFormat, SimConfig, SynthBackend
from gpssim_tpu_torch.io import hw_hackrf, hw_pluto, sinks
from gpssim_tpu_torch.runner import run_simulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build_mock(tmp_path_factory, name):
    src = os.path.join(REPO, "native", f"{name}.c")
    out = os.path.join(str(tmp_path_factory.mktemp(name)), f"lib{name}.so")
    subprocess.run(
        ["cc", "-O2", "-shared", "-fPIC", "-pthread", "-o", out, src],
        check=True, capture_output=True,
    )
    return out


def _mock(path):
    mock = ctypes.CDLL(path)
    for name, restype in (("mock_copy_capture", ctypes.c_long),
                          ("mock_attr", ctypes.c_char_p),  # iio only
                          ("mock_net_host", ctypes.c_char_p),
                          ("mock_freq", ctypes.c_uint64),  # hackrf only
                          ("mock_sample_rate", ctypes.c_double)):
        if hasattr(mock, name):
            getattr(mock, name).restype = restype
    return mock


def _capture(mock, n: int) -> np.ndarray:
    got = np.empty(n, dtype=np.int8)
    assert mock.mock_copy_capture(got.ctypes.data_as(ctypes.c_void_p), n) == n
    return got


@pytest.mark.parametrize("name", ["hackrf", "plutosdr"])
def test_sink_without_library_raises_jax_error(monkeypatch, name):
    """The fault the port had: its radio sinks imported modules it lacked
    (ModuleNotFoundError). Now, with the library missing, ``init`` raises
    the JAX package's RuntimeError, word for word, and binds no null
    device."""
    import ctypes.util

    monkeypatch.setattr(ctypes.util, "find_library", lambda lib: None)
    cfg = SimConfig()
    errors = []
    for mod in (sinks, jsinks):
        sink = mod.make_sink(name, lib_path="/nonexistent/lib.so")
        with pytest.raises(RuntimeError) as e:
            sink.init(cfg)
        errors.append(str(e.value))
        sink = mod.make_sink(name)  # the default: the system library
        with pytest.raises(RuntimeError, match="hardware not available"):
            sink.init(cfg)
        assert sink.device is None
    assert errors[0] == errors[1] and "hardware not available" in errors[0]


@pytest.mark.parametrize("available", [hw_hackrf.hackrf_available,
                                       hw_pluto.iio_available])
def test_availability_guard(available):
    """A bogus explicit path reports unavailable; it does not raise."""
    assert available("/nonexistent/libhackrf.so") is False


def test_hackrf_full_tx_contract(tmp_path_factory):
    """Init → configure → FIFO-fed pull TX → teardown, per sdr_hackrf.c."""
    path = _build_mock(tmp_path_factory, "mock_hackrf")
    tx = hw_hackrf.HackRfTx(tx_gain=60, amp=True, ppb=25, lib_path=path,
                            fifo_depth=4)
    mock = _mock(path)
    assert tx.info["serial"] == "MOCKSERIAL0001"
    assert tx.info["version"] == "mock-fw-1.0"
    assert mock.mock_freq() == 1_575_420_000 * (10_000_000 - 25) // 10_000_000
    assert mock.mock_sample_rate() == 3_000_000.0
    assert mock.mock_gain() == 47  # 60 dB clamped to TX_IF_GAIN_MAX
    assert mock.mock_amp() == 1
    assert mock.mock_antenna() == 0
    assert mock.mock_hw_sync() == 0

    sink = sinks.HackRfSink(device=tx.push)
    sink.init()
    rng = np.random.default_rng(5)
    blocks = [rng.integers(-128, 128, 600_000, dtype=np.int8)
              for _ in range(3)]
    t = threading.Thread(target=lambda: [sink.write(b) for b in blocks],
                         daemon=True)
    t.start()
    tx.start(timeout_s=10.0)  # start-full barrier (sdr_hackrf.c:258)
    t.join(timeout=20)
    assert not t.is_alive()

    stream = np.concatenate(blocks)
    want = len(stream) // hw_hackrf.TRANSFER_SIZE * hw_hackrf.TRANSFER_SIZE
    deadline = time.time() + 5
    while mock.mock_captured_bytes() < want and time.time() < deadline:
        time.sleep(0.05)
    tx.close()
    assert np.array_equal(_capture(mock, want), stream[:want])
    assert mock.mock_teardown_ok() == 1  # stop, amp off, gain 0, close, exit


def test_pluto_full_tx_contract(tmp_path_factory):
    """Context → AD9361 setup → LO on → whole-block pushes → teardown,
    per sdr_pluto.c:100-277."""
    path = _build_mock(tmp_path_factory, "mock_iio")
    tx = hw_pluto.PlutoTx(tx_gain=5, ppb=0, lib_path=path)
    mock = _mock(path)

    def attr(key):
        return mock.mock_attr(key.encode()).decode()

    assert attr("phy.voltage0.rf_port_select") == "A"
    assert attr("phy.voltage0.rf_bandwidth") == "6000000"
    assert attr("phy.voltage0.sampling_frequency") == "3000000"
    assert attr("phy.voltage0.hardwaregain") == "0"  # +5 dB clamped to 0
    assert attr("phy.altvoltage0.powerdown") == "1"  # RX LO off
    assert attr("phy.altvoltage1.frequency") == "1575420000"
    assert attr("phy.altvoltage1.powerdown") == ""  # not yet started
    assert mock.mock_enabled_channels() == 2
    assert mock.mock_kernel_buffers() == 8

    tx.start()
    assert attr("phy.altvoltage1.powerdown") == "0"  # TX LO on
    sink = sinks.PlutoSink(device=tx.push)
    sink.init()
    rng = np.random.default_rng(6)
    blocks = [rng.integers(-2048, 2048, 2 * hw_pluto.NUM_IQ_SAMPLES,
                           dtype=np.int16) for _ in range(2)]
    for b in blocks:
        sink.write(b)
    assert mock.mock_pushes() == 2
    want = np.concatenate(blocks)
    assert np.array_equal(_capture(mock, want.nbytes).view(np.int16), want)
    tx.close()
    assert attr("phy.altvoltage1.powerdown") == "1"  # LO off on teardown
    assert mock.mock_teardown_ok() == 1


@pytest.mark.parametrize("hostname", ["pluto.example", None])
def test_pluto_context_selection(tmp_path_factory, hostname):
    """A hostname takes iio_create_network_context (sdr_pluto.c:141-142);
    none takes the default (local USB) context first (gps-sim.c:204,
    sdr_pluto.c:147)."""
    path = _build_mock(tmp_path_factory, "mock_iio")
    tx = hw_pluto.PlutoTx(hostname=hostname, lib_path=path)
    mock = _mock(path)
    assert mock.mock_used_network() == (hostname is not None)
    if hostname:
        assert mock.mock_net_host() == hostname.encode()
    tx.close()


def test_hackrf_callback_blocks_through_producer_stall(tmp_path_factory):
    """A producer stall longer than a second starves the radio briefly and
    does not end the stream: the pull callback blocks on the FIFO with no
    timeout, like the reference's fifo_dequeue (fifo.c:174-194)."""
    path = _build_mock(tmp_path_factory, "mock_hackrf")
    tx = hw_hackrf.HackRfTx(lib_path=path, fifo_depth=2)
    mock = _mock(path)
    n = hw_hackrf.TRANSFER_SIZE
    data = (np.arange(n) % 251 - 125).astype(np.int8)
    tx.push(data)
    tx.push(data)
    tx.start(timeout_s=10.0)

    def wait_captured(want, timeout=10.0):
        deadline = time.time() + timeout
        while mock.mock_captured_bytes() < want and time.time() < deadline:
            time.sleep(0.02)
        return mock.mock_captured_bytes()

    assert wait_captured(2 * n) == 2 * n
    time.sleep(1.4)  # stall longer than any give-up timeout
    tx.push(data)  # the stream must still be alive
    assert wait_captured(3 * n) == 3 * n
    tx.close()
    assert mock.mock_teardown_ok() == 1


def test_pluto_sample_rate_follows_stream(tmp_path_factory):
    """The device's sampling_frequency/rf_bandwidth and the TX buffer size
    follow the stream's rate; a short final block is zero-padded; an
    oversize block raises."""
    path = _build_mock(tmp_path_factory, "mock_iio")
    tx = hw_pluto.PlutoTx(lib_path=path, sample_rate=2_000_000)
    mock = _mock(path)

    def attr(key):
        return mock.mock_attr(key.encode()).decode()

    assert attr("phy.voltage0.sampling_frequency") == "2000000"
    assert attr("phy.voltage0.rf_bandwidth") == "4000000"
    num_iq = 2_000_000 // 10
    full = (np.arange(2 * num_iq) % 1024 - 512).astype(np.int16)
    tx.push(full)
    assert mock.mock_captured_bytes() == full.nbytes
    short = np.full(2 * 100, 7, dtype=np.int16)
    tx.push(short)  # padded to one whole buffer
    got = _capture(mock, 2 * full.nbytes).view(np.int16)
    assert np.array_equal(got[: full.size], full)
    assert np.array_equal(got[full.size : full.size + short.size], short)
    assert not np.any(got[full.size + short.size :])  # zero padding
    with pytest.raises(hw_pluto.PlutoError, match="exceeds the TX buffer"):
        tx.push(np.zeros(2 * num_iq + 2, dtype=np.int16))
    tx.close()


def _radio_run(pkg: str, radio: str, lib_path: str, fixtures_dir,
               seconds: float, **kw) -> int:
    """A run into a mock radio through the sink's own library binding
    (the path ``-r hackrf``/``-r plutosdr`` takes); returns the blocks
    written."""
    if pkg == "port":
        cfg_cls, sink_mod, run = SimConfig, sinks, run_simulation
        fmt = SampleFormat
    else:
        cfg_cls, sink_mod, run = JSimConfig, jsinks, jrun_simulation
        fmt = JSampleFormat
    pluto = radio == "plutosdr"
    cfg = cfg_cls(nav_file=f"{fixtures_dir}/brdc_test.22n",
                  duration_sec=seconds, almanac_enable=False, sink=radio,
                  tx_gain=30 if not pluto else -10,
                  sample_format=fmt.SC16 if pluto else fmt.SC08,
                  pluto_gain_boost=pluto, **kw)
    sink = sink_mod.make_sink(radio, lib_path=lib_path)
    return run(cfg, sink=sink).blocks


@pytest.mark.parametrize("radio,seconds", [("hackrf", 0.5),
                                           ("plutosdr", 0.4)])
def test_radio_autobind_end_to_end_equal_jax(tmp_path_factory, fixtures_dir,
                                             radio, seconds):
    """scenario → the port's batched path (``cuda`` on the CPU, an
    interactive run's window) → the sink binding the mock library by
    itself: the mock receives the JAX package's bytes (its native host
    path), whole HackRF transfers only, and tears down once."""
    name = "mock_hackrf" if radio == "hackrf" else "mock_iio"
    caps = []
    for pkg, kw in (("port", dict(backend=SynthBackend.CUDA, device="cpu",
                                   interactive=True)),
                    ("jax", dict(backend=JSynthBackend.NATIVE))):
        path = _build_mock(tmp_path_factory, name)  # fresh global state
        blocks = _radio_run(pkg, radio, path, fixtures_dir, seconds, **kw)
        mock = _mock(path)
        bytes_per_block = 600_000 * (2 if radio == "plutosdr" else 1)
        want = blocks * bytes_per_block
        if radio == "hackrf":
            want = want // hw_hackrf.TRANSFER_SIZE * hw_hackrf.TRANSFER_SIZE
        assert mock.mock_captured_bytes() == want
        assert mock.mock_teardown_ok() == 1
        caps.append(_capture(mock, want))
    assert caps[0].size and np.array_equal(caps[0], caps[1])
