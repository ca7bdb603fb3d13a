"""libhackrf TX backend via ctypes (reference sdr_hackrf.c contract).

Import-guarded: :func:`hackrf_available` is False when the shared library
is absent and the rest of the framework falls back to the pluggable
``HackRfSink(device=...)`` callable. When libhackrf IS present,
:class:`HackRfTx` reproduces the reference driver's sequence —
init → device list → open index 0 → board-info reads
(sdr_hackrf.c:56-132), ppb-corrected LO, sample rate, baseband filter,
amp + clamped TXVGA gain (sdr_hackrf.c:136-215), the pull-based
``hackrf_start_tx`` callback fed from a bounded FIFO with the start-full
barrier (sdr_hackrf.c:236-265), and the stop/amp-off/gain-0 teardown
(sdr_hackrf.c:225-234).

The ABI subset is bound explicitly so the contract is testable against a
mock shared library (tests/test_torch_radios.py).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

from .fifo import BlockFifo

TX_FREQUENCY = 1_575_420_000
TX_SAMPLERATE = 3_000_000
TX_BW = TX_SAMPLERATE * 2
TX_IF_GAIN_MIN, TX_IF_GAIN_MAX = 0, 47
TRANSFER_SIZE = 262_144  # bytes per USB transfer (HACKRF_TRANSFER_BUFFER_SIZE)
NUM_FIFO_BUFFERS = 32


class _hackrf_transfer(ctypes.Structure):
    _fields_ = [
        ("device", ctypes.c_void_p),
        ("buffer", ctypes.POINTER(ctypes.c_uint8)),
        ("buffer_length", ctypes.c_int),
        ("valid_length", ctypes.c_int),
        ("rx_ctx", ctypes.c_void_p),
        ("tx_ctx", ctypes.c_void_p),
    ]


class _hackrf_device_list(ctypes.Structure):
    _fields_ = [
        ("serial_numbers", ctypes.POINTER(ctypes.c_char_p)),
        ("usb_board_ids", ctypes.POINTER(ctypes.c_int)),
        ("usb_device_index", ctypes.POINTER(ctypes.c_int)),
        ("devicecount", ctypes.c_int),
        ("usb_devices", ctypes.POINTER(ctypes.c_void_p)),
        ("usb_devicecount", ctypes.c_int),
    ]


_TX_CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(_hackrf_transfer))


def _bind(lib):
    P = ctypes.POINTER
    lib.hackrf_init.restype = ctypes.c_int
    lib.hackrf_exit.restype = ctypes.c_int
    lib.hackrf_device_list.restype = P(_hackrf_device_list)
    lib.hackrf_device_list_open.restype = ctypes.c_int
    lib.hackrf_device_list_open.argtypes = [
        P(_hackrf_device_list), ctypes.c_int, P(ctypes.c_void_p),
    ]
    lib.hackrf_device_list_free.argtypes = [P(_hackrf_device_list)]
    lib.hackrf_board_id_read.restype = ctypes.c_int
    lib.hackrf_board_id_read.argtypes = [ctypes.c_void_p, P(ctypes.c_uint8)]
    lib.hackrf_version_string_read.restype = ctypes.c_int
    lib.hackrf_version_string_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint8,
    ]
    lib.hackrf_set_antenna_enable.restype = ctypes.c_int
    lib.hackrf_set_antenna_enable.argtypes = [ctypes.c_void_p, ctypes.c_uint8]
    lib.hackrf_set_sample_rate.restype = ctypes.c_int
    lib.hackrf_set_sample_rate.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.hackrf_compute_baseband_filter_bw.restype = ctypes.c_uint32
    lib.hackrf_compute_baseband_filter_bw.argtypes = [ctypes.c_uint32]
    lib.hackrf_set_baseband_filter_bandwidth.restype = ctypes.c_int
    lib.hackrf_set_baseband_filter_bandwidth.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.hackrf_set_freq.restype = ctypes.c_int
    lib.hackrf_set_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.hackrf_set_amp_enable.restype = ctypes.c_int
    lib.hackrf_set_amp_enable.argtypes = [ctypes.c_void_p, ctypes.c_uint8]
    lib.hackrf_set_txvga_gain.restype = ctypes.c_int
    lib.hackrf_set_txvga_gain.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.hackrf_set_hw_sync_mode.restype = ctypes.c_int
    lib.hackrf_set_hw_sync_mode.argtypes = [ctypes.c_void_p, ctypes.c_uint8]
    lib.hackrf_start_tx.restype = ctypes.c_int
    lib.hackrf_start_tx.argtypes = [
        ctypes.c_void_p, _TX_CALLBACK, ctypes.c_void_p,
    ]
    lib.hackrf_stop_tx.restype = ctypes.c_int
    lib.hackrf_stop_tx.argtypes = [ctypes.c_void_p]
    lib.hackrf_close.restype = ctypes.c_int
    lib.hackrf_close.argtypes = [ctypes.c_void_p]
    return lib


def _find_lib(path: str | None = None):
    name = path or ctypes.util.find_library("hackrf")
    if name is None:
        return None
    try:
        return _bind(ctypes.CDLL(name))
    except (OSError, AttributeError):
        return None


def hackrf_available(path: str | None = None) -> bool:
    return _find_lib(path) is not None


class HackRfError(RuntimeError):
    pass


def _ck(result: int, what: str) -> None:
    if result != 0:  # HACKRF_SUCCESS
        raise HackRfError(f"{what} failed ({result})")


class HackRfTx:
    """An open, configured HackRF TX session.

    ``push(int8[TRANSFER_SIZE])`` is the callable the repacking
    ``HackRfSink`` expects; the libusb callback pulls transfers from the
    bounded FIFO exactly like the reference's sdr_tx_callback
    (sdr_hackrf.c:236-250).
    """

    def __init__(self, tx_gain: int = 0, amp: bool = False, ppb: int = 0,
                 lib_path: str | None = None,
                 fifo_depth: int = NUM_FIFO_BUFFERS,
                 sample_rate: int = TX_SAMPLERATE):
        lib = _find_lib(lib_path)
        if lib is None:
            raise HackRfError("libhackrf not found")
        self._lib = lib
        self.info: dict = {}
        _ck(lib.hackrf_init(), "hackrf_init")
        lst = lib.hackrf_device_list()
        if not lst or lst.contents.devicecount < 1:
            lib.hackrf_exit()
            raise HackRfError("no HackRF boards found")
        self.info["devicecount"] = lst.contents.devicecount
        if lst.contents.serial_numbers and lst.contents.serial_numbers[0]:
            self.info["serial"] = lst.contents.serial_numbers[0].decode()
        dev = ctypes.c_void_p()
        _ck(lib.hackrf_device_list_open(lst, 0, ctypes.byref(dev)),
            "hackrf_device_list_open")
        self._dev = dev
        self._list = lst
        board_id = ctypes.c_uint8(0)
        _ck(lib.hackrf_board_id_read(dev, ctypes.byref(board_id)),
            "hackrf_board_id_read")
        self.info["board_id"] = board_id.value
        ver = ctypes.create_string_buffer(256)
        _ck(lib.hackrf_version_string_read(dev, ver, 255),
            "hackrf_version_string_read")
        self.info["version"] = ver.value.decode()

        # ppb LO correction with the reference's integer arithmetic
        # (sdr_hackrf.c:136-138).  The device rate must follow the
        # generated stream's rate (the reference is hard-wired to
        # TX_SAMPLERATE, sdr.h:21; the framework generalizes it), else
        # the signal plays at the wrong speed.
        freq = TX_FREQUENCY * (10_000_000 - ppb) // 10_000_000
        bw = lib.hackrf_compute_baseband_filter_bw(2 * int(sample_rate))
        _ck(lib.hackrf_set_antenna_enable(dev, 0), "set_antenna_enable")
        _ck(lib.hackrf_set_sample_rate(dev, float(sample_rate)),
            "set_sample_rate")
        _ck(lib.hackrf_set_baseband_filter_bandwidth(dev, bw),
            "set_baseband_filter_bandwidth")
        _ck(lib.hackrf_set_freq(dev, freq), "set_freq")
        _ck(lib.hackrf_set_amp_enable(dev, 1 if amp else 0),
            "set_amp_enable")
        self.tx_gain = max(TX_IF_GAIN_MIN, min(TX_IF_GAIN_MAX, tx_gain))
        _ck(lib.hackrf_set_txvga_gain(dev, self.tx_gain), "set_txvga_gain")
        _ck(lib.hackrf_set_hw_sync_mode(dev, 0), "set_hw_sync_mode")
        self.info["freq"] = freq
        self.info["filter_bw"] = int(bw)

        self.fifo = BlockFifo(fifo_depth)
        self._started = False
        self._start_requested = False
        self._started_evt = threading.Event()
        # Serializes start-vs-close: hackrf_start_tx must never race the
        # teardown freeing the device handle.
        self._state_lock = threading.Lock()
        self._cb = _TX_CALLBACK(self._tx_callback)  # keep a reference!

    # -- the pull side (libusb thread) ----------------------------------
    def _tx_callback(self, transfer) -> int:
        t = transfer.contents
        # Block until a transfer is ready, exactly like the reference's
        # fifo_dequeue (fifo.c:174-194, no timeout): a producer stall (a
        # kernel build, a checkpoint write) must starve the radio briefly, not
        # end the stream.  dequeue() returns None only on fifo.halt() —
        # the close() teardown path — which IS end-of-stream.
        block = self.fifo.dequeue()
        if block is None:
            return -1  # stream ends (reference sdr_tx_callback NULL path)
        n = min(t.valid_length, len(block))
        ctypes.memmove(t.buffer, block.ctypes.data, n)
        return 0

    # -- the push side (the HackRfSink device callable) -----------------
    def push(self, transfer_block: np.ndarray) -> None:
        if not self.fifo.enqueue(
            np.ascontiguousarray(transfer_block, dtype=np.int8)
        ):
            raise HackRfError("TX fifo halted")

    def start(self, timeout_s: float = 30.0) -> None:
        """Start transmission AFTER the FIFO pre-buffer fills (the
        reference's fifo_wait_full barrier, sdr_hackrf.c:258) — or after
        close() releases the barrier for a short stream."""
        self._start_requested = True
        self.fifo.wait_full(timeout=timeout_s)
        with self._state_lock:
            if self._dev is None:
                return  # closed before the barrier released
            _ck(self._lib.hackrf_start_tx(self._dev, self._cb, None),
                "hackrf_start_tx")
            self._started = True
            self._started_evt.set()

    def set_gain(self, gain: int) -> int:
        g = max(TX_IF_GAIN_MIN, min(TX_IF_GAIN_MAX, gain))
        _ck(self._lib.hackrf_set_txvga_gain(self._dev, g), "set_txvga_gain")
        self.tx_gain = g
        return g

    def close(self, flush_timeout_s: float = 10.0) -> None:
        """Flush queued transfers, then teardown per sdr_hackrf_close
        (sdr_hackrf.c:225-234). A short stream that never filled the
        pre-buffer still transmits: the barrier is force-released."""
        import time

        if self._dev is None:
            return
        if self._start_requested:
            self.fifo.force_barrier()
            self._started_evt.wait(timeout=5.0)
            deadline = time.time() + flush_timeout_s
            while (
                self._started
                and self.fifo.depth_used
                and time.time() < deadline
            ):
                time.sleep(0.01)
        self.fifo.halt()
        with self._state_lock:
            if self._dev is None:
                return
            lib = self._lib
            if self._started:
                lib.hackrf_stop_tx(self._dev)
            lib.hackrf_set_amp_enable(self._dev, 0)
            lib.hackrf_set_txvga_gain(self._dev, 0)
            lib.hackrf_close(self._dev)
            lib.hackrf_device_list_free(self._list)
            lib.hackrf_exit()
            self._dev = None
