"""libiio ADALM-Pluto TX backend via ctypes (reference sdr_pluto.c).

Import-guarded like hw_hackrf: :func:`iio_available` is False without
libiio and the framework keeps the pluggable ``PlutoSink(device=...)``
callable. With libiio present, :class:`PlutoTx` reproduces the reference
driver: context creation (network hostname → URI → default → pluto.local
fallback, sdr_pluto.c:140-156), AD9361 phy setup — rf_port_select A,
rf_bandwidth, sampling_frequency, clamped hardwaregain, RX LO powerdown,
ppb-corrected TX LO (sdr_pluto.c:181-196) — cf-ad9361-dds-core-lpc TX
channel enables, an NUM_IQ_SAMPLES blocking buffer, and whole-block
pushes (sdr_pluto.c:45-94, 246-277).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

TX_FREQUENCY = 1_575_420_000
TX_SAMPLERATE = 3_000_000
TX_BW = TX_SAMPLERATE * 2
PLUTO_TX_GAIN_MIN, PLUTO_TX_GAIN_MAX = -80, 0
NUM_IQ_SAMPLES = TX_SAMPLERATE // 10


def _bind(lib):
    c = ctypes
    lib.iio_create_default_context.restype = c.c_void_p
    lib.iio_create_network_context.restype = c.c_void_p
    lib.iio_create_network_context.argtypes = [c.c_char_p]
    lib.iio_create_context_from_uri.restype = c.c_void_p
    lib.iio_create_context_from_uri.argtypes = [c.c_char_p]
    lib.iio_context_destroy.argtypes = [c.c_void_p]
    lib.iio_context_get_devices_count.restype = c.c_uint
    lib.iio_context_get_devices_count.argtypes = [c.c_void_p]
    lib.iio_context_find_device.restype = c.c_void_p
    lib.iio_context_find_device.argtypes = [c.c_void_p, c.c_char_p]
    lib.iio_device_set_kernel_buffers_count.restype = c.c_int
    lib.iio_device_set_kernel_buffers_count.argtypes = [c.c_void_p, c.c_uint]
    lib.iio_device_find_channel.restype = c.c_void_p
    lib.iio_device_find_channel.argtypes = [c.c_void_p, c.c_char_p, c.c_bool]
    lib.iio_channel_attr_write.restype = c.c_ssize_t
    lib.iio_channel_attr_write.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
    lib.iio_channel_attr_write_longlong.restype = c.c_int
    lib.iio_channel_attr_write_longlong.argtypes = [
        c.c_void_p, c.c_char_p, c.c_longlong,
    ]
    lib.iio_channel_attr_write_double.restype = c.c_int
    lib.iio_channel_attr_write_double.argtypes = [
        c.c_void_p, c.c_char_p, c.c_double,
    ]
    lib.iio_channel_attr_write_bool.restype = c.c_int
    lib.iio_channel_attr_write_bool.argtypes = [
        c.c_void_p, c.c_char_p, c.c_bool,
    ]
    lib.iio_channel_enable.argtypes = [c.c_void_p]
    lib.iio_device_create_buffer.restype = c.c_void_p
    lib.iio_device_create_buffer.argtypes = [c.c_void_p, c.c_size_t, c.c_bool]
    lib.iio_buffer_set_blocking_mode.restype = c.c_int
    lib.iio_buffer_set_blocking_mode.argtypes = [c.c_void_p, c.c_bool]
    lib.iio_buffer_start.restype = c.c_void_p
    lib.iio_buffer_start.argtypes = [c.c_void_p]
    lib.iio_buffer_end.restype = c.c_void_p
    lib.iio_buffer_end.argtypes = [c.c_void_p]
    lib.iio_buffer_push.restype = c.c_ssize_t
    lib.iio_buffer_push.argtypes = [c.c_void_p]
    lib.iio_buffer_destroy.argtypes = [c.c_void_p]
    return lib


def _find_lib(path: str | None = None):
    name = path or ctypes.util.find_library("iio")
    if name is None:
        return None
    try:
        return _bind(ctypes.CDLL(name))
    except (OSError, AttributeError):
        return None


def iio_available(path: str | None = None) -> bool:
    return _find_lib(path) is not None


class PlutoError(RuntimeError):
    pass


class PlutoTx:
    """An open, configured Pluto TX session.

    ``push(int16[2*NUM_IQ_SAMPLES])`` is the callable the PlutoSink
    expects: one whole 0.1 s block per iio_buffer_push (sdr_pluto.c:45-94).
    """

    def __init__(self, tx_gain: int = 0, ppb: int = 0,
                 hostname: str | None = None, uri: str | None = None,
                 lib_path: str | None = None,
                 sample_rate: int = TX_SAMPLERATE):
        lib = _find_lib(lib_path)
        if lib is None:
            raise PlutoError("libiio not found")
        self._lib = lib
        # One 0.1 s block per push; buffer sized from the STREAM's rate
        # (the reference is hard-wired to 3 Msps, sdr.h:21/26 — the
        # framework generalizes sample rate, so the device must follow).
        self._num_iq = int(sample_rate) // 10
        # Context creation order (sdr_pluto.c:140-156).
        if hostname:
            ctx = lib.iio_create_network_context(hostname.encode())
        elif uri:
            ctx = lib.iio_create_context_from_uri(uri.encode())
        else:
            ctx = lib.iio_create_default_context()
            if not ctx:
                ctx = lib.iio_create_network_context(b"pluto.local")
        if not ctx:
            raise PlutoError("failed creating IIO context")
        self._ctx = ctx
        if lib.iio_context_get_devices_count(ctx) == 0:
            lib.iio_context_destroy(ctx)
            raise PlutoError("no supported PLUTOSDR devices found")
        tx = lib.iio_context_find_device(ctx, b"cf-ad9361-dds-core-lpc")
        if not tx:
            lib.iio_context_destroy(ctx)
            raise PlutoError("PLUTOSDR TX device not found")
        lib.iio_device_set_kernel_buffers_count(tx, 8)

        self.tx_gain = max(PLUTO_TX_GAIN_MIN, min(PLUTO_TX_GAIN_MAX, tx_gain))
        freq = TX_FREQUENCY * (10_000_000 - ppb) // 10_000_000

        phy = lib.iio_context_find_device(ctx, b"ad9361-phy")
        if not phy:
            lib.iio_context_destroy(ctx)
            raise PlutoError("ad9361-phy not found")
        self._phy = phy
        chn = lib.iio_device_find_channel(phy, b"voltage0", True)
        lib.iio_channel_attr_write(chn, b"rf_port_select", b"A")
        lib.iio_channel_attr_write_longlong(
            chn, b"rf_bandwidth", 2 * int(sample_rate)
        )
        lib.iio_channel_attr_write_longlong(
            chn, b"sampling_frequency", int(sample_rate)
        )
        lib.iio_channel_attr_write_double(
            chn, b"hardwaregain", float(self.tx_gain)
        )
        lib.iio_channel_attr_write_bool(
            lib.iio_device_find_channel(phy, b"altvoltage0", True),
            b"powerdown", True,  # RX LO off
        )
        self._lo = lib.iio_device_find_channel(phy, b"altvoltage1", True)
        lib.iio_channel_attr_write_longlong(self._lo, b"frequency", freq)

        tx0_i = lib.iio_device_find_channel(tx, b"voltage0", True)
        if not tx0_i:
            tx0_i = lib.iio_device_find_channel(tx, b"altvoltage0", True)
        tx0_q = lib.iio_device_find_channel(tx, b"voltage1", True)
        if not tx0_q:
            tx0_q = lib.iio_device_find_channel(tx, b"altvoltage1", True)
        lib.iio_channel_enable(tx0_i)
        lib.iio_channel_enable(tx0_q)

        buf = lib.iio_device_create_buffer(tx, self._num_iq, False)
        if not buf:
            lib.iio_context_destroy(ctx)
            raise PlutoError("could not create TX buffer")
        lib.iio_buffer_set_blocking_mode(buf, True)
        self._buf = buf
        self.info = {"freq": freq, "gain": self.tx_gain}

    def start(self) -> None:
        """Turn the TX LO on (sdr_pluto.c:246-252)."""
        self._lib.iio_channel_attr_write_bool(self._lo, b"powerdown", False)

    def push(self, block: np.ndarray) -> None:
        """One whole 0.1 s int16 IQ block per buffer push.

        A block larger than the buffer is a contract violation (raises);
        a short final block is zero-padded — iio_buffer_push always sends
        the whole buffer, and padding with silence beats transmitting the
        previous block's stale tail."""
        lib = self._lib
        block = np.ascontiguousarray(block, dtype=np.int16)
        start = lib.iio_buffer_start(self._buf)
        end = lib.iio_buffer_end(self._buf)
        cap = end - start
        n = block.nbytes
        if n > cap:
            raise PlutoError(
                f"IQ block ({n} bytes) exceeds the TX buffer ({cap} bytes)"
            )
        ctypes.memmove(start, block.ctypes.data, n)
        if n < cap:
            ctypes.memset(start + n, 0, cap - n)
        if lib.iio_buffer_push(self._buf) < 0:
            raise PlutoError("iio_buffer_push failed")

    def set_gain(self, gain: int) -> int:
        g = max(PLUTO_TX_GAIN_MIN, min(PLUTO_TX_GAIN_MAX, gain))
        chn = self._lib.iio_device_find_channel(self._phy, b"voltage0", True)
        self._lib.iio_channel_attr_write_double(
            chn, b"hardwaregain", float(g)
        )
        self.tx_gain = g
        return g

    def close(self) -> None:
        if self._ctx:
            self._lib.iio_channel_attr_write_bool(
                self._lo, b"powerdown", True
            )
            self._lib.iio_buffer_destroy(self._buf)
            self._lib.iio_context_destroy(self._ctx)
            self._ctx = None
