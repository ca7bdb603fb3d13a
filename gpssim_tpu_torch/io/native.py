"""ctypes binding for the native host runtime (native/gpssim_native.cc).

Provides the C++ ring-FIFO-backed streaming IQ writer and the vectorized
int16→int8 quantizer. The library is built on demand with g++ (see
tools/build_native.sh); ``available()`` reports whether it can be used so
callers fall back to the pure-Python sink gracefully.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# GPSSIM_NATIVE_LIB points an installed (non-repo-layout) deployment at a
# prebuilt library; the repo layout self-builds on first use.
_LIB_OVERRIDE = os.environ.get("GPSSIM_NATIVE_LIB")
_LIB_PATH = _LIB_OVERRIDE or os.path.join(
    _ROOT, "native", "libgpssim_native.so"
)
_BUILD = os.path.join(_ROOT, "tools", "build_native.sh")

_lib = None
_lib_lock = threading.Lock()
_load_error: str | None = None


def _load():
    global _lib, _load_error
    with _lib_lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH) and not _LIB_OVERRIDE:
                # Self-build only in the repo layout; an explicit
                # override either exists or fails loudly below.
                subprocess.run(
                    ["sh", _BUILD], check=True, capture_output=True, text=True
                )
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.CalledProcessError) as e:
            _load_error = str(e)
            return None

        lib.gwriter_open.restype = ctypes.c_void_p
        lib.gwriter_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
        ]
        lib.gwriter_write.restype = ctypes.c_int
        lib.gwriter_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.gwriter_depth_used.restype = ctypes.c_int
        lib.gwriter_depth_used.argtypes = [ctypes.c_void_p]
        lib.gwriter_bytes_written.restype = ctypes.c_longlong
        lib.gwriter_bytes_written.argtypes = [ctypes.c_void_p]
        lib.gwriter_close.restype = ctypes.c_int
        lib.gwriter_close.argtypes = [ctypes.c_void_p]
        lib.gquantize_16to8.restype = None
        lib.gquantize_16to8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.gstream_open.restype = ctypes.c_void_p
        lib.gstream_open.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_long,
            ctypes.c_double, ctypes.c_double,
        ]
        lib.gstream_write.restype = ctypes.c_int
        lib.gstream_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.gstream_depth_used.restype = ctypes.c_int
        lib.gstream_depth_used.argtypes = [ctypes.c_void_p]
        lib.gstream_bytes_sent.restype = ctypes.c_longlong
        lib.gstream_bytes_sent.argtypes = [ctypes.c_void_p]
        lib.gstream_underruns.restype = ctypes.c_long
        lib.gstream_underruns.argtypes = [ctypes.c_void_p]
        lib.gstream_started.restype = ctypes.c_int
        lib.gstream_started.argtypes = [ctypes.c_void_p]
        lib.gstream_finish.restype = ctypes.c_int
        lib.gstream_finish.argtypes = [ctypes.c_void_p, ctypes.c_double]
        if hasattr(lib, "gstream_halt"):  # stale .so tolerance
            lib.gstream_halt.restype = ctypes.c_int
            lib.gstream_halt.argtypes = [ctypes.c_void_p]
        lib.gstream_close.restype = ctypes.c_int
        lib.gstream_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    _load()
    return _load_error


def quantize_16to8(iq16: np.ndarray) -> np.ndarray:
    """int16 accumulators → int8 via arithmetic >>4 (gps.c:2841-2845)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_load_error}")
    src = np.ascontiguousarray(iq16, dtype=np.int16)
    out = np.empty(src.shape, dtype=np.int8)
    lib.gquantize_16to8(
        src.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        src.size,
    )
    return out


class NativeIqWriter:
    """Streaming file writer over the C++ ring FIFO + drain thread.

    write() copies into preallocated native buffers and blocks only when
    the ring is full — the pipeline's real-time backpressure — while disk
    I/O runs on the native thread (reference sdr_iqfile.c:22-77)."""

    def __init__(self, path: str, fifo_depth: int = 8,
                 block_bytes: int = 1_200_000):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_load_error}")
        self._lib = lib
        self._h = lib.gwriter_open(
            path.encode(), int(fifo_depth), int(block_bytes)
        )
        if not self._h:
            raise OSError(f"cannot open {path!r} for writing")

    def write(self, block: np.ndarray) -> None:
        buf = np.ascontiguousarray(block)
        ok = self._lib.gwriter_write(
            self._h, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes
        )
        if not ok:
            raise OSError("native writer failed (I/O error or halted)")

    @property
    def depth_used(self) -> int:
        return self._lib.gwriter_depth_used(self._h)

    @property
    def bytes_written(self) -> int:
        return self._lib.gwriter_bytes_written(self._h)

    def close(self) -> int:
        if self._h:
            rc = self._lib.gwriter_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"native writer close failed (rc={rc})")
        return 0


class NativeStreamer:
    """Realtime TX streamer over a file descriptor (socket/pipe).

    The native drain thread implements the reference's TX contract: the
    start-full FIFO barrier (fifo.c:97-103, sdr_iqfile.c:74), pacing at
    the DAC byte rate, and underrun accounting (see Streamer in
    native/gpssim_native.cc). ``fd`` is borrowed — the caller keeps the
    socket object alive and closes it after ``close()``."""

    def __init__(self, fd: int, fifo_depth: int = 8,
                 block_bytes: int = 1_200_000, bytes_per_sec: float = 0.0,
                 start_timeout_s: float = 30.0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_load_error}")
        self._lib = lib
        self._h = lib.gstream_open(
            int(fd), int(fifo_depth), int(block_bytes),
            float(bytes_per_sec), float(start_timeout_s),
        )
        if not self._h:
            raise OSError("cannot start native streamer")

    def write(self, block: np.ndarray) -> None:
        buf = np.ascontiguousarray(block)
        ok = self._lib.gstream_write(
            self._h, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes
        )
        if not ok:
            raise OSError("native streamer failed (peer closed or halted)")

    @property
    def depth_used(self) -> int:
        return self._lib.gstream_depth_used(self._h)

    @property
    def bytes_sent(self) -> int:
        return self._lib.gstream_bytes_sent(self._h)

    @property
    def underruns(self) -> int:
        return self._lib.gstream_underruns(self._h)

    @property
    def started(self) -> bool:
        return bool(self._lib.gstream_started(self._h))

    def halt(self) -> None:
        """Mark end-of-stream WITHOUT waiting for the flush: the paced
        drain keeps sending queued blocks but a drained-out tail no
        longer counts as underruns (the stream is complete). Multi-sink
        producers call this on every sink before the blocking closes."""
        if self._h and hasattr(self._lib, "gstream_halt"):
            self._lib.gstream_halt(self._h)

    def close(self, flush_timeout_s: float = 10.0) -> int:
        if self._h:
            # Flush first (paced drain of queued blocks, bounded — a
            # stalled peer is abandoned past the deadline), snapshot the
            # final stats, then free the native handle.
            rc = self._lib.gstream_finish(self._h, float(flush_timeout_s))
            self.final_bytes_sent = self._lib.gstream_bytes_sent(self._h)
            self.final_underruns = self._lib.gstream_underruns(self._h)
            self.final_started = bool(self._lib.gstream_started(self._h))
            self._lib.gstream_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"native streamer close failed (rc={rc})")
        return 0
