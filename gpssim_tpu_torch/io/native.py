"""ctypes bindings for the port's native host code.

Four libraries. The shared host runtime (native/gpssim_native.cc, built
by tools/build_native.sh) gives the full sequential synthesizer of the
native backend (``ops/synth_seq.synth_block_seq_native``) and the
vectorized int16→int8 quantizer. The port's own sequential engine
(``ops/seq.cc``) gives the strict-parity corrections and the planner's
carrier chain. The port's own collation engine (``ops/collate.cc``)
turns a window of block plans into the packed kernel arguments
(``ops/args.collate_plans``). The port's own sink runtime (``io/fifo.cc``)
gives the ring-FIFO-backed streaming IQ writer and the paced streamer,
whose FIFOs count their producer's waits and copies, their depth and the
blocks lent to them. The port's three are built on demand with g++ into
``build/native/`` under a name that hashes the source and the flags, so a
library built from an older source never loads. ``available()`` reports
whether the sink runtime can be used, so callers fall back to the
pure-Python sink gracefully; the collation engine has no fallback, and a
failed build raises.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
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
_FIFO_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fifo.cc")
_FIFO_DIR = os.path.join(_ROOT, "build", "native")
_OPS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops")
_SEQ_SRC = os.path.join(_OPS_DIR, "seq.cc")
_COLLATE_SRC = os.path.join(_OPS_DIR, "collate.cc")
_FIFO_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")
# -ffp-contract=off: the sequential replay must perform exactly the
# IEEE-754 mul+add sequence of the reference C, and the collation NumPy's
# (no FMA contraction, which would change the rounding).
_SEQ_FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
              "-pthread")

#: the FIFO counters of ``gwriter_stats`` / ``gstream_stats``, in the order
#: of ``enum Stat`` in io/fifo.cc
FIFO_STATS = ("acquire_wait_ns", "copy_ns", "depth_sum", "dequeued",
              "lent", "lent_done")

_lib = None
_lib_lock = threading.Lock()
_load_error: str | None = None
_fifo = None
_fifo_error: str | None = None
_seq = None
_seq_error: str | None = None
_collate = None


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

        lib.gquantize_16to8.restype = None
        lib.gquantize_16to8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ]
        _lib = lib
        return _lib


def _lib_path(src: str, stem: str, flags: tuple) -> str:
    """Where the library built from ``src`` with ``flags`` goes: its name
    hashes both."""
    with open(src, "rb") as fp:
        h = hashlib.sha256(fp.read())
    h.update(" ".join(flags).encode())
    return os.path.join(_FIFO_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _build(src: str, stem: str, flags: tuple) -> str:
    out = _lib_path(src, stem, flags)
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"  # renamed over: never half-written
        subprocess.run(["g++", *flags, "-o", tmp, src], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    return out


def fifo_lib_path() -> str:
    """Where the sink runtime built from ``io/fifo.cc`` goes."""
    return _lib_path(_FIFO_SRC, "fifo", _FIFO_FLAGS)


def _build_fifo() -> str:
    return _build(_FIFO_SRC, "fifo", _FIFO_FLAGS)


def _load_seq():
    """The port's sequential engine (``ops/seq.cc``), or None."""
    global _seq, _seq_error
    with _lib_lock:
        if _seq is not None or _seq_error is not None:
            return _seq
        try:
            _seq = ctypes.CDLL(_build(_SEQ_SRC, "seq", _SEQ_FLAGS))
        except subprocess.CalledProcessError as e:
            _seq_error = f"{e}: {e.stderr[-2000:]}"
        except OSError as e:
            _seq_error = str(e)
        return _seq


def load_collate():
    """The port's collation engine (``ops/collate.cc``), built with g++ at
    first use. A missing compiler or a failed build raises."""
    global _collate
    with _lib_lock:
        if _collate is None:
            try:
                path = _build(_COLLATE_SRC, "collate", _SEQ_FLAGS)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    f"g++ failed on ops/collate.cc: {e.stderr[-2000:]}"
                ) from e
            _collate = ctypes.CDLL(path)
        return _collate


def _load_fifo():
    global _fifo, _fifo_error
    with _lib_lock:
        if _fifo is not None or _fifo_error is not None:
            return _fifo
        try:
            lib = ctypes.CDLL(_build_fifo())
        except subprocess.CalledProcessError as e:
            _fifo_error = f"{e}: {e.stderr[-2000:]}"
            return None
        except OSError as e:
            _fifo_error = str(e)
            return None

        handle = [ctypes.c_void_p]
        stats = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
        lib.gwriter_open.restype = ctypes.c_void_p
        lib.gwriter_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
        ]
        lib.gwriter_write.restype = ctypes.c_int
        lib.gwriter_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ]
        lend = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib.gwriter_lend.restype = ctypes.c_longlong
        lib.gwriter_lend.argtypes = lend
        lib.gwriter_depth_used.restype = ctypes.c_int
        lib.gwriter_depth_used.argtypes = handle
        lib.gwriter_bytes_written.restype = ctypes.c_longlong
        lib.gwriter_bytes_written.argtypes = handle
        lib.gwriter_stats.restype = None
        lib.gwriter_stats.argtypes = stats
        lib.gwriter_finish.restype = ctypes.c_int
        lib.gwriter_finish.argtypes = handle
        lib.gwriter_close.restype = ctypes.c_int
        lib.gwriter_close.argtypes = handle
        lib.gstream_open.restype = ctypes.c_void_p
        lib.gstream_open.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_long,
            ctypes.c_double, ctypes.c_double,
        ]
        lib.gstream_write.restype = ctypes.c_int
        lib.gstream_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.gstream_lend.restype = ctypes.c_longlong
        lib.gstream_lend.argtypes = lend
        lib.gstream_depth_used.restype = ctypes.c_int
        lib.gstream_depth_used.argtypes = handle
        lib.gstream_bytes_sent.restype = ctypes.c_longlong
        lib.gstream_bytes_sent.argtypes = handle
        lib.gstream_underruns.restype = ctypes.c_long
        lib.gstream_underruns.argtypes = handle
        lib.gstream_started.restype = ctypes.c_int
        lib.gstream_started.argtypes = handle
        lib.gstream_stats.restype = None
        lib.gstream_stats.argtypes = stats
        lib.gstream_finish.restype = ctypes.c_int
        lib.gstream_finish.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.gstream_halt.restype = ctypes.c_int
        lib.gstream_halt.argtypes = handle
        lib.gstream_close.restype = ctypes.c_int
        lib.gstream_close.argtypes = handle
        _fifo = lib
        return _fifo


def available() -> bool:
    """Whether the sink runtime (the native writer and streamer) loads."""
    return _load_fifo() is not None


def load_error() -> str | None:
    _load_fifo()
    return _fifo_error


def _fifo_stats(fn, handle, **extra) -> dict:
    """``fn``'s counters of ``handle`` as a dict keyed by FIFO_STATS."""
    out = (ctypes.c_longlong * len(FIFO_STATS))()
    fn(handle, out)
    return {**dict(zip(FIFO_STATS, out)), **extra}


class _Lender:
    """The blocks lent to a native FIFO, held until its drain is done.

    A block is lent, queued by pointer with no copy, if it is a
    C-contiguous ndarray whose ``flags.writeable`` is false: its caller
    has given it up. Any other block is copied into the ring. A lent block
    is held here until the count of lent blocks the drain has finished
    with, which each lend returns, includes it (the drain is FIFO), or
    until the drain thread has been joined (:meth:`joined`)."""

    def __init__(self, copy_fn, lend_fn, failure: str):
        self._copy = copy_fn
        self._lend = lend_fn
        self._failure = failure
        self._held: collections.deque = collections.deque()
        self._released = 0

    def write(self, h, block) -> None:
        if (isinstance(block, np.ndarray) and block.flags.c_contiguous
                and not block.flags.writeable):
            # held before the call: a lend that fails part-way may have
            # queued some of the block
            self._held.append(block)
            done = self._lend(h, block.ctypes.data, block.nbytes)
            if done < 0:
                raise OSError(self._failure)
            while self._released < done:
                self._held.popleft()
                self._released += 1
            return
        buf = np.ascontiguousarray(block)
        if not self._copy(h, buf.ctypes.data_as(ctypes.c_void_p),
                          buf.nbytes):
            raise OSError(self._failure)

    def joined(self) -> None:
        """The drain thread is joined: no lent block is read any more."""
        self._held.clear()

    def __len__(self) -> int:
        return len(self._held)


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

    write() lends a read-only contiguous block to the FIFO and copies any
    other into preallocated native buffers (:class:`_Lender`); it blocks
    only when the ring is full — the pipeline's real-time backpressure —
    while disk I/O runs on the native thread (reference
    sdr_iqfile.c:22-77)."""

    def __init__(self, path: str, fifo_depth: int = 8,
                 block_bytes: int = 1_200_000):
        lib = _load_fifo()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_fifo_error}")
        self._lib = lib
        self._lender = _Lender(lib.gwriter_write, lib.gwriter_lend,
                               "native writer failed (I/O error or halted)")
        self._h = lib.gwriter_open(
            path.encode(), int(fifo_depth), int(block_bytes)
        )
        if not self._h:
            raise OSError(f"cannot open {path!r} for writing")

    #: the FIFO's counters and the bytes written (FIFO_STATS, ``bytes``)
    #: after close(), once the drain has finished
    final_stats: dict | None = None

    def write(self, block: np.ndarray) -> None:
        self._lender.write(self._h, block)

    @property
    def depth_used(self) -> int:
        return self._lib.gwriter_depth_used(self._h)

    @property
    def bytes_written(self) -> int:
        return self._lib.gwriter_bytes_written(self._h)

    def close(self) -> int:
        if self._h:
            # Flush first, so the counters are final.
            rc = self._lib.gwriter_finish(self._h)
            self._lender.joined()
            self.final_stats = _fifo_stats(
                self._lib.gwriter_stats, self._h,
                bytes=self._lib.gwriter_bytes_written(self._h))
            rc_close = self._lib.gwriter_close(self._h)
            rc = rc or rc_close
            self._h = None
            if rc != 0:
                raise OSError(f"native writer close failed (rc={rc})")
        return 0

    def __del__(self):
        # Never drop a lent block that the drain thread may still read.
        if getattr(self, "_h", None) and len(self._lender):
            self._lib.gwriter_finish(self._h)


class NativeStreamer:
    """Realtime TX streamer over a file descriptor (socket/pipe).

    The native drain thread implements the reference's TX contract: the
    start-full FIFO barrier (fifo.c:97-103, sdr_iqfile.c:74), pacing at
    the DAC byte rate, and underrun accounting (see Streamer in
    io/fifo.cc). ``fd`` is borrowed — the caller keeps the
    socket object alive and closes it after ``close()``."""

    def __init__(self, fd: int, fifo_depth: int = 8,
                 block_bytes: int = 1_200_000, bytes_per_sec: float = 0.0,
                 start_timeout_s: float = 30.0):
        lib = _load_fifo()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_fifo_error}")
        self._lib = lib
        self._lender = _Lender(
            lib.gstream_write, lib.gstream_lend,
            "native streamer failed (peer closed or halted)")
        self._h = lib.gstream_open(
            int(fd), int(fifo_depth), int(block_bytes),
            float(bytes_per_sec), float(start_timeout_s),
        )
        if not self._h:
            raise OSError("cannot start native streamer")

    #: the FIFO's counters and the bytes sent (FIFO_STATS, ``bytes``) after
    #: close(), once the paced drain has finished
    final_stats: dict | None = None

    def write(self, block: np.ndarray) -> None:
        self._lender.write(self._h, block)

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
        if self._h:
            self._lib.gstream_halt(self._h)

    def close(self, flush_timeout_s: float = 10.0) -> int:
        if self._h:
            # Flush first (paced drain of queued blocks, bounded — a
            # stalled peer is abandoned past the deadline), snapshot the
            # final stats, then free the native handle.
            rc = self._lib.gstream_finish(self._h, float(flush_timeout_s))
            self._lender.joined()
            self.final_bytes_sent = self._lib.gstream_bytes_sent(self._h)
            self.final_underruns = self._lib.gstream_underruns(self._h)
            self.final_started = bool(self._lib.gstream_started(self._h))
            self.final_stats = _fifo_stats(self._lib.gstream_stats, self._h,
                                           bytes=self.final_bytes_sent)
            self._lib.gstream_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"native streamer close failed (rc={rc})")
        return 0

    def __del__(self):
        # Never drop a lent block that the drain thread may still read.
        if getattr(self, "_h", None) and len(self._lender):
            self._lib.gstream_finish(self._h, 10.0)
