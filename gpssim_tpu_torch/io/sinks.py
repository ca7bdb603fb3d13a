"""Output sinks: registry + IQ file writer + null + hardware stubs.

Re-design of the reference's SDR backend vtable (sdr.c:24-99): a sink
registry keyed by name, each sink exposing init/write/close/set_gain.
The iqfile sink (reference sdr_iqfile.c) is the primary one for parity and
benchmark runs; hackrf/plutosdr are interface stubs carrying the reference's
constraints (sample format forcing, gain ranges, ppb-to-LO model) so a
hardware backend can slot in without touching the pipeline.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from .fifo import BlockFifo


class Sink:
    """Base sink interface (reference sdr.h:36-39 four-call API)."""

    name = "none"
    forced_sample_bits: int | None = None
    gain_range: tuple[int, int] | None = None

    def init(self, cfg) -> None:  # noqa: D401
        pass

    def write(self, block: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def end_stream(self) -> None:
        """Mark end-of-stream without waiting for the flush (no-op for
        non-paced sinks). Paced sinks stop counting a drained-out tail
        as underruns — the stream is complete, no byte is late. A
        multi-sink producer (fleet) calls this on EVERY sink before the
        per-sink blocking closes; otherwise sink k's paced flush wait
        would turn sinks k+1..N into false underrun counters."""

    def set_gain(self, gain: int) -> int:
        return gain


class NullSink(Sink):
    """Discard output (throughput benchmarking)."""

    name = "none"

    def __init__(self):
        self.blocks = 0
        self.samples = 0

    def write(self, block: np.ndarray) -> None:
        self.blocks += 1
        self.samples += len(block) // 2


class IqFileSink(Sink):
    """Stream quantized IQ blocks to a binary file (reference sdr_iqfile.c).

    A writer thread drains a bounded FIFO so synthesis overlaps file I/O,
    mirroring the reference's producer/consumer split. With
    ``engine='native'`` (or 'auto' when the C++ runtime is built) the FIFO
    and drain thread are the native ones from native/gpssim_native.cc.
    """

    name = "iqfile"

    def __init__(self, path: str = "iqdata.bin", fifo_depth: int = 8,
                 threaded: bool = True, engine: str = "auto"):
        self.path = path
        self.fifo = BlockFifo(fifo_depth)
        self.fifo_depth = fifo_depth
        self.threaded = threaded
        self.engine = engine
        self._native = None
        self._fp = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def init(self, cfg=None) -> None:
        if self.engine in ("auto", "native"):
            from . import native

            if native.available():
                self._native = native.NativeIqWriter(
                    self.path, fifo_depth=self.fifo_depth
                )
                return
            if self.engine == "native":
                raise RuntimeError(
                    f"native runtime unavailable: {native.load_error()}"
                )
        self._fp = open(self.path, "wb")
        if self.threaded:
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()

    def _writer(self) -> None:
        try:
            while True:
                block = self.fifo.dequeue()
                if block is None:
                    return
                block.tofile(self._fp)
        except BaseException as e:  # surface the I/O error to the producer
            self._error = e
            # Unblock a producer waiting in enqueue (and stop buffering
            # blocks nobody will ever drain).
            self.fifo.halt()

    def _check_writer(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                f"iqfile writer thread failed: {self._error}"
            ) from self._error

    def write(self, block: np.ndarray) -> None:
        if self._native is not None:
            self._native.write(block)
            return
        if self._fp is None:
            self.init()
            if self._native is not None:
                self._native.write(block)
                return
        if self.threaded:
            self._check_writer()
            self.fifo.enqueue(block)
            self._check_writer()
        else:
            block.tofile(self._fp)

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
            return
        if self.threaded and self._thread is not None:
            # Let the writer drain before halting — unless it died (the
            # queue would never drain and this loop would spin forever).
            while self.fifo.depth_used and self._thread.is_alive():
                import time

                time.sleep(0.001)
            self.fifo.halt()
            self._thread.join(timeout=5)
            self._thread = None
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        self._check_writer()


class TcpSink(Sink):
    """Realtime network TX over a TCP connection (loopback or LAN).

    The streaming analog of a radio backend for rigs without an SDR: IQ
    blocks enter a bounded FIFO and a drain thread transmits them at the
    DAC byte rate, honoring the reference's TX contract — the start-full
    FIFO barrier before the first byte (fifo.c:97-103, sdr_iqfile.c:74),
    backpressure through blocking acquire, and underrun accounting (a
    block due while the FIFO is empty means the radio would have
    starved). Native engine when the C++ runtime is built; a pure-Python
    thread otherwise.
    """

    name = "tcp"

    def __init__(self, addr: str = "127.0.0.1:4729", fifo_depth: int = 8,
                 pace: bool = True, engine: str = "auto",
                 start_timeout_s: float = 30.0,
                 flush_timeout_s: float = 10.0):
        self.addr = addr
        self.fifo_depth = fifo_depth
        self.pace = pace
        self.engine = engine
        self.start_timeout_s = start_timeout_s
        self.flush_timeout_s = flush_timeout_s
        self.fifo = BlockFifo(fifo_depth)
        self._native = None
        self._sock = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._started = threading.Event()
        self._py_underruns = 0
        self._py_bytes = 0

    # -- byte rate: sample_rate * 2 values/sample * bytes/value ----------
    @staticmethod
    def _bytes_per_sec(cfg) -> float:
        if cfg is None:
            return 0.0
        return float(cfg.sample_rate) * 2.0 * (cfg.sample_format.value // 8)

    def init(self, cfg=None) -> None:
        import socket

        host, _, port = self.addr.rpartition(":")
        self._sock = socket.create_connection((host or "127.0.0.1",
                                               int(port)), timeout=10)
        # create_connection's timeout leaves the fd in non-blocking mode;
        # the streaming path (python sendall AND the native drain loop
        # handed the raw fd) needs a blocking socket — otherwise a full
        # send buffer surfaces as EAGAIN mid-stream instead of
        # backpressure.
        self._sock.settimeout(None)
        bps = self._bytes_per_sec(cfg) if self.pace else 0.0
        block_bytes = 1_200_000
        if cfg is not None:
            block_bytes = max(
                2 * cfg.samples_per_epoch * (cfg.sample_format.value // 8), 2
            )
        if self.engine in ("auto", "native"):
            from . import native

            if native.available():
                self._native = native.NativeStreamer(
                    self._sock.fileno(), fifo_depth=self.fifo_depth,
                    block_bytes=block_bytes, bytes_per_sec=bps,
                    start_timeout_s=self.start_timeout_s,
                )
                return
            if self.engine == "native":
                raise RuntimeError(
                    f"native runtime unavailable: {native.load_error()}"
                )
        self._bps = bps
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        import time

        try:
            self.fifo.wait_full(timeout=self.start_timeout_s)
            self._started.set()
            t0 = time.perf_counter()
            while True:
                if self._bps > 0:
                    due = t0 + self._py_bytes / self._bps
                    now = time.perf_counter()
                    if due > now:
                        time.sleep(due - now)
                    if self.fifo.empty_and_live():
                        self._py_underruns += 1
                block = self.fifo.dequeue()
                if block is None:
                    return
                data = block.tobytes()
                self._sock.sendall(data)
                self._py_bytes += len(data)
        except BaseException as e:
            self._error = e
            self.fifo.halt()

    def write(self, block: np.ndarray) -> None:
        if self._native is not None:
            self._native.write(block)
            return
        if self._error is not None:
            raise RuntimeError(
                f"tcp streamer failed: {self._error}"
            ) from self._error
        if not self.fifo.enqueue(np.asarray(block)):
            raise RuntimeError("tcp streamer halted")

    @property
    def underruns(self) -> int:
        if self._native is not None:
            return self._native.underruns
        return self._py_underruns

    @property
    def backlogged(self) -> bool:
        """True when the sink FIFO is full — the producer is blocked on
        the TRANSPORT (consumer below the DAC rate), not on synthesis.
        The realtime supervisor uses this to attribute a deficit: a
        synthesis failover cannot help a slow transport."""
        if self._native is not None:
            return self._native.depth_used >= self.fifo_depth
        return self.fifo.depth_used >= self.fifo.depth

    @property
    def started(self) -> bool:
        if self._native is not None:
            return self._native.started
        return self._started.is_set()

    @property
    def bytes_sent(self) -> int:
        if self._native is not None:
            return self._native.bytes_sent
        return self._py_bytes

    def end_stream(self) -> None:
        if self._native is not None:
            # The native drain keeps transmitting queued blocks after a
            # FIFO halt (Fifo::dequeue drains before returning nullptr).
            self._native.halt()
        elif self.fifo is not None:
            # The Python BlockFifo's halt() DISCARDS the queue (the
            # reference's abort semantics, fifo.c:105-126) — end of
            # stream must flush, so mark finished instead: everything
            # queued still transmits, only underrun accounting stops.
            self.fifo.finish()

    def close(self) -> None:
        if self._native is not None:
            try:
                # Flushes at the paced rate, bounded by the same deadline
                # as the Python path (a dead peer must not hang the run).
                self._native.close(flush_timeout_s=self.flush_timeout_s)
                # Preserve final stats — the runner closes the sink, and
                # callers read underruns/bytes_sent afterwards.
                self._py_bytes = self._native.final_bytes_sent
                self._py_underruns = self._native.final_underruns
                if self._native.final_started:
                    self._started.set()
            finally:
                self._native = None
                if self._sock is not None:
                    self._sock.close()
                    self._sock = None
            return
        if self._thread is not None:
            # A short run may never have filled the pre-buffer: release
            # the start-full barrier so the drain transmits what was
            # queued instead of stalling out its full start timeout.
            self.fifo.force_barrier()
            # Let the drain finish the queue — bounded: a peer that
            # stopped reading must not hang close() (and with it the
            # whole run) forever.
            import time

            deadline = time.monotonic() + self.flush_timeout_s
            while (
                self.fifo.depth_used
                and self._thread.is_alive()
                and time.monotonic() < deadline
            ):
                time.sleep(0.001)
            self.fifo.halt()
            self._thread.join(timeout=2)
            if self._thread.is_alive() and self._sock is not None:
                # The drain is stuck in sendall on a stalled peer:
                # closing the socket aborts the send with an error.
                self._sock.close()
                self._sock = None
                self._thread.join(timeout=2)
            self._thread = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class HackRfSink(Sink):
    """HackRF TX backend (reference sdr_hackrf.c) minus libusb.

    Preserves the reference's contract: 8-bit samples forced
    (sdr_hackrf.c:44-48), TX gain clamped to 0-47 dB (sdr_hackrf.h:19-20),
    LO shifted by freq*(1e7-ppb)/1e7 (sdr_hackrf.c:136-138), and the
    engine-side repacking of 0.1 s blocks into 262,144-element transfer
    buffers (gps.c:2847-2856 / sdr_hackrf.c:215-218). The ``device``
    callable stands in for the libusb TX callback: it receives each
    int8[262144] transfer in order (hardware integration = supplying a
    callable that pushes to libhackrf)."""

    name = "hackrf"
    forced_sample_bits = 8
    gain_range = (0, 47)
    transfer_size = 262_144

    def __init__(self, device=None, lib_path: str | None = None):
        self.device = device
        self.lib_path = lib_path
        self._hw = None
        self._start_error: BaseException | None = None
        # Preallocated transfer staging: blocks copy into the ring once
        # and each full transfer is a zero-copy slice — no O(n^2)
        # concatenate churn in the realtime TX path (ADVICE r1).
        self._buf = np.empty(self.transfer_size, dtype=np.int8)
        self._fill = 0

    def init(self, cfg=None) -> None:
        if self.device is None:
            # Bind real hardware through libhackrf when present
            # (sdr_hackrf.c contract, see io/hw_hackrf.py).
            from . import hw_hackrf

            if hw_hackrf.hackrf_available(self.lib_path):
                self._hw = hw_hackrf.HackRfTx(
                    tx_gain=getattr(cfg, "tx_gain", 0),
                    amp=getattr(cfg, "tx_amplifier", False),
                    ppb=getattr(cfg, "ppb", 0),
                    lib_path=self.lib_path,
                    sample_rate=getattr(
                        cfg, "sample_rate", hw_hackrf.TX_SAMPLERATE
                    ),
                )
                self.device = self._hw.push
                # TX starts once the FIFO pre-buffer fills (the
                # fifo_wait_full barrier) — wait on a thread so the
                # producer can fill it. A start failure must halt the
                # FIFO (unblocking a producer parked in enqueue) and
                # surface on the next write, not die with the thread.
                def _start_bg():
                    try:
                        self._hw.start()
                    except BaseException as e:
                        self._start_error = e
                        self._hw.fifo.halt()

                threading.Thread(target=_start_bg, daemon=True).start()
                return
            raise RuntimeError(
                "hackrf hardware not available (libhackrf not found); "
                "pass HackRfSink(device=...) to supply a TX transfer "
                "callable"
            )

    def write(self, block: np.ndarray) -> None:
        if self.device is None:
            raise RuntimeError("hackrf sink has no device")
        if self._start_error is not None:
            raise RuntimeError(
                f"hackrf TX start failed: {self._start_error}"
            ) from self._start_error
        block = np.asarray(block, dtype=np.int8).ravel()
        n = self.transfer_size
        pos = 0
        while pos < len(block):
            take = min(len(block) - pos, n - self._fill)
            self._buf[self._fill : self._fill + take] = block[
                pos : pos + take
            ]
            self._fill += take
            pos += take
            if self._fill >= n:
                # Hand out a stable per-transfer buffer (the libusb
                # transfer owns its memory in the reference); one copy per
                # transfer, no quadratic restaging.
                self.device(self._buf[:n].copy())
                self._fill = 0

    def close(self) -> None:
        # The reference transmits whole transfer buffers only; a trailing
        # partial buffer is dropped exactly like its fifo remainder.
        self._fill = 0
        if self._hw is not None:
            self._hw.close()
            self._hw = None
            self.device = None

    def set_gain(self, gain: int) -> int:
        if self._hw is not None:
            return self._hw.set_gain(gain)
        return max(0, min(47, gain))


class PlutoSink(Sink):
    """ADALM-Pluto TX backend (reference sdr_pluto.c) minus libiio.

    Contract: 16-bit samples forced (sdr_pluto.c:106-110), gain -80..0 dB
    (sdr_pluto.h:39-40), same ppb LO model, the 2x baseband gain boost the
    engine applies for the 12-bit DAC (gps.c:2759-2763), and whole-block
    pushes (one 600,000-element int16 buffer per 0.1 s epoch,
    sdr_pluto.c:45-94). ``device`` stands in for iio_buffer_push."""

    name = "plutosdr"
    forced_sample_bits = 16
    gain_range = (-80, 0)

    def __init__(self, device=None, lib_path: str | None = None):
        self.device = device
        self.lib_path = lib_path
        self._hw = None

    def init(self, cfg=None) -> None:
        if self.device is None:
            # Bind real hardware through libiio when present
            # (sdr_pluto.c contract, see io/hw_pluto.py).
            from . import hw_pluto

            if hw_pluto.iio_available(self.lib_path):
                self._hw = hw_pluto.PlutoTx(
                    tx_gain=getattr(cfg, "tx_gain", 0),
                    ppb=getattr(cfg, "ppb", 0),
                    hostname=getattr(cfg, "pluto_hostname", None),
                    uri=getattr(cfg, "pluto_uri", None),
                    lib_path=self.lib_path,
                    sample_rate=getattr(
                        cfg, "sample_rate", hw_pluto.TX_SAMPLERATE
                    ),
                )
                self._hw.start()  # TX LO on (sdr_pluto.c:246-252)
                self.device = self._hw.push
                return
            raise RuntimeError(
                "plutosdr hardware not available (libiio not found); pass "
                "PlutoSink(device=...) to supply an iio-push callable"
            )

    def write(self, block: np.ndarray) -> None:
        if self.device is None:
            raise RuntimeError("plutosdr sink has no device")
        self.device(np.asarray(block, dtype=np.int16))

    def close(self) -> None:
        if self._hw is not None:
            self._hw.close()
            self._hw = None
            self.device = None

    def set_gain(self, gain: int) -> int:
        if self._hw is not None:
            return self._hw.set_gain(gain)
        return max(-80, min(0, gain))


_REGISTRY: dict[str, Callable[..., Sink]] = {
    "none": NullSink,
    "null": NullSink,
    "iqfile": IqFileSink,
    "tcp": TcpSink,
    "hackrf": HackRfSink,
    "plutosdr": PlutoSink,
}


def make_sink(name: str, **kwargs) -> Sink:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown sink {name!r}; supported: {', '.join(sorted(_REGISTRY))}"
        ) from None
    return factory(**kwargs)


def register_sink(name: str, factory: Callable[..., Sink]) -> None:
    _REGISTRY[name] = factory


def make_configured_sink(cfg) -> Sink:
    """Build the sink named by ``cfg.sink`` with its config-derived kwargs
    and apply the hardware gain contract (the clamp each reference
    ``sdr_*_init`` performs — sdr_hackrf.h:19-20, sdr_pluto.h:39-40),
    writing the clamped gain back into ``cfg.tx_gain``."""
    kwargs = {}
    if cfg.sink == "iqfile":
        kwargs = {"path": cfg.out_file, "fifo_depth": cfg.fifo_depth}
    elif cfg.sink == "tcp":
        kwargs = {"addr": cfg.tcp_addr, "fifo_depth": cfg.fifo_depth,
                  "pace": cfg.realtime}
        if cfg.realtime:
            # The start barrier must outlast the first kernel compile of
            # a device-backend run (tens of minutes through a remote
            # compile service on a bad day): a paced drain giving up its
            # barrier would book the wait as underruns before the first
            # real byte exists. Pre-start wall time is not part of the
            # underrun contract — the TX simply begins later.
            kwargs["start_timeout_s"] = 3600.0
    sink = make_sink(cfg.sink, **kwargs)
    if sink.gain_range is not None:
        cfg.tx_gain = sink.set_gain(cfg.tx_gain)
    return sink
