"""The port's native sinks lend read-only blocks instead of copying them.

``io/native`` queues a C-contiguous read-only ndarray by pointer (lent)
and copies any other block into the FIFO's ring, as before. Here: both
kinds round-trip byte for byte through ``IqFileSink`` to a real file and
through a paced ``TcpSink`` to a loopback reader, and the FIFO counts
which was which; a lent block's memory lives until the drain thread has
written it, through backpressure, halt, early close, a stalled peer and an
I/O error, and not after ``close()``; and the pipeline hands the sinks
read-only windows (``runner.fetch_batch``), so every block of a CPU run
and of a CPU fleet is lent and the files equal the Python FIFO's.
"""

import dataclasses
import fcntl
import gc
import os
import socket
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from gpssim_tpu_torch import fleet, runner
from gpssim_tpu_torch.config import LocationConfig, SimConfig, SynthBackend
from gpssim_tpu_torch.io import native
from gpssim_tpu_torch.io.sinks import IqFileSink, TcpSink

RATE = 1_030_000  # the lowest rate: the least CPU per block


def _pipe_slack(fd: int) -> int:
    """Bytes that may have left the drain and not yet reached a reader:
    what the pipe holds, and a stdio buffer beside it."""
    return fcntl.fcntl(fd, getattr(fcntl, "F_GETPIPE_SZ", 1032)) + 65536


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(k: int, nbytes: int) -> np.ndarray:
    return ((np.arange(nbytes, dtype=np.int64) * 7 + k * 131) % 251
            - 125).astype(np.int8)


def _send(sink, kind: str, blocks: int, nbytes: int) -> bytes:
    """Write ``blocks`` blocks in the caller's way for ``kind``: lent,
    dropping the last reference at once, or copied, overwriting the one
    buffer after each write. Returns the bytes handed over."""
    sent = []
    buf = np.empty(nbytes, dtype=np.int8)
    for k in range(blocks):
        if kind == "lent":
            blk = _block(k, nbytes)
            blk.flags.writeable = False
            sent.append(blk.tobytes())
            sink.write(blk)
            del blk
            gc.collect()
        else:
            buf[:] = _block(k, nbytes)
            sent.append(buf.tobytes())
            sink.write(buf)
            buf[:] = -1
    return b"".join(sent)


def _check_counts(st: dict, kind: str, blocks: int) -> None:
    assert st["dequeued"] == blocks
    if kind == "lent":
        assert st["lent"] == st["lent_done"] == blocks
        assert st["copy_ns"] == 0
    else:
        assert st["lent"] == st["lent_done"] == 0
        assert st["copy_ns"] > 0


@pytest.mark.parametrize("kind", ["lent", "copied"])
def test_iqfile_round_trip(kind, tmp_path):
    path = tmp_path / "out.bin"
    sink = IqFileSink(str(path), fifo_depth=3, engine="native")
    sink.init()
    sent = _send(sink, kind, blocks=10, nbytes=300_000)
    sink.close()
    assert path.read_bytes() == sent
    _check_counts(sink.fifo_stats, kind, 10)


def test_lent_blocks_under_thread_contention(tmp_path):
    """More producer threads than cores, each lending small blocks that it
    drops at once to its own writer, at a short switch interval: a block
    released before its drain wrote it would be reused by a later one and
    show in the file."""
    import sys

    threads, blocks, nbytes = (os.cpu_count() or 1) + 2, 400, 4096
    files = [tmp_path / f"t{i}.bin" for i in range(threads)]
    sent = [[] for _ in range(threads)]

    def produce(i):
        sink = IqFileSink(str(files[i]), fifo_depth=2, engine="native")
        sink.init()
        for k in range(blocks):
            blk = _block(k + 1000 * i, nbytes)
            sent[i].append(blk.tobytes())
            blk.flags.writeable = False
            sink.write(blk)
            del blk
        sink.close()
        sent[i].append(sink.fifo_stats["lent"])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=produce, args=(i,), daemon=True)
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    for path, got in zip(files, sent):
        assert got[-1] == blocks
        assert path.read_bytes() == b"".join(got[:-1])


def _loopback_reader():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = bytearray()

    def read():
        conn, _ = srv.accept()
        with conn:
            while chunk := conn.recv(1 << 16):
                got.extend(chunk)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return srv, reader, got


@pytest.mark.parametrize("kind", ["lent", "copied"])
def test_paced_tcp_round_trip(kind, fixtures_dir):
    srv, reader, got = _loopback_reader()
    cfg = SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                    sample_rate=RATE, realtime=True)
    sink = TcpSink(f"127.0.0.1:{srv.getsockname()[1]}", fifo_depth=3,
                   engine="native")
    sink.init(cfg)
    t0 = time.perf_counter()
    sent = _send(sink, kind, blocks=6, nbytes=2 * cfg.samples_per_epoch)
    sink.close()
    reader.join(10)
    srv.close()
    assert not reader.is_alive()
    assert bytes(got) == sent
    _check_counts(sink.fifo_stats, kind, 6)
    # paced at 2.06 MB/s: 6 blocks of 0.1 s take at least 0.5 s
    assert time.perf_counter() - t0 >= 0.45


class _SlowPipe:
    """A pipe read slowly by a thread, which counts the reads at which
    ``alive(bytes read so far)`` was false."""

    def __init__(self, alive, stop_after: int | None = None):
        self.r, self.w = os.pipe()
        self.slack = _pipe_slack(self.w)
        self.alive = alive
        self.stop_after = stop_after
        self.got = bytearray()
        self.dead_early = 0
        self.thread = threading.Thread(target=self._read, daemon=True)

    def _read(self):
        with os.fdopen(self.r, "rb", buffering=0) as fp:
            while True:
                if not self.alive(len(self.got), self.slack):
                    self.dead_early += 1
                if (self.stop_after is not None
                        and len(self.got) >= self.stop_after):
                    return  # closing the read end: the writer gets EPIPE
                chunk = fp.read(1 << 16)
                if not chunk:
                    return
                self.got.extend(chunk)
                time.sleep(0.002)


def _lent_views(blocks: int, nbytes: int):
    """Read-only row views of one torch tensor, as ``runner.fetch_batch``
    hands them out: (views, weakref to the tensor that holds their memory,
    their bytes)."""
    t = torch.empty((blocks, nbytes), dtype=torch.int8)
    arr = t.numpy()
    arr[:] = [_block(k, nbytes) for k in range(blocks)]
    arr.flags.writeable = False
    return list(arr), weakref.ref(arr.base), arr.tobytes()


def _alive_until_written(ref, total: int):
    """The tensor lives while more than a pipe's worth of its bytes is
    still to come, so the drain thread has not yet written them all."""
    return lambda got, slack: total - got <= slack or ref() is not None


def test_lent_blocks_live_until_written_through_backpressure():
    blocks, nbytes = 8, 512 * 1024
    views, ref, sent = _lent_views(blocks, nbytes)
    pipe = _SlowPipe(_alive_until_written(ref, len(sent)))
    sink = IqFileSink(f"/dev/fd/{pipe.w}", fifo_depth=2, engine="native")
    sink.init()
    os.close(pipe.w)
    pipe.thread.start()
    for v in views:
        sink.write(v)
    del views, v
    gc.collect()
    # the producer is through, the drain is not: the sink holds the views
    assert ref() is not None
    sink.close()
    pipe.thread.join(30)
    gc.collect()
    assert ref() is None
    assert pipe.dead_early == 0
    assert bytes(pipe.got) == sent
    st = sink.fifo_stats
    assert st["acquire_wait_ns"] > 0
    assert st["lent"] == st["lent_done"] == blocks
    assert st["copy_ns"] == 0


def test_each_lent_block_lives_until_its_own_bytes_are_written():
    """Blocks of separate tensors, each within one of the writer's 1.2 MB
    ring slots: each lives until the drain has written it, not merely
    until it was dequeued."""
    blocks, nbytes = 6, 1 << 20
    views, refs = [], []
    for k in range(blocks):
        arr = torch.empty(nbytes, dtype=torch.int8).numpy()
        arr[:] = _block(k, nbytes)
        arr.flags.writeable = False
        views.append(arr)
        refs.append(weakref.ref(arr.base))
    del arr
    sent = b"".join(v.tobytes() for v in views)

    def alive(got, slack):
        return all(ref() is not None for k, ref in enumerate(refs)
                   if (k + 1) * nbytes - got > slack)

    pipe = _SlowPipe(alive)
    sink = IqFileSink(f"/dev/fd/{pipe.w}", fifo_depth=2, engine="native")
    sink.init()
    os.close(pipe.w)
    pipe.thread.start()
    for _ in range(blocks):
        sink.write(views.pop(0))
        gc.collect()
    sink.close()
    pipe.thread.join(30)
    assert not pipe.thread.is_alive()
    assert pipe.dead_early == 0
    assert bytes(pipe.got) == sent
    assert all(ref() is None for ref in refs)


@pytest.mark.parametrize("ending", ["halt", "stalled peer", "io error"])
def test_no_lent_block_is_dropped_before_the_drain_is_joined(ending):
    """Halt (end of stream) then close, with blocks still queued, flushes
    them all; a close that gives up on a stalled peer, and a peer that
    goes away, stop the drain early. In each the views stay alive until
    ``close()`` has joined the drain thread."""
    blocks, nbytes = 6, 512 * 1024
    views, ref, sent = _lent_views(blocks, nbytes)
    stop_after = {"halt": None, "stalled peer": 0,
                  "io error": 2 * nbytes}[ending]
    pipe = _SlowPipe(_alive_until_written(ref, len(sent)), stop_after)
    if ending == "io error":
        sink = native.NativeIqWriter(f"/dev/fd/{pipe.w}", fifo_depth=2)
        os.close(pipe.w)
    else:
        # the drain starts once both buffers are taken (the start barrier)
        sink = native.NativeStreamer(pipe.w, fifo_depth=2,
                                     bytes_per_sec=0.0, start_timeout_s=5.0)
    if ending != "stalled peer":
        pipe.thread.start()
    wrote = 0
    try:
        for v in views[:2 if ending == "stalled peer" else blocks]:
            sink.write(v)
            wrote += 1
    except OSError:
        assert ending == "io error"
    del views, v
    gc.collect()
    assert ref() is not None
    if ending == "halt":
        sink.halt()
        time.sleep(0.05)
        assert ref() is not None
        sink.close()
    elif ending == "stalled peer":
        time.sleep(0.2)
        assert ref() is not None
        with pytest.raises(OSError):
            sink.close(flush_timeout_s=0.3)
    else:
        with pytest.raises(OSError):
            sink.close()
    gc.collect()
    assert ref() is None
    if ending != "io error":
        os.close(pipe.w)
    if ending == "stalled peer":
        os.close(pipe.r)
    else:
        pipe.thread.join(30)
    assert pipe.dead_early == 0
    assert sent.startswith(bytes(pipe.got))
    if ending == "halt":
        assert bytes(pipe.got) == sent
    else:
        assert wrote >= 2  # the error came after some blocks were lent
    st = sink.final_stats
    assert st["lent"] == wrote + (ending == "io error" and wrote < blocks)
    assert st["lent_done"] <= st["lent"]


def test_fetch_batch_returns_a_read_only_window():
    out = torch.arange(12, dtype=torch.int16).reshape(2, 6)
    host, retried = runner.fetch_batch(runner.InFlight(out), None)
    assert not retried and not host.flags.writeable
    assert all(row.flags.c_contiguous and not row.flags.writeable
               for row in host)

    class Failed:
        def result(self):
            raise RuntimeError("device error")

    host, retried = runner.fetch_batch(Failed(),
                                       lambda: runner.InFlight(out + 1))
    assert retried and not host.flags.writeable


def _cfg(fixtures_dir, **kw):
    return SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                     almanac_enable=False, sample_rate=RATE,
                     duration_sec=1.2, backend=SynthBackend.TORCH,
                     device="cpu", dispatch_blocks=4, **kw)


@pytest.mark.parametrize("kind, strict", [
    ("single", False), ("fleet", False), ("single", True)])
def test_pipeline_lends_every_block(kind, strict, fixtures_dir, tmp_path):
    """A CPU run writes the same files through the native FIFOs as
    through the Python FIFO, every block lent; in strict parity a block
    that the corrections patch is a fresh copy, and copied."""
    base = _cfg(fixtures_dir, parity_exact=strict)
    cfgs = [base]
    if kind == "fleet":
        cfgs.append(dataclasses.replace(
            base, location=LocationConfig(40.7128, -74.0060, 20.0)))
    files = {}
    for engine in ("native", "python"):
        sinks = [IqFileSink(str(tmp_path / f"{engine}_{i}.bin"),
                            engine=engine) for i in range(len(cfgs))]
        if kind == "single":
            stats = [runner.run_simulation(base, sink=sinks[0])]
        else:
            stats = fleet.run_fleet(cfgs, sinks=sinks)
        files[engine] = [open(s.path, "rb").read() for s in sinks]
        for sink, st in zip(sinks, stats):
            assert st.blocks > 0
            if engine == "native":
                fs = sink.fifo_stats
                assert fs["dequeued"] == st.blocks
                assert fs["lent_done"] == fs["lent"]
                if strict:
                    assert 0 < fs["lent"] <= st.blocks
                else:
                    assert fs["lent"] == st.blocks and fs["copy_ns"] == 0
            else:
                assert sink.fifo_stats is None
    assert files["native"] == files["python"]
    assert all(files["native"])
