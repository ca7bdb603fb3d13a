"""End-to-end run loop: scenario plans → synth backend → quantize → sink.

Runs on the cuda/torch backends take the pipelined batched path
(:func:`_run_batched`): one kernel launch per window of
``cfg.dispatch_blocks`` blocks, with two windows in flight, so the
device-to-host copy, the strict-parity corrections and the sink write of
one window overlap the next window's kernel. The numpy and native backends
run block by block on the host.

Realtime pacing and interactive control are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import itertools
import logging
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from .config import CarrierMode, SimConfig, SynthBackend
from .io.sinks import Sink, make_configured_sink
from .ops.synth_numpy import quantize_iq, synth_block_numpy
from .scenario import Simulation

logger = logging.getLogger("gpssim_tpu_torch.runner")

#: backends whose synthesis runs as a torch kernel on ``cfg.device``
DEVICE_BACKENDS = (SynthBackend.CUDA, SynthBackend.TORCH)


@dataclass
class RunStats:
    blocks: int = 0
    samples: int = 0
    wall_seconds: float = 0.0
    synth_seconds: float = 0.0
    plan_seconds: float = 0.0
    # batched path only: host time waiting for a window's result, and
    # applying the strict-parity corrections to it
    fetch_seconds: float = 0.0
    correct_seconds: float = 0.0
    retries: int = 0  # windows re-dispatched after a device error

    @property
    def samples_per_second(self) -> float:
        return self.samples / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def realtime_factor(self) -> float:
        # One block = 0.1 s of signal.
        return (self.blocks * 0.1) / self.wall_seconds if self.wall_seconds else 0.0


def resolve_device(cfg: SimConfig):
    """The torch device for the cuda/torch backends. ``cuda`` without a
    card raises: the CPU runs only when the caller asks for it."""
    import torch

    dev = torch.device(cfg.device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={cfg.device!r}: expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={cfg.device!r} but torch finds no CUDA device; pass "
            "device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def strict_parity_enabled(cfg: SimConfig) -> bool:
    """Whether output must replay the reference's sequential-f64 phase
    semantics exactly (parity_exact + the native engine present)."""
    if not cfg.parity_exact:
        return False
    from .ops.synth_seq import seq_available

    return seq_available()


def make_synth_fn(cfg: SimConfig):
    """Resolve the block synthesizer of a host backend (numpy, native).

    Under strict parity the closed-form NumPy output is patched with the
    sparse sequential corrections (ops/synth_seq.py); the native hot loop
    is sequential-exact itself. The cuda/torch backends run windows of
    blocks through :func:`_run_batched` instead.
    """
    int_nco = cfg.carrier_mode is CarrierMode.INT_NCO
    strict = strict_parity_enabled(cfg)
    if cfg.backend is SynthBackend.NUMPY:
        if strict:
            from .ops.synth_seq import synth_block_seq

            return lambda plan: synth_block_seq(plan, int_nco=int_nco)
        return lambda plan: synth_block_numpy(plan, int_nco=int_nco)
    if cfg.backend is SynthBackend.NATIVE:
        from .ops.synth_seq import seq_available, synth_block_seq_native

        if not seq_available():
            raise RuntimeError(
                "native backend requires the C++ runtime "
                "(tools/build_native.sh)"
            )
        # The native hot loop IS sequential-exact — no patch layer needed.
        return lambda plan: synth_block_seq_native(plan, int_nco=int_nco)
    raise ValueError(f"unknown backend {cfg.backend}")


def run_simulation(
    cfg: SimConfig,
    sink: Sink | None = None,
    sim: Simulation | None = None,
    on_block=None,
    stop=None,
) -> RunStats:
    """Run a full scenario to the configured sink. Returns throughput stats.

    on_block(stats, sim, plan) is called after each block (or window) is
    written (checkpointing, metrics); stop() → True aborts cleanly between
    blocks.

    cuda/torch runs take the pipelined batched path: one kernel launch per
    window of ``cfg.dispatch_blocks`` blocks, with the device work of
    window k+1 overlapped against the copy back, corrections and sink
    write of window k. numpy/native runs go block by block."""
    if cfg.realtime or cfg.interactive:
        raise NotImplementedError(
            "realtime and interactive runs are not ported to the "
            "PyTorch/CUDA package yet; see ROADMAP.md"
        )
    device = None
    if cfg.backend in DEVICE_BACKENDS:
        device = resolve_device(cfg)  # no card for device="cuda" raises
    if sim is None:
        sim = Simulation(cfg)
    if sink is None:
        sink = make_configured_sink(cfg)
    sink.init(cfg)

    if device is not None:
        return _run_batched(cfg, sink, sim, on_block, stop, device)

    synth_fn = make_synth_fn(cfg)
    bits = cfg.sample_format.value
    base_index = sim.next_block_index  # noise keying (resume-stable)
    if cfg.noise_std_lsb > 0.0:
        from .noise import apply_awgn

    stats = RunStats()
    t0 = time.perf_counter()
    try:
        tp = time.perf_counter()
        for plan in sim.iter_plans():
            ts = time.perf_counter()
            stats.plan_seconds += ts - tp
            iq16 = np.asarray(synth_fn(plan))
            te = time.perf_counter()
            stats.synth_seconds += te - ts
            blk = quantize_iq(iq16, bits)
            if cfg.noise_std_lsb > 0.0:
                blk = apply_awgn(blk, bits, cfg.noise_std_lsb,
                                 cfg.noise_seed, 0,
                                 base_index + stats.blocks)
            sink.write(blk)
            stats.blocks += 1
            stats.samples += plan.num_samples
            stats.wall_seconds = te - t0
            if on_block is not None:
                on_block(stats, sim, plan)
            if stop is not None and stop():
                break
            tp = time.perf_counter()
    finally:
        sink.close()
    stats.wall_seconds = time.perf_counter() - t0
    return stats


def resolve_batch_kernel(cfg: SimConfig):
    """Batched kernel + static call facts for a config.

    Returns (kernel, wide, n_rows, bits)."""
    from .ops.args import LANES, needs_wide_window

    if cfg.backend is SynthBackend.CUDA:
        from .ops.synth_cuda import synth_blocks_batch_cuda as kernel
    elif cfg.backend is SynthBackend.TORCH:
        from .ops.synth_torch import synth_blocks_batch_torch as kernel
    else:
        raise ValueError(f"{cfg.backend} has no batched device kernel")

    wide = needs_wide_window(1.0 / cfg.sample_rate)
    n_rows = -(-cfg.samples_per_epoch // LANES)
    bits = cfg.sample_format.value
    return kernel, wide, n_rows, bits


class InFlight:
    """One dispatched window: its host output buffer and, on a CUDA
    device, the event recorded after the copy into it."""

    def __init__(self, host, done=None):
        self.host = host
        self.done = done

    def result(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


def make_packed_kernel(kernel, n_rows: int, num_samples: int, bits: int,
                       wide: bool, device):
    """Window dispatch: ``dispatch(packed, spec) -> InFlight``.

    The window's packed int32 args (ops/args.pack_args) go into one pinned
    host buffer and cross in one non-blocking copy; the kernel reads views
    of the device copy (ops/args.unpack_args). Its output comes back by a
    non-blocking copy into a pinned host buffer, followed by an event. The
    windows alternate between two CUDA streams, so one window's copy back
    overlaps the next window's kernel. On the CPU the call is synchronous.
    """
    import torch

    from .ops.args import unpack_args

    def launch(args):
        return kernel(args, n_rows=n_rows, num_samples=num_samples,
                      out_bits=bits, wide=wide)

    if device.type != "cuda":
        def dispatch_cpu(packed, spec):
            return InFlight(launch(unpack_args(torch.from_numpy(packed), spec)))

        return dispatch_cpu

    streams = [torch.cuda.Stream(device) for _ in range(2)]
    turn = itertools.count()

    def dispatch(packed, spec):
        stream = streams[next(turn) % len(streams)]
        host_in = torch.from_numpy(packed).pin_memory()
        with torch.cuda.stream(stream):
            dev_in = host_in.to(device, non_blocking=True)
            out = launch(unpack_args(dev_in, spec))
            host_out = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
            host_out.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return InFlight(host_out, done)

    return dispatch


def fetch_batch(fut: InFlight, redispatch) -> tuple[np.ndarray, bool]:
    """Wait for a window with the transient-failure retry policy.

    Out of memory re-raises at once — a re-run would fail the same way.
    Any other device error re-dispatches the window once, to the same
    kernel: every block is a pure function of its plan. Returns
    (host_array, retried)."""
    import torch

    try:
        return fut.result(), False
    except torch.cuda.OutOfMemoryError:
        raise
    except RuntimeError:
        return redispatch().result(), True


def _run_batched(
    cfg: SimConfig, sink: Sink, sim: Simulation, on_block, stop, device,
) -> RunStats:
    """Pipelined batched device path (see run_simulation docstring).

    The bounded in-flight window (2 windows) is the pipeline depth; the
    asynchrony of CUDA streams provides the overlap."""
    from .checkpoint import capture_state
    from .ops.args import collate_plans, pack_args

    int_nco = cfg.carrier_mode is CarrierMode.INT_NCO
    kernel, wide, n_rows, bits = resolve_batch_kernel(cfg)
    dispatch = make_packed_kernel(
        kernel, n_rows, cfg.samples_per_epoch, bits, wide, device
    )
    W = max(1, cfg.dispatch_blocks)
    strict = strict_parity_enabled(cfg)
    if strict:
        from .ops.synth_seq import apply_corrections, seq_corrections_window
    base_index = sim.next_block_index  # noise keying (resume-stable)
    if cfg.noise_std_lsb > 0.0:
        from .noise import apply_awgn

    stats = RunStats()
    t0 = time.perf_counter()
    it = sim.iter_plans()
    pending: deque = deque()  # (in_flight, redispatch_fn, plans, snapshot)
    # Nothing written yet: a checkpoint taken before the first window
    # drains must capture the pre-run state, not planner-ahead state.
    sim.consistent_snapshot = capture_state(sim)
    any_full = False  # a W-block window has been dispatched

    def drain_one() -> None:
        fut, redispatch, done_plans, snap = pending.popleft()
        tf = time.perf_counter()
        host, retried = fetch_batch(fut, redispatch)  # quantized
        tc = time.perf_counter()
        stats.fetch_seconds += tc - tf
        stats.retries += retried
        blocks = list(host)
        if strict:
            corrs = seq_corrections_window(done_plans, int_nco=int_nco)
            blocks = [apply_corrections(blk, bits, *corr)
                      for blk, corr in zip(blocks, corrs)]
        stats.correct_seconds += time.perf_counter() - tc
        for blk, plan in zip(blocks, done_plans):
            if cfg.noise_std_lsb > 0.0:
                blk = apply_awgn(blk, bits, cfg.noise_std_lsb,
                                 cfg.noise_seed, 0,
                                 base_index + stats.blocks)
            sink.write(blk)
            stats.blocks += 1
            stats.samples += plan.num_samples
        stats.wall_seconds = time.perf_counter() - t0
        sim.consistent_snapshot = snap
        if on_block is not None:
            on_block(stats, sim, done_plans[-1])

    try:
        while True:
            ts = time.perf_counter()
            plans = list(itertools.islice(it, W))
            tp = time.perf_counter()
            stats.plan_seconds += tp - ts
            if plans:
                # Pad a short tail window up to W blocks, so every launch
                # has the same shape; padding blocks are synthesized and
                # dropped.
                padded = plans
                if any_full and len(plans) < W:
                    padded = plans + [plans[-1]] * (W - len(plans))
                any_full = any_full or len(padded) == W
                # compact_multiple=4 bounds the distinct channel extents
                # as 30 s reallocations drift the max-active count.
                batch = collate_plans(padded, int_nco=int_nco,
                                      compact=True, compact_multiple=4)
                packed, spec = pack_args(batch.args)

                def redispatch(p=packed, s=spec):
                    return dispatch(p, s)

                # Snapshot NOW: sim state currently matches "all planned
                # blocks done". By the time this window drains, the planner
                # has run ahead — hooks must see the state matching the
                # blocks actually written, or a checkpoint would skip the
                # in-flight window on resume.
                pending.append(
                    (redispatch(), redispatch, plans, capture_state(sim))
                )
                stats.synth_seconds += time.perf_counter() - tp
            if (not plans and pending) or len(pending) >= 2:
                drain_one()
            if not plans and not pending:
                # Normal completion: live state matches the written blocks
                # again, so later checkpoints can use it directly.
                sim.consistent_snapshot = None
                break
            if stop is not None and stop():
                # Stopped with a window in flight: keep the last drain-time
                # snapshot so a final checkpoint doesn't skip unwritten
                # blocks.
                break
    finally:
        sink.close()
    stats.wall_seconds = time.perf_counter() - t0
    return stats
