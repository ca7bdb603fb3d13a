"""Fleet mode: many independent scenarios through one batched device
pipeline, offline or paced.

Every block is a pure function of its plan, so blocks from different
scenarios batch exactly like consecutive blocks of one scenario: one card
generates N locations' or trajectories' worth of signal with the same
kernel and the same aggregate sample rate as a single scenario. Useful for
receiver-farm testing, coverage studies and multi-target rigs. Each
member's output equals running its scenario alone (tests/test_torch_fleet.py):
batching is stacking on the block axis, and the strict-parity corrections
are per-plan host-side patches.

Scenarios are interleaved round-robin so every member progresses at the
same signal-time rate; members may differ in duration, location, motion
file and ephemeris, but share the static kernel facts (sample rate, sample
format, carrier mode, backend, device).

The counterpart of the JAX package's ``fleet.py``, realtime fleets
included (the supervisor, the whole-fleet native failover tail and the
probed failback), without three of its faults: a failback writes the
probed plans it holds before resuming, the tail keeps the supervisor's
block count current, and a probe window's signal time counts only the
members in it.
"""

from __future__ import annotations

import dataclasses
import itertools
import os.path
import time
from collections import deque

from .config import CarrierMode, LocationConfig, SimConfig, SynthBackend
from .io.sinks import Sink, make_configured_sink
from .runner import (
    DEVICE_BACKENDS, DeviceProbe, RealtimeSupervisor, RunStats,
    _make_native_writer, book_corrections, fetch_batch, make_packed_kernel,
    native_until_failback, pace, prepare_device, resolve_batch_kernel,
    resolve_device, strict_parity_enabled,
)
from .scenario import Simulation


def _check_compatible(cfgs: list[SimConfig]) -> None:
    if not cfgs:
        raise ValueError("run_fleet needs at least one scenario config")
    c0 = cfgs[0]
    if c0.backend not in DEVICE_BACKENDS:
        raise ValueError(
            "fleet mode is a batched device feature; backend must be "
            f"cuda or torch, got {c0.backend.name.lower()}"
        )
    for i, c in enumerate(cfgs):
        if c.interactive:
            raise ValueError(
                f"fleet member {i} sets interactive; mid-run command "
                "handling is per-scenario — run interactive scenarios "
                "through run_simulation"
            )
        if c.realtime != cfgs[0].realtime:
            raise ValueError(
                f"fleet member {i} disagrees with member 0 on realtime; "
                "a fleet paces as one pipeline — all members must share "
                "the flag"
            )
        for opt in ("profile_dir", "metrics_file"):
            if getattr(c, opt):
                raise ValueError(
                    f"fleet member {i} sets {opt}, which only the "
                    "single-scenario runner honors (run_app) — it would "
                    "be silently ignored here"
                )
        if c.checkpoint_file != cfgs[0].checkpoint_file:
            raise ValueError(
                f"fleet member {i} disagrees with member 0 on "
                "checkpoint_file: a fleet snapshots ALL members into ONE "
                "file (checkpoint.capture_fleet_state)"
            )
    noisy_seeds: dict[int, int] = {}
    for i, c in enumerate(cfgs):
        if c.noise_std_lsb > 0.0:
            if c.noise_seed in noisy_seeds:
                raise ValueError(
                    f"fleet members {noisy_seeds[c.noise_seed]} and {i} "
                    f"share noise_seed={c.noise_seed}: a farm must not "
                    "share one noise realization — give each noisy "
                    "member its own seed (member_configs derives "
                    "base.noise_seed + i automatically)"
                )
            noisy_seeds[c.noise_seed] = i
    for i, c in enumerate(cfgs[1:], 1):
        for field in ("sample_rate", "sample_format", "carrier_mode",
                      "backend", "device", "parity_exact", "num_channels"):
            if getattr(c, field) != getattr(c0, field):
                raise ValueError(
                    f"fleet member {i} differs from member 0 in {field}: "
                    f"{getattr(c, field)} != {getattr(c0, field)}; these "
                    "facts select the kernel's shape and device and must "
                    "match across the fleet"
                )


def _check_distinct_targets(cfgs: list[SimConfig]) -> None:
    """Default sinks must not alias: two members writing the same file (or
    TCP destination) would truncate and interleave one stream."""
    seen: dict[tuple, int] = {}
    for i, c in enumerate(cfgs):
        if c.sink == "iqfile":
            key = ("iqfile", c.out_file)
        elif c.sink == "tcp":
            key = ("tcp", c.tcp_addr)
        else:
            continue  # null/hardware sinks have no per-member target
        if key in seen:
            raise ValueError(
                f"fleet members {seen[key]} and {i} share the same "
                f"{key[0]} target {key[1]!r}; give each member its own "
                "out_file/tcp_addr (or pass explicit sinks)"
            )
        seen[key] = i


def parse_fleet_file(path: str) -> list[tuple]:
    """Parse a fleet roster CSV: ``lat,lon,height[,out_file]`` per line,
    ``#`` comments and blank lines ignored. Returns
    [(LocationConfig, out_file | None), ...]."""
    rows = []
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) not in (3, 4):
                raise ValueError(
                    f"{path}:{ln}: expected lat,lon,height[,out_file], "
                    f"got {raw.strip()!r}"
                )
            try:
                loc = LocationConfig(
                    float(parts[0]), float(parts[1]), float(parts[2])
                )
            except ValueError:
                raise ValueError(
                    f"{path}:{ln}: non-numeric lat/lon/height in "
                    f"{raw.strip()!r}"
                ) from None
            rows.append((loc, parts[3] if len(parts) == 4 else None))
    if not rows:
        raise ValueError(f"{path}: no fleet members found")
    return rows


def member_configs(base: SimConfig, rows: list[tuple]) -> list[SimConfig]:
    """Derive one SimConfig per roster row from a base config.

    Members vary in location (and optionally out_file); everything else —
    ephemeris, duration, rates, backend — comes from the base. Default
    out_file names insert a member index before the extension, and tcp
    members take consecutive ports from the base address, so targets
    never alias."""
    if base.sink not in ("iqfile", "null", "tcp"):
        raise ValueError(
            f"--fleet supports the iqfile, null, and tcp sinks, not "
            f"{base.sink!r} (per-member TX hardware needs the run_fleet "
            "API with explicit sinks)"
        )
    stem, ext = os.path.splitext(base.out_file)
    if base.sink == "tcp":
        host, _, port = base.tcp_addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"--fleet with -r tcp needs a host:port base address to "
                f"derive member ports from, got {base.tcp_addr!r}"
            )
    cfgs = []
    for i, (loc, out) in enumerate(rows):
        extra = {}
        if base.sink == "tcp":
            # Member i streams to base port + i (one receiver per port).
            extra["tcp_addr"] = f"{host}:{int(port) + i}"
        elif out is None:
            out = f"{stem}_m{i}{ext}"
        cfgs.append(dataclasses.replace(
            base, location=loc, out_file=out if out else base.out_file,
            # Independent noise per member (a farm must not share one
            # noise realization); each member still equals a solo run
            # with the same derived seed.
            noise_seed=base.noise_seed + i,
            **extra,
        ))
    return cfgs


def _interleave_plans(sims: list[Simulation]):
    """Round-robin (member_index, plan) across live scenario planners."""
    its = [sim.iter_plans() for sim in sims]
    live = list(range(len(sims)))
    while live:
        nxt = []
        for i in live:
            plan = next(its[i], None)
            if plan is None:
                continue
            nxt.append(i)
            yield i, plan
        live = nxt


def mesh_kernel(cfg: SimConfig) -> str:
    """The sharded synthesizer's kernel for a fleet config: the plain
    version for the torch backend; for cuda, K1's raw mode, or the
    two-stage path (producer + K2) under ``GPSSIM_FUSE_A=0``."""
    from .ops.synth_cuda import fuse_a_default

    if cfg.backend is SynthBackend.TORCH:
        return "torch"
    return "cuda-fused" if fuse_a_default() else "cuda"


def run_fleet(
    cfgs: list[SimConfig],
    sinks: list[Sink] | None = None,
    window: int | None = None,
    on_batch=None,
    stop=None,
    mesh=None,
    sims: list[Simulation] | None = None,
) -> list[RunStats]:
    """Run N scenarios through one shared batched device pipeline.

    Each member writes its quantized stream to its own sink (defaulting to
    the sink its config names, e.g. per-member --out-file paths). Returns
    per-member RunStats; the aggregate rate is their sum. on_batch(stats)
    is called after each drained batch with the per-member stats list;
    stop() → True aborts cleanly between batches.

    With ``cfgs[0].checkpoint_file`` set, the fleet snapshots every
    member's channel_t-schema state into ONE .npz (keys mN_*): written at
    every 30 s boundary of member 0's written signal, and finally at
    return — always from the drain-time capture, so a snapshot never runs
    ahead of the blocks actually at the sinks. Resume by loading the file
    with checkpoint.load_fleet_checkpoint and passing the restored
    ``sims`` here (the CLI does this for --resume of a fleet file); each
    member's resumed stream continues byte-identically.

    With ``mesh`` (parallel.shard.make_mesh), each fleet batch shards over
    the mesh's devices — blocks with no traffic between devices, channels
    summed as int32 on each block range's first device — and the bytes
    stay the same by the same integer-sum argument. Without it the batch
    runs on ``cfgs[0].device``.

    Realtime fleets (every member sets cfg.realtime, e.g. N paced TCP
    streams) pace the shared pipeline to wall clock on the slowest live
    member's written signal, bound each member's lead to the FIFO depth
    and keep the full channel axis, under the same RealtimeSupervisor as
    a single scenario: a sustained aggregate deficit attributed to
    synthesis fails the whole fleet over to the native sequential engine
    (the bytes stay the same), a DeviceProbe fails it back, and
    transport-bound deficits (some sink backlogged) are logged, never
    failed over. The supervisor's events, failovers, failbacks and
    failover latency are reported on member 0's stats.

    Each stage of a batch is a :func:`trace.span` under the batch's
    sequence number.
    """
    _check_compatible(cfgs)
    from .ops.args import collate_plans, pack_args
    from .trace import span

    cfg0 = cfgs[0]
    realtime = cfg0.realtime
    int_nco = cfg0.carrier_mode is CarrierMode.INT_NCO
    kernel, wide, n_rows, bits = resolve_batch_kernel(cfg0)
    if mesh is None:
        device = resolve_device(cfg0)  # no card for device="cuda" raises
        packed_kernel = make_packed_kernel(
            kernel, n_rows, cfg0.samples_per_epoch, bits, wide, device,
        )
    else:
        from .parallel.shard import make_sharded_synth, pad_batch, pad_channels

        nb, nc = mesh.shape["blocks"], mesh.shape["chan"]
        sharded = make_sharded_synth(
            mesh, n_rows, cfg0.samples_per_epoch, wide=wide, out_bits=bits,
            kernel=mesh_kernel(cfg0),
        )
    strict = strict_parity_enabled(cfg0)
    if strict:
        from .ops.synth_seq import correct_window
    if any(c.noise_std_lsb > 0.0 for c in cfgs):
        from .noise import apply_awgn

    if sims is None:
        sims = [Simulation(c) for c in cfgs]
    elif len(sims) != len(cfgs):
        raise ValueError(f"{len(sims)} restored sims for {len(cfgs)} configs")
    base_index = [s.next_block_index for s in sims]  # noise keying
    if sinks is None:
        _check_distinct_targets(cfgs)
        sinks = [make_configured_sink(c) for c in cfgs]
    if len(sinks) != len(cfgs):
        raise ValueError(f"{len(sinks)} sinks for {len(cfgs)} scenarios")

    # Fleet checkpointing: drain-time snapshots of every member into one
    # file (see docstring). fsnap() captures the state matching "all
    # plans handed out so far" — consistent with the written blocks once
    # the batch it was captured with drains.
    ckpt_path = cfg0.checkpoint_file
    if ckpt_path:
        from .checkpoint import capture_fleet_state, write_state

        def fsnap():
            return capture_fleet_state(
                sims, [s.next_block_index - 1 for s in sims]
            )
    else:
        fsnap = None
    consistent = None  # last drain-time fleet snapshot
    saved_tick = 0  # last 30 s-boundary tick written to disk

    def save_tick(blocks: int, snap) -> None:
        """Write ``snap()`` at each 30 s boundary of member 0's signal."""
        nonlocal saved_tick
        if blocks // 300 > saved_tick:
            saved_tick = blocks // 300
            write_state(ckpt_path, snap())

    # Batch width: one full round of the fleet per dispatch, or the
    # configured dispatch window if that is larger — whichever keeps the
    # device saturated. A realtime fleet instead bounds it so each member
    # runs at most fifo_depth blocks ahead of its written stream with two
    # batches in flight (the single-scenario bound, round-robin across
    # members). The launch shape is fixed after the first full batch;
    # short tails are padded (and dropped) like the single-scenario
    # runner's.
    if window is not None:
        W = window
    elif realtime:
        W = len(cfgs) * max(1, cfg0.fifo_depth // 2)
    else:
        W = max(cfg0.dispatch_blocks, len(cfgs))
    if mesh is not None:
        W += (-W) % nb  # full batches divide evenly over the blocks axis

    def window_batch(plans: list, pad: bool):
        if pad and len(plans) < W:
            plans = plans + [plans[-1]] * (W - len(plans))
        # Bucketed compaction: a fleet mixes scenarios, so the batch's
        # max-active count varies batch to batch; multiple-of-4 extents
        # bound the distinct launch shapes. A realtime fleet keeps the
        # full channel axis: one launch shape for the whole run.
        return collate_plans(plans, int_nco=int_nco, compact=not realtime,
                             compact_multiple=4)

    def batch_dispatch(batch):
        if mesh is None:
            packed, pspec = pack_args(batch)

            def dispatch(p=packed, s=pspec):
                return packed_kernel(p, s)
        else:
            # Short first batch (scenario set smaller than W with no later
            # full batch): pad blocks up to the mesh multiple; padding
            # rows are dropped at drain.
            margs, _ = pad_batch(pad_channels(batch.args, nc), nb)

            def dispatch(a=margs):
                return sharded(a)

        return dispatch

    def window_dispatch(plans: list, pad: bool):
        return batch_dispatch(window_batch(plans, pad))

    stats = [RunStats() for _ in cfgs]
    if realtime:
        # Blocks each member will actually produce: the planner's count
        # (a motion file shorter than duration_sec trims it below
        # cfg.num_epochs) — a member measured against the untrimmed total
        # would stay "live" forever and pin the fleet minimum.
        totals = [s.numd - 1 for s in sims]
        agg = RunStats()  # slowest-live-member view the supervisor watches
        supervisor = RealtimeSupervisor(
            cfg0, _FleetTransportView(sinks), agg
        )
        if mesh is None:
            prepare_device(cfg0, device, W)
        else:
            for dev in dict.fromkeys(d for row in mesh.devices for d in row):
                prepare_device(cfg0, dev, W // nb,
                               channels=-(-cfg0.num_channels // nc))
    t0 = time.perf_counter()
    it = _interleave_plans(sims)
    # (out, redispatch, [(member, plan)], snap, batch number)
    pending: deque = deque()
    any_full = False
    inited = 0
    live_ok = True  # live sim state corresponds to the written blocks
    if fsnap is not None:
        consistent = fsnap()  # pre-run state for a stop-before-drain
    try:
        for c, s in zip(cfgs, sinks):
            s.init(c)
            inited += 1
        for k in itertools.count():
            ts = time.perf_counter()
            with span("plan", k):
                tagged = list(itertools.islice(it, W))
            tp = time.perf_counter()
            if tagged:
                # Planning is a shared host pass; book it on member 0 so
                # sum(st.plan_seconds) stays meaningful.
                stats[0].plan_seconds += tp - ts
                with span("collate", k):
                    batch = window_batch([p for _, p in tagged],
                                         pad=any_full)
                    if batch.folds.any():
                        for (member, _), n in zip(tagged, batch.folds):
                            stats[member].gain_folds += int(n)
                with span("pack", k):
                    dispatch = batch_dispatch(batch)
                any_full = any_full or len(tagged) == W
                with span("launch", k):
                    out = dispatch()
                stats[0].synth_seconds += time.perf_counter() - tp
                snap = None
                if fsnap is not None:
                    with span("snapshot", k):
                        snap = fsnap()
                pending.append((out, dispatch, tagged, snap, k))
            if (not tagged and pending) or len(pending) >= 2:
                out, redispatch, done, snap, done_k = pending.popleft()
                tf = time.perf_counter()
                with span("wait", done_k):
                    host, retried = fetch_batch(out, redispatch)
                tc = time.perf_counter()
                stats[0].fetch_seconds += tc - tf
                stats[0].retries += retried  # one re-dispatch, booked once
                blocks = list(host[:len(done)])
                if strict:
                    with span("correct", done_k):
                        blocks, cands, patched = correct_window(
                            blocks, [p for _, p in done], bits, int_nco)
                    for (member, _), c, n in zip(done, cands, patched):
                        book_corrections(stats[member], c, n)
                stats[0].correct_seconds += time.perf_counter() - tc
                with span("sink", done_k):
                    for blk, (member, plan) in zip(blocks, done):
                        mc = cfgs[member]
                        if mc.noise_std_lsb > 0.0:
                            # Keyed per member stream so a fleet member's
                            # noisy bytes equal its solo run's.
                            blk = apply_awgn(
                                blk, bits, mc.noise_std_lsb, mc.noise_seed,
                                0, base_index[member] + stats[member].blocks,
                            )
                        sinks[member].write(blk)
                        st = stats[member]
                        st.blocks += 1
                        st.samples += plan.num_samples
                        st.wall_seconds = time.perf_counter() - t0
                if snap is not None:
                    consistent = snap  # matches the blocks just written
                    save_tick(stats[0].blocks, lambda: snap)
                if on_batch is not None:
                    with span("hook", done_k):
                        on_batch(stats)
                # Pace on the slowest LIVE member and watchdog it: members
                # that wrote their full scenario must not pin the minimum
                # (a frozen count would grow the lag without bound and
                # fire a spurious whole-fleet failover).
                live = (_live_min_blocks(stats, totals) if realtime
                        else None)
                verdict = None
                if live is not None:
                    agg.blocks = live
                    with span("pace", done_k):
                        pace(live, t0, cfg0.fifo_depth)
                        verdict = supervisor.check(t0)
                if verdict == "failover":
                    # Whole-fleet failover: write the in-flight batches'
                    # plans natively (never fetched through the deficient
                    # path) and carry the round-robin on the native engine
                    # while probing the device path for failback.
                    probe = None
                    if cfg0.failback_probe_sec > 0:
                        probe = DeviceProbe(
                            lambda plans: window_dispatch(plans, True)(),
                            W / len(cfgs), agg.events)
                    tail_ckpt = None
                    if fsnap is not None:
                        def tail_ckpt(blocks):
                            # called only with no probed plan buffered:
                            # the live state is the written state
                            save_tick(blocks, fsnap)
                    failed_back, snap = _fleet_native_tail(
                        cfgs, sinks, pending, it, stats, agg, t0,
                        base_index, on_batch, stop, time.perf_counter(),
                        totals, supervisor, probe, W, tail_ckpt,
                    )
                    if failed_back:
                        # every plan handed out is written: resume the
                        # batched fleet loop
                        if fsnap is not None:
                            consistent = fsnap()
                        continue
                    if snap is not None:
                        # stopped with batches unwritten
                        consistent, live_ok = snap, False
                    break
            if not tagged and not pending:
                break
            if stop is not None and stop():
                # Batches may be in flight: the live planners have run
                # ahead of the written blocks, so the final checkpoint
                # must come from the last drain-time snapshot.
                live_ok = False
                break
    finally:
        # End-of-stream on every sink first (non-blocking): close() below
        # flushes each paced sink at the DAC rate in turn, and a later
        # sink's pacer must not count that wait as underruns.
        for s in sinks[:inited]:
            s.end_stream()
        for s in sinks[:inited]:
            s.close()
    if fsnap is not None:
        # Final snapshot: live state when every handed-out plan was
        # written, else the last drain-time capture.
        write_state(ckpt_path, fsnap() if live_ok else consistent)
    wall = time.perf_counter() - t0
    for st, s in zip(stats, sinks):
        if st.blocks:
            st.wall_seconds = wall
        st.underruns = getattr(s, "underruns", 0)
    if realtime:
        # Surface the supervisor's verdicts on member 0 (the per-member
        # stats list is the return contract).
        stats[0].events.extend(agg.events)
        stats[0].failovers += agg.failovers
        stats[0].failbacks += agg.failbacks
        if stats[0].failover_latency_s is None:
            stats[0].failover_latency_s = agg.failover_latency_s
    return stats


def _live_min_blocks(stats, totals) -> int | None:
    """Slowest LIVE member's written-block count for fleet pacing and
    lag attribution; None once every member has written its full
    scenario (nothing left to pace or watchdog)."""
    live = [st.blocks for st, tot in zip(stats, totals) if st.blocks < tot]
    return min(live) if live else None


def probe_window_blocks(tagged) -> float:
    """Signal time, in blocks of 0.1 s, of a probe window of (member,
    plan) pairs: round-robin over the members actually in it, so a fleet
    whose members have finished is not judged by those members."""
    return len(tagged) / len({member for member, _ in tagged})


class _FleetTransportView:
    """Aggregate sink facade for the RealtimeSupervisor: a fleet is
    transport-bound when ANY member's sink is backlogged (that stream's
    consumer is below the DAC rate — a synthesis failover cannot help),
    and its underrun count is the fleet total."""

    def __init__(self, sinks):
        self._sinks = sinks

    @property
    def backlogged(self) -> bool:
        return any(getattr(s, "backlogged", False) for s in self._sinks)

    @property
    def underruns(self) -> int:
        return sum(getattr(s, "underruns", 0) for s in self._sinks)


def _fleet_native_tail(
    cfgs, sinks, pending, it, stats, agg, t0, base_index, on_batch, stop,
    t_act, totals, supervisor, probe, window, tail_ckpt=None,
) -> tuple[bool, dict | None]:
    """Carry a realtime fleet on the native sequential engine after a
    supervisor failover: first the in-flight batches' plans (device
    results left unread), then the remaining round-robin through the
    runner's :func:`native_until_failback` — the single-scenario failback
    policy — paced on the slowest live member, with hooks and the tail
    checkpoint once per fleet round.

    Returns (failed_back, snap). failed_back is True once a probe proved
    the device path healthy and every probed plan is written (the caller
    resumes the batched fleet loop from the next unwritten plan). snap is
    the drain-time snapshot of the written blocks when stop() ended the
    run with batches unwritten, else None (the live state is the written
    state). ``agg.blocks`` follows the slowest live member after every
    write, so the supervisor's flap accounting sees the real count.

    The per-block write path is the runner's _make_native_writer — one
    writer per member, the fleet aggregate carrying the recovery latency —
    so noise keying, accounting and the direct-int8 path cannot drift from
    the single-scenario failover."""
    cfg0 = cfgs[0]
    writers = [
        _make_native_writer(c, s, st, t0, bi, t_act, latency_stats=agg)
        for c, s, st, bi in zip(cfgs, sinks, stats, base_index)
    ]

    while pending:
        _out, _redispatch, done, snap, _k = pending.popleft()
        for member, plan in done:
            writers[member](plan)
        live = _live_min_blocks(stats, totals)
        if live is not None:
            agg.blocks = live
            pace(live, t0, cfg0.fifo_depth)
        if on_batch is not None:
            on_batch(stats)
        if stop is not None and stop():
            return False, snap if pending else None

    writes = 0

    def write_item(item) -> None:
        member, plan = item
        writers[member](plan)

    def after_item(_item, synced: bool) -> bool:
        nonlocal writes
        writes += 1
        live = _live_min_blocks(stats, totals)
        if live is not None:
            agg.blocks = live  # current for the supervisor's flap count
        if writes % len(cfgs):
            return False  # the rest once per fleet round
        if on_batch is not None:
            on_batch(stats)
        if stop is not None and stop():
            return True
        if live is not None:
            pace(live, t0, cfg0.fifo_depth)
        if tail_ckpt is not None and synced:
            tail_ckpt(stats[0].blocks)
        return False

    def start_probe(tagged) -> None:
        probe.start([p for _, p in tagged],
                    window_blocks=probe_window_blocks(tagged))

    return native_until_failback(
        it, write_item, after_item, supervisor, agg, probe, window,
        start_probe, items_per_tick=len(cfgs)), None
