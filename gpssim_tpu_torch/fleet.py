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
import os.path

from .config import LocationConfig, SimConfig, SynthBackend
from .io.sinks import Sink, make_configured_sink
from .runner import (
    DEVICE_BACKENDS, Member, RunStats, _packed_dispatch, _run_batched,
    dispatch_window, prepare_device, resolve_batch_kernel, resolve_device,
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
    """Run N scenarios through the window pipeline
    (``runner._run_batched``) as its members, in windows of
    ``runner.dispatch_window(cfgs, window)`` blocks.

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
    streams) pace on the slowest live member's written signal, fail over
    and back as a whole, and report the supervisor's verdicts on member
    0's stats.
    """
    _check_compatible(cfgs)
    cfg0 = cfgs[0]
    W = dispatch_window(cfgs, window)
    if mesh is None:
        device = resolve_device(cfg0)  # no card for device="cuda" raises
        dispatch = _packed_dispatch(cfg0, device)
    else:
        from .parallel.shard import make_sharded_synth, pad_batch, pad_channels

        _, wide, n_rows, bits = resolve_batch_kernel(cfg0)
        nb, nc = mesh.shape["blocks"], mesh.shape["chan"]
        sharded = make_sharded_synth(
            mesh, n_rows, cfg0.samples_per_epoch, wide=wide, out_bits=bits,
            kernel=mesh_kernel(cfg0),
        )
        W += (-W) % nb  # full batches divide evenly over the blocks axis

        def dispatch(batch):
            # Short first batch (scenario set smaller than W with no later
            # full batch): pad blocks up to the mesh multiple; padding
            # rows are dropped at drain.
            margs, _ = pad_batch(pad_channels(batch.args, nc), nb)
            return lambda: sharded(margs)

    if sims is None:
        sims = [Simulation(c) for c in cfgs]
    elif len(sims) != len(cfgs):
        raise ValueError(f"{len(sims)} restored sims for {len(cfgs)} configs")
    if sinks is None:
        _check_distinct_targets(cfgs)
        sinks = [make_configured_sink(c) for c in cfgs]
    if len(sinks) != len(cfgs):
        raise ValueError(f"{len(sinks)} sinks for {len(cfgs)} scenarios")
    members = [Member(c, sim, s) for c, sim, s in zip(cfgs, sims, sinks)]
    stats = [mb.stats for mb in members]
    # Blocks each member will actually produce: the planner's count (a
    # motion file shorter than duration_sec trims it below cfg.num_epochs)
    # — a member measured against the untrimmed total would stay "live"
    # forever and pin the fleet minimum.
    totals = [s.numd - 1 for s in sims]
    if cfg0.realtime:
        if mesh is None:
            prepare_device(cfg0, device, W)
        else:
            for dev in dict.fromkeys(d for row in mesh.devices for d in row):
                prepare_device(cfg0, dev, W // nb,
                               channels=-(-cfg0.num_channels // nc))

    # The fleet checkpoint (see docstring); ``consistent`` is None while the
    # live state is the written state.
    ckpt_path = cfg0.checkpoint_file
    snapshot = None
    consistent = None
    saved_tick = 0  # last 30 s-boundary tick written to disk
    if ckpt_path:
        from .checkpoint import capture_fleet_state, write_state

        def snapshot():
            return capture_fleet_state(
                sims, [s.next_block_index - 1 for s in sims]
            )

    def keep(snap) -> None:
        nonlocal consistent
        consistent = snap

    def written():
        return consistent if consistent is not None else snapshot()

    def hook(items, synced: bool) -> None:
        nonlocal saved_tick
        if ckpt_path and synced and stats[0].blocks // 300 > saved_tick:
            saved_tick = stats[0].blocks // 300
            write_state(ckpt_path, written())
        if on_batch is not None:
            on_batch(stats)

    _run_batched(members, _interleave_plans(sims), dispatch, W,
                 lambda: _live_min_blocks(stats, totals), keep, snapshot,
                 hook if ckpt_path or on_batch is not None else None, stop)
    if ckpt_path:
        write_state(ckpt_path, written())
    return stats


def _live_min_blocks(stats, totals) -> int | None:
    """Slowest LIVE member's written-block count for fleet pacing and
    lag attribution; None once every member has written its full
    scenario (nothing left to pace or watchdog). A member that has
    finished must not pin the minimum: its frozen count would grow the lag
    without bound and fire a spurious whole-fleet failover."""
    live = [st.blocks for st, tot in zip(stats, totals) if st.blocks < tot]
    return min(live) if live else None
