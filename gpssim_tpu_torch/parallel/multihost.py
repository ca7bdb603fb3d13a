"""Multi-process scaling: one scenario over several OS processes.

The counterpart of the JAX package's ``parallel/multihost.py``, which runs
``jax.distributed`` and one ``shard_map`` across a global mesh. Here every
process runs the same deterministic Simulation and plans the same timeline
(host planning is cheap, and it keeps the design stateless: no plan is
broadcast), and a global mesh is a small (blocks, chan) grid of
(rank, torch device) pairs:

* :func:`global_mesh`: the blocks axis spans the processes and the chan
  axis stays inside each one. Process p owns the same contiguous block
  rows as in the JAX layout, synthesizes them over its own local
  :class:`parallel.shard.Mesh` and streams them to its own part file. The
  blocks axis has no traffic between processes.
* :func:`global_mesh_chan_major`: one mesh column per process, so the
  channel sum crosses the process boundary. Each process makes the raw
  int16 rows of its channel range over every block; one ``all_reduce`` of
  the rows as int32 sums them, and the cast to int16 and the finalize
  follow. Integer sums commute with the int16 cast (parallel/shard.py), so
  the placement cannot change a byte.

Processes meet over ``torch.distributed`` (:func:`initialize`, an explicit
``tcp://`` address, world size and rank), as the JAX package's processes
meet over ``jax.distributed``. Ranks that name cards of their own
(``local_device_ids``, one or more per rank) form an NCCL group, and the
chan-major sum then reduces the rows in place on each rank's card, as the
JAX package's ``psum`` does on its chips. CPU ranks, and ranks that share
one card (NCCL refuses two ranks on one device), form a gloo group, which
sums host tensors: the rows go to a pinned host buffer and back.
"""

from __future__ import annotations

import json
from datetime import timedelta
from urllib.parse import urlsplit

import numpy as np
import torch
import torch.distributed as dist

from ..ops.args import ARG_ORDER
from .shard import Mesh, _shard, _to_device, raw_body

#: this rank's CUDA card indices in an NCCL group (``initialize``'s
#: ``local_device_ids``); None in a gloo group or before ``initialize``
_cards: list | None = None


def _card_key(index: int) -> str:
    """What names card ``index`` of this process uniquely on its machine
    and across machines (every process may number its cards from 0)."""
    return str(torch.cuda.get_device_properties(index).uuid)


def choose_backend(everyone: list) -> str:
    """The process group's backend from every rank's cards (a list of card
    keys per rank, None for a rank that named none): ``nccl`` when every
    rank names cards of its own, ``gloo`` when none does. Raises when the
    ranks disagree, or when two ranks name one card (NCCL would hang or
    fail on it at the first collective)."""
    named = [c is not None for c in everyone]
    if not any(named):
        return "gloo"
    if not all(named):
        raise ValueError(
            "ranks disagree on local_device_ids: ranks "
            f"{[r for r, n in enumerate(named) if n]} name cards, ranks "
            f"{[r for r, n in enumerate(named) if not n]} do not")
    owner = {}
    for rank, keys in enumerate(everyone):
        for key in keys:
            if key in owner:
                raise ValueError(
                    f"ranks {owner[key]} and {rank} both name card {key}: "
                    "an NCCL group needs a card of its own for every rank "
                    "(ranks that share one card leave out local_device_ids "
                    "and meet over gloo)")
            owner[key] = rank
    return "nccl"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_ids=None) -> str:
    """Join the process group (a no-op when this process has already
    joined); returns its backend. ``coordinator_address`` is
    ``tcp://host:port`` (a bare ``host:port`` is taken as tcp); every
    process gives the same address and world size and its own rank.

    ``local_device_ids`` are the CUDA cards this rank owns, as in
    ``jax.distributed.initialize``: :func:`local_devices` then returns
    those cards and no other, the rank's first card becomes its current
    device, and the group is NCCL. Without them the group is gloo. Before
    the group forms, every rank publishes its cards in the rendezvous
    store, and :func:`choose_backend` refuses two ranks on one card, or
    ranks that disagree, on every rank alike: nothing falls back from
    NCCL to gloo."""
    global _cards
    if dist.is_initialized():
        return dist.get_backend()
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    url = urlsplit(coordinator_address)
    store = dist.TCPStore(url.hostname, url.port, num_processes,
                          is_master=process_id == 0,
                          timeout=timedelta(seconds=300))
    cards = keys = None
    if local_device_ids is not None:
        from ..runner import torch_device

        torch_device("cuda")  # without a card it raises
        cards = [int(i) for i in local_device_ids]
        count = torch.cuda.device_count()
        if not cards or any(not 0 <= i < count for i in cards):
            raise ValueError(f"local_device_ids={cards}: {count} cards "
                             "visible")
        keys = [_card_key(i) for i in cards]
    store.set(f"gpssim/cards/{process_id}", json.dumps(keys))
    everyone = [json.loads(store.get(f"gpssim/cards/{r}"))
                for r in range(num_processes)]
    # rank 0 serves the store: it waits until every rank has read every
    # rank's cards, so that its refusal cannot close the store under them
    store.set(f"gpssim/read/{process_id}", "1")
    if process_id == 0:
        store.wait([f"gpssim/read/{r}" for r in range(num_processes)])
    backend = choose_backend(everyone)
    if backend == "nccl":
        # all_gather_object stages on the current device under NCCL
        torch.cuda.set_device(cards[0])
    print(f"multihost: rank {process_id} of {num_processes} joins over "
          f"{backend}" + (f" on cuda:{cards}" if cards else ""), flush=True)
    dist.init_process_group(backend=backend, store=store,
                            world_size=num_processes, rank=process_id)
    _cards = cards
    return backend


def shutdown() -> None:
    """Leave the process group :func:`initialize` joined (a no-op when
    there is none)."""
    global _cards
    if dist.is_initialized():
        dist.destroy_process_group()
    _cards = None


def local_devices(device="cuda") -> list:
    """This process's devices: for ``cuda``, the cards it named in
    :func:`initialize` (``local_device_ids``), else every CUDA device
    (without a card it raises); otherwise the one device named."""
    from ..runner import torch_device

    dev = torch_device(device)
    if dev.type == "cuda" and dev.index is None:
        ids = (_cards if _cards is not None
               else range(torch.cuda.device_count()))
        return [torch.device("cuda", i) for i in ids]
    return [dev]


class GlobalMesh:
    """A (blocks, chan) grid of (rank, device) over every process.

    ``local`` is the :class:`parallel.shard.Mesh` of this process's rows
    (:func:`global_mesh`), or None where this process holds no whole row
    (a chan-major mesh)."""

    def __init__(self, grid):
        self.devices = grid
        self.shape = {"blocks": len(grid), "chan": len(grid[0])}
        rank = dist.get_rank()
        mine = [[d for _, d in row] for row in grid
                if all(r == rank for r, _ in row)]
        self.local = Mesh(mine) if mine else None


def _all_devices(devices) -> list:
    """Every process's local devices, grouped by rank: (rank, device)."""
    devices = [torch.device(d) for d in devices]
    if _cards is not None:
        foreign = [str(d) for d in devices
                   if d.type != "cuda" or d.index not in _cards]
        if foreign:
            raise ValueError(f"devices {foreign} are not among this rank's "
                             f"cards {_cards} (local_device_ids)")
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, [str(d) for d in devices])
    if len({len(v) for v in everyone}) != 1:
        raise ValueError(f"processes hold different device counts: "
                         f"{[len(v) for v in everyone]}")
    return [(r, torch.device(d)) for r, names in enumerate(everyone)
            for d in names]


def global_mesh(chan_shards: int = 1, devices=None) -> GlobalMesh:
    """(blocks, chan) mesh over ALL processes' devices.

    ``devices`` are this process's (default :func:`local_devices`); every
    process must hold as many. Devices are taken grouped by process, so
    the chan axis — the only axis with a sum — stays within a process as
    long as chan_shards divides the local device count."""
    devices = local_devices() if devices is None else list(devices)
    if len(devices) % chan_shards != 0:
        raise ValueError(
            f"chan_shards={chan_shards} must divide local devices "
            f"{len(devices)} so the channel sum stays in the process"
        )
    flat = _all_devices(devices)
    return GlobalMesh([flat[i:i + chan_shards]
                       for i in range(0, len(flat), chan_shards)])


def global_mesh_chan_major(devices=None) -> GlobalMesh:
    """(blocks, chan) mesh whose CHAN axis spans processes — one mesh
    column per process — so the channel sum crosses the process boundary
    instead of staying process-local.

    Production meshes keep the sum inside a process (:func:`global_mesh`);
    this layout certifies that the sum is bit-exact across processes too
    (it is integer, so placement cannot change it)."""
    devices = local_devices() if devices is None else list(devices)
    flat = _all_devices(devices)
    n_local = len(devices)
    n_proc = len(flat) // n_local
    # rows (blocks axis) are local-device indices, columns processes
    return GlobalMesh([[flat[p * n_local + i] for p in range(n_proc)]
                       for i in range(n_local)])


def synthesize_chan_major(
    batch: dict, mesh: GlobalMesh, n_rows: int, num_samples: int,
    wide: bool = False, out_bits: int = 16, kernel: str = "cuda-fused",
) -> np.ndarray:
    """Synthesize one batch over a chan-major mesh (process-spanning
    channel sum, see :func:`global_mesh_chan_major`).

    Every process holds the full deterministic batch (same planning
    everywhere) and makes the raw rows of its own channel range over all
    blocks, split over its local devices (``kernel``: K1's raw mode, the
    two-stage path, or the plain version; CPU devices run the plain
    versions). One ``all_reduce`` of the rows as int32 sums them over the
    processes (:func:`sum_over_processes`: on the card under NCCL, on the
    host under gloo), and each process casts the sum to int16 and
    finalizes it on its first device. Returns the complete quantized batch
    on every process."""
    from ..ops.synth_torch import finalize_rows

    raw = raw_body(kernel)
    nb, nc = mesh.shape["blocks"], mesh.shape["chan"]
    B, C = batch["gain_a"].shape
    if B % nb or C % nc:
        raise ValueError(f"batch of {B} blocks x {C} channels does not "
                         f"split over a {nb}x{nc} mesh (pad_batch, "
                         "pad_channels)")
    bs, cs = B // nb, C // nc
    rank = dist.get_rank()
    col = [j for j in range(nc) if mesh.devices[0][j][0] == rank]
    if len(col) != 1 or any(mesh.devices[i][col[0]][0] != rank
                            for i in range(nb)):
        raise ValueError("a chan-major mesh gives each process one column")
    chans = slice(col[0] * cs, (col[0] + 1) * cs)
    parts = []
    for i in range(nb):
        dev = mesh.devices[i][col[0]][1]
        parts.append(torch.stack(raw(
            _to_device(_shard(batch, slice(i * bs, (i + 1) * bs), chans),
                       dev), n_rows, wide)))
    summed = sum_over_processes(parts, mesh.devices[0][col[0]][1])
    return finalize_rows(summed[0], summed[1], num_samples,
                         out_bits).cpu().numpy()


def sum_over_processes(parts: list, dev0, group=None) -> torch.Tensor:
    """The modular sum over the processes of ``group`` (default: every
    process) of this process's raw rows: ``parts`` are int16 (2, b,
    R_pad, 128), concatenated on the block axis; the int16 sum (2, B,
    R_pad, 128) comes back on ``dev0``.

    NCCL has no int16 sum, so the rows are summed as int32 and cast back:
    the cast of the int32 sum is the int16 sum (int16 truncation is a ring
    homomorphism), so the placement cannot change a byte. Under NCCL the
    int32 rows are reduced in place on ``dev0`` (the rank's card); under
    gloo they go to a pinned host buffer (a plain one without a card) and
    back. Only the buffer's device differs."""
    on_card = dist.get_backend(group) == "nccl"
    where = dev0 if on_card else torch.device("cpu")
    B = sum(p.shape[1] for p in parts)
    rows = torch.empty((2, B, *parts[0].shape[2:]), dtype=torch.int32,
                       device=where,
                       pin_memory=not on_card and dev0.type == "cuda")
    b = 0
    for p in parts:
        rows[:, b:b + p.shape[1]].copy_(p)
        b += p.shape[1]
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    return rows.to(dev0).to(torch.int16)


def process_block_slice(n_blocks: int, mesh: GlobalMesh) -> slice:
    """The contiguous block range this process owns on the blocks axis.

    n_blocks must be padded to a multiple of the mesh blocks dimension
    (see shard.pad_batch)."""
    blocks_dim = mesh.shape["blocks"]
    if n_blocks % blocks_dim != 0:
        raise ValueError(
            f"n_blocks={n_blocks} must be padded to a multiple of the mesh "
            f"blocks dimension {blocks_dim} (shard.pad_batch)"
        )
    per_shard = n_blocks // blocks_dim
    # Rows of the mesh owned by this process, in device order.
    pid = dist.get_rank()
    rows = [i for i in range(blocks_dim) if mesh.devices[i][0][0] == pid]
    if not rows or rows != list(range(rows[0], rows[0] + len(rows))):
        raise ValueError("process's mesh rows must be contiguous")
    return slice(rows[0] * per_shard, (rows[-1] + 1) * per_shard)


def scatter_batch(batch: dict, mesh: GlobalMesh) -> dict:
    """This process's block slice of the full batch.

    Every process passes the SAME full batch (deterministic planning) and
    keeps its own block range; nothing crosses between processes."""
    sl = process_block_slice(batch["gain_a"].shape[0], mesh)
    return {k: np.ascontiguousarray(batch[k][sl]) for k in ARG_ORDER}


def synthesize_multihost(
    batch: dict, mesh: GlobalMesh, n_rows: int, num_samples: int,
    wide: bool = False, out_bits: int = 16, fn=None,
    kernel: str = "cuda-fused",
) -> tuple[np.ndarray, slice]:
    """Run the sharded synthesizer on this process's share of the mesh.

    Returns (local_blocks, block_slice): the IQ blocks this process owns
    (int16, or int8 with out_bits=8) and where they sit in the global
    batch. Pass a prebuilt ``fn`` (shard.make_sharded_synth over
    ``mesh.local``) when calling in a loop. ``kernel`` selects the
    per-device body (shard.make_sharded_synth)."""
    from .shard import make_sharded_synth

    if mesh.local is None:
        raise ValueError("this process owns no whole row of the mesh")
    if fn is None:
        fn = make_sharded_synth(mesh.local, n_rows, num_samples, wide=wide,
                                out_bits=out_bits, kernel=kernel)
    sl = process_block_slice(batch["gain_a"].shape[0], mesh)
    local = fn(scatter_batch(batch, mesh)).result()
    if local.shape[0] != sl.stop - sl.start:
        raise RuntimeError(
            f"assembled {local.shape[0]} local blocks, process slice "
            f"expects {sl.stop - sl.start}"
        )
    return local, sl


def run_scenario_multihost(
    cfg, chan_shards: int = 1, window_blocks: int = 64,
    kernel: str | None = None, devices=None,
) -> str:
    """Full scenario across all processes → per-process part file + index.

    Every process plans the same deterministic scenario, synthesizes its
    share of each window over the global mesh (``devices``: this process's,
    default :func:`local_devices` of ``cfg.device``), and streams its
    (quantized) blocks to ``{out_file}.part{pid}`` with a JSON index of
    global block ranges. ``merge_parts`` assembles the reference-
    compatible stream. :func:`initialize` must have run first."""
    import itertools
    import json

    from ..config import CarrierMode
    from ..fleet import mesh_kernel
    from ..ops.args import LANES, collate_plans, needs_wide_window
    from ..runner import strict_parity_enabled
    from ..scenario import Simulation
    from .shard import make_sharded_synth, pad_batch, pad_channels

    strict = strict_parity_enabled(cfg)
    if cfg.parity_exact and not strict:
        # Availability of the native sequential engine may differ between
        # hosts; a process quietly falling back to closed-form output
        # would corrupt the merged stream (parts disagree at the sparse
        # correction samples). Fail loudly instead — deterministically on
        # every process that lacks the engine.
        raise RuntimeError(
            "parity_exact multihost run requires the native sequential "
            "engine on every process (tools/build_native.sh), or set "
            "parity_exact=False"
        )
    if strict:
        from ..ops.synth_seq import apply_corrections, seq_corrections
    if cfg.noise_std_lsb > 0.0:
        from ..noise import apply_awgn
    if devices is None:
        devices = local_devices(cfg.device)
    mesh = global_mesh(chan_shards, devices)
    sim = Simulation(cfg)
    n_rows = -(-cfg.samples_per_epoch // LANES)
    bits = cfg.sample_format.value
    int_nco = cfg.carrier_mode is CarrierMode.INT_NCO
    wide = needs_wide_window(1.0 / cfg.sample_rate)
    # One synthesizer for the whole run; the config's backend picks the
    # mesh kernel unless overridden.
    fn = make_sharded_synth(
        mesh.local, n_rows, cfg.samples_per_epoch, wide=wide, out_bits=bits,
        kernel=kernel or mesh_kernel(cfg),
    )

    pid = dist.get_rank()
    part = f"{cfg.out_file}.part{pid}"
    ranges = []
    it = sim.iter_plans()
    base = 0
    # Noise keying must match the single-host runner byte-for-byte:
    # absolute epoch index = planner cursor at entry + global position.
    index0 = sim.next_block_index
    with open(part, "wb") as fp:
        while True:
            plans = list(itertools.islice(it, window_blocks))
            if not plans:
                break
            batch = collate_plans(plans, int_nco=int_nco)
            padded = pad_channels(batch.args, chan_shards)
            padded, pad = pad_batch(padded, mesh.shape["blocks"])
            local, sl = synthesize_multihost(
                padded, mesh, n_rows, batch.num_samples, fn=fn
            )
            # Drop padding blocks and record the global range this
            # process wrote for this window (blocks are quantized on
            # device: out_bits=bits halves the transfer for int8).
            lo = base + sl.start
            hi = min(base + sl.stop, base + len(plans))
            if hi > lo:
                out = local[: hi - lo]
                if strict:
                    # Strict sequential parity, same as the single-host
                    # runner: patch the sparse closed-form quantization
                    # flips of this process's own blocks.
                    out = np.ascontiguousarray(out)
                    for k in range(hi - lo):
                        plan = plans[sl.start + k]
                        idx_c, i16, q16, _, _ = seq_corrections(
                            plan, int_nco=int_nco
                        )
                        apply_corrections(out[k], bits, idx_c, i16, q16)
                if cfg.noise_std_lsb > 0.0:
                    out = np.ascontiguousarray(out)
                    for k in range(hi - lo):
                        out[k] = apply_awgn(
                            out[k], bits, cfg.noise_std_lsb,
                            cfg.noise_seed, 0, index0 + lo + k,
                        )
                out.tofile(fp)
                ranges.append([lo, hi])
            base += len(plans)
    with open(f"{part}.idx", "w") as fp:
        json.dump({"ranges": ranges, "total_blocks": base,
                   "samples_per_block": cfg.samples_per_epoch,
                   "bits": bits}, fp)
    return part


def merge_parts(out_file: str, n_parts: int) -> str:
    """Assemble part files (written by run_scenario_multihost) into the
    single interleaved IQ stream the reference produces."""
    import json

    segs = []
    total_blocks = None
    for pid in range(n_parts):
        part = f"{out_file}.part{pid}"
        with open(f"{part}.idx") as fp:
            idx = json.load(fp)
        total_blocks = idx["total_blocks"]
        dtype = np.int8 if idx["bits"] == 8 else np.int16
        blk = 2 * idx["samples_per_block"]
        data = np.fromfile(part, dtype=dtype)
        n_idx = sum(hi - lo for lo, hi in idx["ranges"])
        if data.size != n_idx * blk:
            raise ValueError(
                f"{part}: {data.size} values on disk, index claims {n_idx} "
                "blocks (truncated part file?)"
            )
        data = data.reshape(-1, blk)
        pos = 0
        for lo, hi in idx["ranges"]:
            segs.append((lo, data[pos : pos + (hi - lo)]))
            pos += hi - lo
    segs.sort(key=lambda s: s[0])
    with open(out_file, "wb") as fp:
        expect = 0
        for lo, d in segs:
            if lo != expect:
                raise ValueError(f"gap at block {expect}")
            d.tofile(fp)
            expect = lo + d.shape[0]
    if expect != total_blocks:
        raise ValueError(
            f"stream ends at block {expect}, scenario has {total_blocks} "
            "(missing trailing part data)"
        )
    return out_file
