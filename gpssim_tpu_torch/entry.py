"""Entry points: the flagship synthesis step and a multi-device dry run.

The counterpart of the JAX package's ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, example_args)`` for the flagship step: K1
  (``ops/synth_cuda.synth_blocks_batch_cuda``) over the first 4 blocks of
  a 0.5 s fixture scenario at the 300,000-sample block shape, its args on
  the card; with ``device="cpu"`` the plain version over the same batch.
* :func:`dryrun_multichip` certifies the mesh path end to end in nine
  passes over ``n`` distinct cards (``cuda:0`` .. ``cuda:n-1``; fewer
  visible raise, as the JAX package's dry run asserts its device count),
  each bit-identical to this package's own references
  (``ops/synth_numpy``; the native engine for the strict multi-process
  streams). An explicit ``devices`` list may repeat one card, or the CPU
  (``device="cpu"``), so one card is enough for it.

Run it as ``python -m gpssim_tpu_torch.entry`` (one call of ``fn``) or
``python -m gpssim_tpu_torch.entry dryrun N [--device cpu]``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")


def _make_plans(sample_rate: int, duration_sec: float, num_channels: int = 12):
    from .config import SimConfig
    from .scenario import Simulation

    nav = os.path.join(FIXTURES, "brdc_test.22n")
    if not os.path.exists(nav):
        subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "make_fixtures.py")],
            check=True,
        )
    cfg = SimConfig(
        nav_file=nav,
        duration_sec=duration_sec,
        almanac_enable=False,
        sample_rate=sample_rate,
        num_channels=num_channels,
    )
    sim = Simulation(cfg)
    return list(sim.iter_plans()), cfg


def entry(device="cuda"):
    """(fn, example_args) for the flagship synthesis step.

    ``fn(*example_args)`` synthesizes 4 blocks of the 0.5 s fixture
    scenario at 3 Msps (300,000 samples per block) into int16
    [4, 600000]. On a CUDA ``device`` (the default; without a card it
    raises) that is one launch of K1 with its args on the card; on the
    CPU it is K1's plain version, the same bytes."""
    import functools

    from .ops.args import ARG_ORDER, LANES, collate_plans, to_device
    from .ops.synth_cuda import synth_blocks_batch_cuda
    from .ops.synth_torch import synth_blocks_batch_torch
    from .runner import torch_device

    dev = torch_device(device)
    plans, cfg = _make_plans(sample_rate=3_000_000, duration_sec=0.5)
    n_rows = -(-cfg.samples_per_epoch // LANES)
    batch = collate_plans(plans[:4])
    if dev.type == "cuda":
        kernel = functools.partial(synth_blocks_batch_cuda, fuse_a=True)
    else:
        kernel = synth_blocks_batch_torch
    args = to_device(batch.args, dev)

    def fn(*example_args):
        return kernel(dict(zip(ARG_ORDER, example_args)), n_rows=n_rows,
                      num_samples=cfg.samples_per_epoch)

    return fn, tuple(args[k] for k in ARG_ORDER)


def _default_kernel(dev) -> str:
    """The device's default mesh kernel: K1's raw mode on a card, the
    plain version on the CPU."""
    return "cuda-fused" if dev.type == "cuda" else "torch"


def _mesh_pass(mesh, plans, n_rows: int, num_samples: int, kernel: str,
               wide: bool = False) -> None:
    """One batch of ``plans`` through ``make_sharded_synth`` over ``mesh``,
    held against ``synth_block_numpy`` of every plan."""
    from .ops.args import collate_plans
    from .ops.synth_numpy import synth_block_numpy
    from .parallel.shard import make_sharded_synth, pad_batch, pad_channels

    batch = collate_plans(plans)
    padded = pad_channels(batch.args, mesh.shape["chan"])
    padded, pad = pad_batch(padded, mesh.shape["blocks"])
    fn = make_sharded_synth(mesh, n_rows, num_samples, wide=wide,
                            kernel=kernel)
    out = fn(padded).result()
    if pad:
        out = out[:-pad]
    ref = np.stack([synth_block_numpy(p) for p in plans])
    if out.shape != ref.shape or not np.array_equal(out, ref):
        raise AssertionError(
            f"mesh {mesh.shape} kernel {kernel} ({num_samples} samples/"
            f"block): output != sequential reference")


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> dict:
    """The sharded synthesis step over an ``n_devices`` mesh.

    The mesh's devices: ``devices`` when given (``n_devices`` of them; a
    device may repeat, e.g. ``["cuda:0"] * 2`` on one card); else, for
    ``device="cuda"`` (the default), ``n_devices`` distinct cards
    ``cuda:0`` .. ``cuda:n-1``, raising where fewer are visible; for
    ``device="cpu"``, the CPU ``n_devices`` times. Certifies the mesh path
    end to end:
      1. tiny-shape pass on the primary (blocks x chan) layout, the
         device's default mesh kernel (K1's raw mode on a card);
      2. the wide-window variant (low sample rates);
      3. the two-stage path (``kernel="cuda"``: producer and K2);
      4. a second mesh layout (chan=4; the devices cycled to four where
         n_devices is not a multiple of 4);
      5. FULL 300,000-sample blocks on the primary layout;
      6. the two-stage path at that FULL block shape;
      7. a fleet batch (two interleaved scenarios) through the sharded
         path via run_fleet(mesh=...);
      8. a two-process run (``parallel/multihost``) whose merged stream
         equals a single-process native run;
      9. a FOUR-process run on a chan-major global mesh — the channel sum
         crosses every process boundary — with all four processes'
         streams identical to the single-process native run.
    Passes 8 and 9 give each child process cards of its own
    (``local_device_ids``, an NCCL group) where there are at least as many
    distinct cards as children, and otherwise share them over gloo (the
    CPU, or one card named several times). Every pass must be
    bit-identical to its reference. Returns the passes run, each pass's
    wall seconds, each multi-process pass's backend and the child
    processes' K1/K2 launch counts (passes 8 and 9), summed."""
    import dataclasses
    import tempfile

    import torch

    from .config import LocationConfig, SimConfig, SynthBackend
    from .fleet import run_fleet
    from .ops.args import LANES
    from .parallel.shard import make_mesh
    from .runner import run_simulation, torch_device

    if devices is not None:
        devices = [torch_device(d) for d in devices]
        if len(devices) != n_devices:
            raise ValueError(f"{len(devices)} devices for a dry run over "
                             f"{n_devices}")
    else:
        dev = torch_device(device)
        if dev.type == "cpu":
            devices = [dev] * n_devices
        else:
            if dev.index is not None and n_devices > 1:
                raise ValueError(
                    f"device={device!r} names one card; pass devices="
                    f"['{dev}'] * {n_devices} to repeat it")
            visible = torch.cuda.device_count()
            if visible < n_devices:
                raise RuntimeError(
                    f"dryrun_multichip({n_devices}) needs {n_devices} "
                    f"distinct cards, {visible} visible; pass devices=[...] "
                    "to repeat one")
            devices = [torch.device("cuda", i) for i in range(n_devices)]
    dev = devices[0]
    default = _default_kernel(dev)
    walls = {}

    def timed(name, run):
        t = time.perf_counter()
        run()
        walls[name] = time.perf_counter() - t

    # Tiny shapes: real 3 Msps plans (the kernel's ≤1-code-wrap-per-row
    # invariant needs ≥ ~380 sps per chip), but synthesize only a
    # 256-sample prefix of each block.
    tiny = 256
    plans, cfg = _make_plans(sample_rate=3_000_000,
                             duration_sec=0.1 * (n_devices + 1))
    full_plans = list(plans)  # the same plans; resized for pass 5
    for p in plans:
        p.num_samples = tiny
    n_rows = -(-tiny // LANES)

    chan_shards = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices // chan_shards, chan_shards, devices=devices)
    timed("tiny", lambda: _mesh_pass(mesh, plans, n_rows, tiny, default))

    # Wide-window variant (sample rates below ~2.06 Msps use the 128-chip
    # four-word kernel): must shard bit-identically too.
    plans_w, _ = _make_plans(sample_rate=2_046_000,
                             duration_sec=0.1 * (n_devices + 1))
    for p in plans_w:
        p.num_samples = tiny
    timed("wide-window", lambda: _mesh_pass(mesh, plans_w, n_rows, tiny,
                                            default, wide=True))
    timed("two-stage-mesh", lambda: _mesh_pass(mesh, plans, n_rows, tiny,
                                               "cuda"))
    # the devices cycled to a multiple of 4, so the chan=4 layout runs at
    # any n
    n4 = n_devices if n_devices % 4 == 0 else 4
    mesh4 = make_mesh(n4 // 4, 4,
                      devices=[devices[i % n_devices] for i in range(n4)])
    timed("chan4-mesh", lambda: _mesh_pass(mesh4, plans, n_rows, tiny,
                                           default))

    full = cfg.samples_per_epoch
    for p in full_plans:
        p.num_samples = full
    n_rows_full = -(-full // LANES)
    timed(f"full-{full}-sample-blocks", lambda: _mesh_pass(
        mesh, full_plans, n_rows_full, full, default))
    timed("two-stage-full-block", lambda: _mesh_pass(
        mesh, full_plans, n_rows_full, full, "cuda"))

    def fleet_pass():
        with tempfile.TemporaryDirectory() as td:
            members = []
            for i, loc in enumerate((LocationConfig(30.0, 120.0, 10.0),
                                     LocationConfig(30.1, 120.1, 20.0))):
                members.append(SimConfig(
                    nav_file=os.path.join(FIXTURES, "brdc_test.22n"),
                    duration_sec=0.1 * n_devices, almanac_enable=False,
                    location=loc, out_file=os.path.join(td, f"m{i}.bin"),
                    parity_exact=False, device=str(dev),
                    backend=(SynthBackend.CUDA if dev.type == "cuda"
                             else SynthBackend.TORCH),
                ))
            run_fleet(members, mesh=mesh)
            for i, m in enumerate(members):
                solo = dataclasses.replace(
                    m, out_file=os.path.join(td, f"s{i}.bin"),
                    backend=SynthBackend.NUMPY)
                run_simulation(solo)
                with open(m.out_file, "rb") as fa, \
                        open(solo.out_file, "rb") as fb:
                    if fa.read() != fb.read():
                        raise AssertionError(f"fleet member {i} != solo run")

    timed("fleet-mesh", fleet_pass)

    launches = {"K1": 0, "K2": 0}
    backends = {}
    if n_devices >= 2:
        _prepare_children(devices)
        for name, run in (("multiproc-dcn", _dryrun_multiproc_dcn),
                          ("multiproc-dcn4", _dryrun_multiproc_dcn4)):
            t = time.perf_counter()
            res = run(devices)
            backends[name] = res["backend"]
            for k in launches:
                launches[k] += res["launches"][k]
            walls[name] = time.perf_counter() - t

    print(
        f"dryrun_multichip OK on {', '.join(map(str, devices))}: mesh "
        f"{mesh.shape} blocks={len(plans)} samples/block={tiny} "
        f"(+{' +'.join(list(walls)[1:])} passes; children over "
        f"{backends or 'none'})"
    )
    return dict(passes=list(walls), wall_s=walls, child_launches=launches,
                child_backends=backends)


def _prepare_children(devices) -> None:
    """Build the native engines and, on a card, load K1 and K2 before the
    children start, so that none of them builds either itself."""
    from .ops.args import load_engine
    from .ops.synth_seq import seq_available

    if not seq_available():
        raise RuntimeError("the multi-process passes need the native "
                           "engine (tools/build_native.sh)")
    load_engine()
    if any(d.type == "cuda" for d in devices):
        from .ops.synth_cuda import _kernel, _kernel_k2

        _kernel()
        _kernel_k2()


def child_layout(devices, n_proc: int, per_child: int) -> list:
    """Each child's ``[local_device_ids, mesh devices]`` for a
    multi-process pass over ``devices`` (the dry run's): with at least
    ``n_proc`` distinct cards, child r owns an equal share of them
    (``local_device_ids``, so the children form an NCCL group) and cycles
    its own cards to ``per_child`` mesh devices; otherwise the children
    share the devices (the CPU, or too few cards) over gloo, child r
    naming device ``r % len`` ``per_child`` times."""
    import torch

    distinct = list(dict.fromkeys(torch.device(d) for d in devices))
    cards = [d.index for d in distinct if d.type == "cuda"]
    if len(cards) == len(distinct) and len(cards) >= n_proc:
        k = len(cards) // n_proc
        return [[cards[r * k:(r + 1) * k],
                 [f"cuda:{cards[r * k + i % k]}" for i in range(per_child)]]
                for r in range(n_proc)]
    return [[None, [str(distinct[r % len(distinct)])] * per_child]
            for r in range(n_proc)]


_CHILD_HEAD = """
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
rank = int(sys.argv[1])
cards, devices = json.loads({layout!r})[rank]
if devices[0] == "cpu":
    torch.set_num_threads(1)
from gpssim_tpu_torch.ops import synth_cuda
from gpssim_tpu_torch.parallel import multihost
backend = multihost.initialize({coord!r}, {n_proc}, rank,
                               local_device_ids=cards)
from gpssim_tpu_torch.config import SimConfig
"""

_CHILD_TAIL = """
multihost.shutdown()
print(json.dumps({{"launches": synth_cuda.launches, "backend": backend}}))
"""

_MH_CHILD = _CHILD_HEAD + """
cfg = SimConfig(
    nav_file=os.path.join({repo!r}, "fixtures", "brdc_test.22n"),
    duration_sec=0.5, almanac_enable=False, out_file={out!r},
    device=devices[0],
)
multihost.run_scenario_multihost(cfg, chan_shards=2, window_blocks=4,
                                 devices=devices)
""" + _CHILD_TAIL

_MH4_CHILD = _CHILD_HEAD + """
import numpy as np
from gpssim_tpu_torch.ops.args import LANES, collate_plans
from gpssim_tpu_torch.ops.synth_seq import (
    apply_corrections, seq_corrections_window,
)
from gpssim_tpu_torch.scenario import Simulation

cfg = SimConfig(
    nav_file=os.path.join({repo!r}, "fixtures", "brdc_test.22n"),
    duration_sec=0.5, almanac_enable=False,
)
plans = list(Simulation(cfg).iter_plans())
batch = collate_plans(plans, compact=False)  # 12 channels / 4 processes
mesh = multihost.global_mesh_chan_major(devices)
assert mesh.shape == {{"blocks": 2, "chan": 4}}, mesh.shape
out = multihost.synthesize_chan_major(
    batch.args, mesh, -(-cfg.samples_per_epoch // LANES),
    cfg.samples_per_epoch, out_bits=8,
)[: batch.n_blocks]
corrs = seq_corrections_window(plans)
stream = np.concatenate([
    apply_corrections(out[i].copy(), 8, *corrs[i])
    for i in range(batch.n_blocks)
])
stream.tofile({out!r} + ".p" + sys.argv[1])
""" + _CHILD_TAIL


def run_children(script: str, n: int, timeout: float = 600.0) -> list:
    """Start ``n`` copies of ``script`` (rank as argv[1]) together; wait for
    all, killing the rest as soon as one fails. Returns each child's last
    stdout line, parsed as JSON."""
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(rank)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO)
        for rank in range(n)
    ]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"children still running after "
                                   f"{timeout:g} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate() for p in procs]
    for rank, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"child {rank} of {n} exited {p.returncode}"
                               f"\nstdout:\n{o[-2000:]}\nstderr:\n"
                               f"{e[-3000:]}")
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _native_reference(path: str) -> np.ndarray:
    """The 0.5 s fixture scenario's bytes from one native-engine process."""
    from .config import SimConfig, SynthBackend
    from .runner import run_simulation

    run_simulation(SimConfig(
        nav_file=os.path.join(FIXTURES, "brdc_test.22n"), duration_sec=0.5,
        almanac_enable=False, backend=SynthBackend.NATIVE, sink="iqfile",
        out_file=path,
    ))
    return np.fromfile(path, dtype=np.int8)


def _children_result(results: list) -> dict:
    """The children's backend (one for all) and K1/K2 launches, summed."""
    return dict(backend=results[0]["backend"],
                launches={k: sum(r["launches"][k] for r in results)
                          for k in ("K1", "K2")})


def _dryrun_multiproc_dcn(devices) -> dict:
    """Two processes, each with 4 mesh devices (:func:`child_layout`):
    each synthesizes its block share of a 0.5 s scenario over the global
    (blocks x chan) mesh and streams it to a part file; the merged stream
    must equal a single-process native run. Returns the children's
    backend and launch counts, summed."""
    import tempfile

    from .parallel.multihost import merge_parts

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "mh.bin")
        results = run_children(_MH_CHILD.format(
            repo=REPO, coord=f"tcp://127.0.0.1:{_free_port()}", n_proc=2,
            out=out, layout=json.dumps(child_layout(devices, 2, 4))), 2)
        merge_parts(out, 2)
        a = np.fromfile(out, dtype=np.int8)
        b = _native_reference(os.path.join(td, "ref.bin"))
        if a.size != b.size or not np.array_equal(a, b):
            raise AssertionError("merged multi-process stream != "
                                 "single-process reference")
    return _children_result(results)


def _dryrun_multiproc_dcn4(devices) -> dict:
    """Four processes x 2 mesh devices on the chan-major mesh
    (multihost.global_mesh_chan_major): every channel-sum term lives on a
    DIFFERENT process, so the sum itself crosses the process boundary —
    and, being integer, it must still be bit-exact. Each process ends
    with the complete stream; all four must equal the single-process
    native run. Returns the children's backend and launch counts,
    summed."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "mh4.bin")
        results = run_children(_MH4_CHILD.format(
            repo=REPO, coord=f"tcp://127.0.0.1:{_free_port()}", n_proc=4,
            out=out, layout=json.dumps(child_layout(devices, 4, 2))), 4)
        b = _native_reference(os.path.join(td, "ref.bin"))
        for pid in range(4):
            a = np.fromfile(f"{out}.p{pid}", dtype=np.int8)
            if a.size != b.size or not np.array_equal(a, b):
                raise AssertionError(f"process {pid}: chan-major "
                                     "cross-process stream != reference")
    return _children_result(results)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="entry",
                    choices=("entry", "dryrun"))
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="default cuda: N distinct cards (fewer raise); "
                    "cpu: the CPU N times")
    args = ap.parse_args(argv)
    if args.mode == "dryrun":
        dryrun_multichip(args.n_devices, device=args.device)
        return 0
    fn, ex = entry(device=args.device)
    out = fn(*ex)
    print("entry OK:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
