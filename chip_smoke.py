#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA package (``gpssim_tpu_torch``).

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py            # every visible card
    python3 chip_smoke.py --cards 4  # raises unless 4 cards are visible

It imports nothing of JAX or of the JAX package. Phases, each of which
raises on failure (a failed phase ends the run with a non-zero exit):

1. Device facts: the card's name and power limit from ``nvidia-smi``
   and, with more than one card, ``nvidia-smi topo -m`` (the links).
2. Build: every CUDA kernel under ``gpssim_tpu_torch/csrc`` (one ``nvcc``
   each) and the native host engine (strict-parity corrections), all
   started together. Each kernel's registers, shared memory and spills
   as ``nvcc -Xptxas -v`` reports them (spills fail the run) and, where
   ``cuobjdump`` exists, the instructions, shared loads and table
   gathers of the stage-B loop in the compiled SASS.
3. Kernels against their plain versions, byte for byte, at the main
   path's shapes (25 fixture blocks per window: 3 Msps at 8 and 16 bits,
   integer NCO, 1.2 Msps wide window, 6 Msps with the q2 row digit) and
   on edited copies of the 3 Msps window: 16 channels (four channels
   repeated), split gains where the fold wraps int32, and two windows
   that K1's persistent grid could get wrong (one block of 8 rows, fewer
   rows than resident CTAs; 7 blocks, whose rows do not divide by the
   CTA count): K1 (``synth_blocks_batch_cuda``) against
   ``synth_blocks_batch_torch``; the two-stage path (producer, K2,
   finalize) against its plain version; the raw rows of K2 and of K1's
   raw mode against ``synth_batch_torch_raw``; and K2's finalized bytes
   against K1's. K1's grid (resident CTAs, rows, CTAs launched, rows per
   CTA), as its C side computes it for the launch, is printed for each of
   those windows. K1 also at the windows of a paced run (3 Msps, the full
   12-channel axis): 4 blocks of one scenario and 12 of a 3-member fleet.
4. End to end, each path with the kernels' launch counts set to 0 just
   before it and read just after (a fresh process starts at 0):
   [4]  the CLI in-process on a 10 s scenario (99 blocks, 4 windows) with
        ``--backend cuda``; its bytes must equal ``--backend native``, and
        only K1 may launch. The run is repeated under torch.profiler for
        the host stages and the device's idle share.
   [4b] the same CLI run with ``GPSSIM_FUSE_A=0`` (the two-stage path):
        the same bytes, K2 launched and K1 not.
   [4c] ``--fleet`` with a 3-row roster for 5 s: each member file equals
        a solo ``--backend native`` run at its location; then the same
        fleet over a (1, 2) mesh of the one card (K1's raw mode and the
        channel sum).
   [4d] ``make_sharded_synth(kernel="cuda")`` over that mesh on the
        25-block window: the bytes of K1's output.
   [4e] a paced 10 s ``-r tcp --realtime`` CLI run in a fresh process
        (``chip_smoke.py --paced-child``: CUDA's start-up and the kernel
        library's load inside the run) to a loopback receiver: the bytes
        received equal [4]'s native file, 0 failovers, 0 underruns, one K1
        launch per 4-block window (25); then the same run profiled, for
        K1's device time per launch and the device's idle share.
   [4f] in-process, a paced 12 s run whose ``pack_args`` stalls for its
        first 2 s: it fails over to the native engine and back on the
        production probe margin; every block written, the bytes of
        ``--backend native``, no probe error, K1 launched after the
        failback.
   [4g] a paced ``--fleet`` of [4c]'s roster for 5 s, each member equal
        to its solo native run with no failover; then a 2-member paced
        fleet stalled as in [4f] fails over and back, byte-equal.
   [4h] in-process, an interactive paced 5 s run (``-r iqfile``) steered
        by a thread that calls ``TuiApp.handle_key`` every 0.2 s (no tty,
        no curses): the edits, recorded where they landed, replayed on
        ``--backend native`` give the same bytes; 0 failovers, 0
        underruns, key-to-stream latency at most ``fifo_depth`` = 8
        blocks.
   [4i] interactive runs into the mock HackRF and Pluto libraries
        (``native/mock_*.c``, built with ``cc``, a fresh copy per run)
        through the sinks' own binding: each capture equals
        ``--backend native``'s, and the mock saw a clean teardown.
   [4j] ``qa.verify_stream`` on the card on [4c]'s three member files,
        each against its member config: all verify, and a copy of member
        0 with block 10 zeroed fails; seconds per member, the
        correlations' share, and member 0 on the host CPU for scale.
   [4k] ``acquire(backend="torch")`` on the card on [4]'s native file:
        the detections of ``backend="numpy"``; both timed.
   [4l] ``entry()`` on the card: one K1 launch, byte-equal to K1's plain
        version; then ``entry.dryrun_multichip(2, devices=["cuda:0"] *
        2)``, all nine passes (K1 and K2 here, K1 in the gloo children
        of the two multi-process passes, whose counts they report).
   [4m] NCCL ranks, rank r on card r (``chip_smoke.py`` started in
        processes of their own, ``rank_child``), on the 30 s main
        scenario: the blocks-axis run (``run_scenario_multihost``, part
        files merged) and every rank's chan-major stream
        (``synthesize_chan_major``, the sum on the cards) byte-equal to
        ``--backend native``; one rank on one card, and 2 and N ranks on
        N cards, with the sum of one 25-block window timed on the card
        (NCCL, profiler) and through gloo (host clock). With N >= 2 cards
        also ``make_sharded_synth`` over an (N, 1) and a (1, N) mesh of
        distinct cards against K1, [4c]'s fleet over both against its solo
        native runs, and ``dryrun_multichip(N)`` over distinct cards.
5. Times: K1 and K2 and their plain versions per 25-block window (CUDA
   events, median; and each kernel's device time per launch from
   torch.profiler, which no slowness of the host can inflate), beside
   the least time the card could take (the largest of the
   integer-operations, shared-memory and HBM floors, and which one
   binds); the producer's and the finalize's times; K1's raw
   mode at a (1, 2) mesh shard's shape (half the channels, all R_pad
   rows), byte-checked and timed beside its bound; K1 at the two paced
   windows of [3]; the fleet's aggregate realtime factor.

It prints the ``nvidia-smi`` line, one JSON line ``{"kernels": [...]}``
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "fixtures", "brdc_test.22n")
LOCATION = "35.681298,139.766247,10.0"
WINDOW = 25  # blocks per launch on the main path (cfg.dispatch_blocks)
# the fleet phase's roster: Tokyo, New York, Paris
FLEET_ROSTER = ("35.681298,139.766247,10", "40.7128,-74.0060,20",
                "48.8584,2.2945,35")
FLEET_SECONDS = 5
# a paced run's window: half the FIFO depth of 8 (runner.dispatch_window)
PACED_WINDOW = 4
PACED_SECONDS = 10  # [4e]
ROUNDTRIP_SECONDS = 12  # [4f]
THROTTLE_SECONDS = 2.0  # [4f], [4g]: pack_args stalls for this long
KEY_SECONDS = 5  # [4h]
KEYS = "dewdewdeq"  # [4h]: bearing, speed, vertical speed; one every 0.2 s
HACKRF_SECONDS = 2.5  # [4i]: 24 blocks, 14.4 MB (the mock holds 16 MiB)
PLUTO_SECONDS = 0.9  # [4i]: 8 blocks, the mock's whole capture
MULTI_SECONDS = 30  # [4m]: the main cell's scenario, lengthened
ALLREDUCE_CALLS = 10  # [4m]: timed calls of the chan-major sum per backend

# Published peaks of one H100 SXM (NVIDIA data sheet and Hopper white
# paper): 3.35 TB/s of HBM3; 132 SMs at a 1.98 GHz boost clock, each
# issuing one warp instruction per clock from each of its 4 schedulers,
# i.e. 128 int32 lane-operations per clock per SM. That issue rate is the
# ceiling of an int32 instruction mix (add, logic and shifts go to the
# INT32 pipe, IMAD to the FMA pipe); the same 128 lanes x 2 x 132 x
# 1.98 GHz give the data sheet's 67 TFLOP/s float32.
# Shared memory serves one 128-byte wavefront (32 banks of 4 bytes) per
# clock per SM.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9
SHARED_WAVEFRONTS_PER_S = 132 * 1.98e9
# int32 operations per channel-sample of stage B: the smaller count of the
# two loop designs the repo has had, each counted from its source. The
# one-sample-per-thread loop: 36 (code phase 5, window word and chip sign
# 5, carrier index 6, two |LUT| 2, two split-Q44 gain folds 10, two sign
# selects 6, two accumulates 2). The current loop (csrc/stage_b.cuh,
# shared by K1 and K2), 64-chip window: 16 (code phase 3: two
# multiply-adds and the carry add; window word 2: compare, select; chip
# sign 4: chip-field shift, funnel rotate, mask, minus one; carrier table
# offset 5: two multiply-adds, the carry add, shift, mask; two
# accumulating multiply-adds 2), plus one add per channel and row that
# four samples share. The 128-chip window adds four (two more compares and
# selects).
OPS_PER_CHANNEL_SAMPLE = 16
# Shared-memory wavefronts the current loop issues per warp and channel
# (one row of 128 samples, four per thread): four 64-bit table gathers of
# 256 bytes, two wavefronts each, and three broadcast loads of the row's
# per-channel values (phase bases, window words, lane steps).
WAVEFRONTS_PER_WARP_CHANNEL = 4 * 2 + 3


def device_facts() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return smi


def build_all() -> dict:
    """nvcc for every kernel source and g++ for the native engines, all
    started together; returns seconds per build."""
    from gpssim_tpu_torch.ops import _build
    from gpssim_tpu_torch.ops.args import load_engine
    from gpssim_tpu_torch.ops.synth_seq import seq_available

    times, errors = {}, []

    def timed(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)
        times[name] = time.perf_counter() - t

    def kernel(source):
        return lambda: _build.load(source)

    def native():
        if not seq_available():
            raise RuntimeError("native engine did not build "
                               "(tools/build_native.sh)")
        load_engine()  # the collation engine: raises if g++ fails

    jobs = [(src, kernel(src)) for src in _build.sources()]
    threads = [threading.Thread(target=timed, args=job)
               for job in jobs + [("native", native)]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return times


def kernel_label(symbol: str) -> str:
    """``synth_k1 narrow`` and the like, from a mangled kernel name."""
    m = re.search(r"(synth_k\d)_kernel(?:ILb([01])E)?", symbol)
    if not m:
        return symbol
    return m.group(1) + {"0": " narrow", "1": " wide", None: ""}[m.group(2)]


def ptxas_resources(report: str) -> dict:
    """Per kernel of an ``nvcc -Xptxas -v`` report: registers, static
    shared memory, stack and spill bytes."""
    out = {}
    for part in re.split(r"(?=ptxas info\s*: Compiling entry function)",
                         report):
        m = re.search(r"Compiling entry function '([^']+)'", part)
        if not m:
            continue

        def num(pattern):
            x = re.search(pattern, part)
            return int(x.group(1)) if x else 0

        out[kernel_label(m.group(1))] = dict(
            registers=num(r"Used (\d+) registers"),
            smem_bytes=num(r"(\d+) bytes smem"),
            stack_bytes=num(r"(\d+) bytes stack frame"),
            spill_bytes=num(r"(\d+) bytes spill stores")
            + num(r"(\d+) bytes spill loads"),
        )
    return out


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output → {kernel: [(address, opcode, text)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(kernel_label(m.group(1)), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and cur is not None:
            words = m.group(2).split()
            op = words[1] if words[0].startswith("@") else words[0]
            cur.append((int(m.group(1), 16), op, m.group(2)))
    return funcs


def _regs(operands: str) -> set:
    return set(re.findall(r"\bR(\d+)\b", operands))


def is_gather(body: list, i: int) -> bool:
    """Whether ``body[i]`` is a table gather of the stage-B loop: an
    ``LDS.64`` whose value the next instruction reading it multiplies
    into a sum (an IMAD). The loop's other 64-bit load, the window words
    of the 64-chip window, feeds a select."""
    op, text = body[i][1], body[i][2]
    if not re.match(r"LDS(\.U)?\.64$", op):
        return False
    d = int(re.search(r"\bR(\d+)", text.split(op, 1)[1]).group(1))
    loaded = {str(d), str(d + 1)}
    for _, op2, text2 in body[i + 1:]:
        srcs = text2.split(op2, 1)[1].split(",", 1)[-1]
        if loaded & _regs(srcs):
            return op2.startswith("IMAD")
    return False


def stage_b_loop(instrs: list, gather=is_gather):
    """The stage-B channel loop in a kernel's SASS: of the innermost loops
    (backward branches) that hold table gathers (``gather(body, i)``),
    the one with the most. Returns its instruction count (NOPs left out),
    shared loads, gathers and IMADs (the FMA pipe's integer
    multiply-adds), or None."""
    def body(lo, hi):
        return [x for x in instrs if lo <= x[0] <= hi and x[1] != "NOP"]

    def gathers(b):
        return sum(gather(b, i) for i in range(len(b)))

    loops = []
    for addr, op, text in instrs:
        m = re.search(r"BRA\S*\s+0x([0-9a-f]+)", text)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    loops = [lp for lp in loops if gathers(body(*lp))]
    inner = [lp for lp in loops if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    if not inner:
        return None
    b = body(*max(inner, key=lambda lp: gathers(body(*lp))))
    g = gathers(b)
    loads = sum(op.startswith("LDS") for _, op, _ in b)
    return dict(instructions=len(b), shared_loads=loads, gathers=g,
                imad=sum(op.startswith("IMAD") for _, op, _ in b),
                other_per_gather=(len(b) - loads) / g)


def kernel_resources() -> dict:
    """[2] per kernel: the ptxas figures and, where ``cuobjdump`` exists,
    the stage-B loop's SASS counts; raises on any spill."""
    from gpssim_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for src in _build.sources():
        lib, report = _build.build(src)
        res = ptxas_resources(report)
        sass = {}
        if os.path.exists(tool):
            sass = sass_functions(subprocess.run(
                [tool, "-sass", lib], capture_output=True, text=True,
                check=True, timeout=120).stdout)
        for name, r in sorted(res.items()):
            r["sass_loop"] = (stage_b_loop(sass[name]) if name in sass
                              else None)
            loop = r["sass_loop"]
            print(f"    {name}: {r['registers']} registers, "
                  f"{r['smem_bytes']} bytes static smem (+ C x 4096 "
                  f"dynamic), {r['stack_bytes']} bytes stack, "
                  f"{r['spill_bytes']} bytes spilled; stage-B loop SASS: "
                  + (f"{loop['instructions']} instructions, "
                     f"{loop['shared_loads']} shared loads, "
                     f"{loop['gathers']} table gathers, {loop['imad']} "
                     f"IMAD; {loop['other_per_gather']:.2f} other "
                     "instructions per gather" if loop else
                     "not measured (no cuobjdump or no loop found)"))
            if r["spill_bytes"] or r["stack_bytes"]:
                raise AssertionError(f"{name} spills to local memory")
            out[name] = r
    return out


def reset_launches() -> None:
    from gpssim_tpu_torch.ops.synth_cuda import launches

    for k in launches:
        launches[k] = 0


def read_launches() -> dict:
    from gpssim_tpu_torch.ops.synth_cuda import launches

    return dict(launches)


def fixture_window(sample_rate: int, int_nco: bool = False,
                   blocks: int = WINDOW, compact: bool = True) -> tuple:
    """(packed int32 args, spec, num_samples, n_rows, wide, numpy args)
    for the first ``blocks`` blocks of the fixture scenario, collated as
    the main path collates them (``compact=False``: as a paced run does,
    on the full channel axis)."""
    from gpssim_tpu_torch.config import CarrierMode, LocationConfig, SimConfig
    from gpssim_tpu_torch.ops.args import (
        LANES, collate_plans, needs_wide_window, pack_args,
    )
    from gpssim_tpu_torch.scenario import Simulation

    lat, lon, hgt = (float(v) for v in LOCATION.split(","))
    cfg = SimConfig(
        nav_file=FIXTURE, duration_sec=(blocks + 1) / 10.0,
        almanac_enable=False, sample_rate=sample_rate,
        location=LocationConfig(lat, lon, hgt),
        carrier_mode=CarrierMode.INT_NCO if int_nco else CarrierMode.FLOAT,
    )
    plans = list(Simulation(cfg).iter_plans())[:blocks]
    if len(plans) != blocks:
        raise RuntimeError(f"fixture gave {len(plans)} blocks, not {blocks}")
    batch = collate_plans(plans, int_nco=int_nco, compact=compact,
                          compact_multiple=4)
    packed, spec = pack_args(batch.args)
    n = cfg.samples_per_epoch
    return (packed, spec, n, -(-n // LANES),
            needs_wide_window(1 / sample_rate), batch.args)


def paced_fleet_window() -> tuple:
    """The first window of a paced 3 Msps fleet of FLEET_ROSTER, as
    ``run_fleet`` collates it: PACED_WINDOW blocks per member,
    round-robin, on the full channel axis."""
    import itertools

    from gpssim_tpu_torch.config import LocationConfig, SimConfig
    from gpssim_tpu_torch.fleet import _interleave_plans
    from gpssim_tpu_torch.ops.args import (
        LANES, collate_plans, needs_wide_window, pack_args,
    )
    from gpssim_tpu_torch.scenario import Simulation

    sims = [Simulation(SimConfig(
        nav_file=FIXTURE, duration_sec=(PACED_WINDOW + 1) / 10.0,
        almanac_enable=False,
        location=LocationConfig(*(float(v) for v in loc.split(",")))))
        for loc in FLEET_ROSTER]
    W = len(sims) * PACED_WINDOW
    plans = [p for _, p in itertools.islice(_interleave_plans(sims), W)]
    batch = collate_plans(plans, compact=False)
    packed, spec = pack_args(batch.args)
    n = sims[0].cfg.samples_per_epoch
    return (packed, spec, n, -(-n // LANES), needs_wide_window(1 / 3e6),
            batch.args)


def edited_window(window, channels: int | None = None,
                  seed: int | None = None) -> tuple:
    """A copy of a fixture window with its channels padded to ``channels``
    by repeating the first ones, or with every split gain replaced, from
    ``seed``, by one where the fold's ga*|LUT| wraps int32."""
    import numpy as np

    from gpssim_tpu_torch.ops.args import pack_args
    from gpssim_tpu_torch.parallel.shard import _CHAN_AXIS

    _, _, n, n_rows, wide, args = window
    args = {k: np.array(v) for k, v in args.items()}
    if channels is not None:
        idx = np.arange(channels) % args["gain_a"].shape[1]
        args = {k: np.take(v, idx, axis=_CHAN_AXIS[k])
                for k, v in args.items()}
    if seed is not None:
        rng = np.random.default_rng(seed)
        shape = args["gain_a"].shape
        args["gain_a"] = rng.integers(1 << 23, 1 << 31, shape).astype(
            np.int32)
        args["gain_b"] = rng.integers(0, 1 << 22, shape).astype(np.int32)
    packed, spec = pack_args(args)
    return packed, spec, n, n_rows, wide, args


def sliced_window(window, blocks: int, num_samples: int) -> tuple:
    """The first ``blocks`` blocks of a fixture window, each cut to its
    first ``num_samples`` samples."""
    from gpssim_tpu_torch.ops.args import LANES, pack_args

    wide, args = window[4], window[5]
    args = {k: v[:blocks] for k, v in args.items()}
    packed, spec = pack_args(args)
    return (packed, spec, num_samples, -(-num_samples // LANES), wide,
            args)


def k1_grid(window, raw: bool) -> dict:
    """K1's persistent grid on a window, finalized (8-bit) or raw, as the
    C side computes it for the launch (``synth_cuda.k1_grid``): the CTAs
    resident on the card, the rows, the CTAs launched and rows per CTA."""
    from gpssim_tpu_torch.ops.synth_cuda import k1_grid as launch_grid
    from gpssim_tpu_torch.ops.synth_torch import padded_rows

    _, _, n, n_rows, wide, args = window
    B, C = args["gain_a"].shape
    if raw:
        n_rows = padded_rows(n_rows)
    return launch_grid(B, C, n_rows=n_rows, num_samples=n, out_bits=8,
                       wide=wide, raw=raw, device=0)


def on_card(packed, spec):
    import torch

    from gpssim_tpu_torch.ops.args import unpack_args

    return unpack_args(torch.from_numpy(packed).cuda(), spec)


def compare_kernel(name: str, window, out_bits: int) -> int:
    """Kernel vs plain version on one window; returns max |difference|
    (0: byte-equal) and raises on any difference."""
    import torch

    from gpssim_tpu_torch.ops.synth_cuda import synth_blocks_batch_cuda
    from gpssim_tpu_torch.ops.synth_torch import synth_blocks_batch_torch

    packed, spec, n, n_rows, wide, _ = window
    args = on_card(packed, spec)
    kw = dict(n_rows=n_rows, num_samples=n, out_bits=out_bits, wide=wide)
    got = synth_blocks_batch_cuda(args, **kw, fuse_a=True)
    want = synth_blocks_batch_torch(args, **kw)
    C = args["gain_a"].shape[1]
    return max_diff(f"K1 on {name}", got, want,
                    f"B={got.shape[0]} N={n} C={C} wide={wide} "
                    f"bits={out_bits}")


def max_diff(what: str, got, want, facts: str, pairs: bool = True) -> int:
    """max |got - want| (0: byte-equal), printed; raises on any
    difference, naming the first differing (block, sample)."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{what}: {tuple(got.shape)} {got.dtype}, plain version "
            f"{tuple(want.shape)} {want.dtype}")
    diff = got.to(torch.int32) - want.to(torch.int32)
    max_err = int(diff.abs().max())
    print(f"  {what}: {facts} max_abs_err={max_err}")
    if max_err:
        flat = diff.reshape(diff.shape[0], -1)
        if pairs:
            flat = flat.view(diff.shape[0], -1, 2)
        bad = torch.nonzero(flat.any(-1) if pairs else flat)
        raise AssertionError(
            f"{what} != plain version: first differing (block, sample) "
            f"{tuple(int(v) for v in bad[0])}, {len(bad)} samples differ"
        )
    return max_err


def compare_two_stage(name: str, window, out_bits: int) -> int:
    """The two-stage path (producer, K2, finalize) against its plain
    version on one window; returns max |difference|."""
    from gpssim_tpu_torch.ops.synth_cuda import synth_blocks_batch_cuda
    from gpssim_tpu_torch.ops.synth_torch import (
        finalize_rows, synth_batch_torch_raw,
    )

    packed, spec, n, n_rows, wide, _ = window
    args = on_card(packed, spec)
    got = synth_blocks_batch_cuda(args, n_rows=n_rows, num_samples=n,
                                  out_bits=out_bits, wide=wide, fuse_a=False)
    want = finalize_rows(*synth_batch_torch_raw(args, n_rows=n_rows,
                                                wide=wide, fuse_a=False),
                         n, out_bits)
    C = args["gain_a"].shape[1]
    return max_diff(f"K2 two-stage on {name}", got, want,
                    f"B={got.shape[0]} N={n} C={C} wide={wide} "
                    f"bits={out_bits}")


def compare_raw_rows(name: str, window) -> dict:
    """Raw rows (all R_pad rows) of K2 and of K1's raw mode against
    ``synth_batch_torch_raw``; returns max |difference| per kernel."""
    from gpssim_tpu_torch.ops.synth_cuda import (
        stage_b_packed_cuda, synth_k1_raw,
    )
    from gpssim_tpu_torch.ops.synth_torch import (
        padded_rows, row_bases_packed, synth_batch_torch_raw,
    )

    packed, spec, n, n_rows, wide, _ = window
    args = on_card(packed, spec)
    want = synth_batch_torch_raw(args, n_rows=n_rows, wide=wide,
                                 fuse_a=False)
    bases = row_bases_packed(args["code_l"], args["carr_l"], args["nav"],
                             args["ca_packed"], padded_rows(n_rows), wide)
    got = {
        "K2": stage_b_packed_cuda(bases, args["lane_steps"],
                                  args["gain_a"], args["gain_b"], wide),
        "K1": synth_k1_raw(args, n_rows=n_rows, wide=wide),
    }
    R = want[0].shape[1]
    return {
        k: max(max_diff(f"{k} raw {plane} rows on {name}", g, w,
                        f"B={w.shape[0]} R_pad={R}", pairs=False)
               for plane, g, w in zip("iq", got[k], want))
        for k in got
    }


def run_cli(backend: str, out_file: str, extra=(), seconds: int = 10,
            location: str = LOCATION) -> tuple:
    from gpssim_tpu_torch import cli

    argv = [
        "-e", FIXTURE, "-d", str(seconds), "-l", location,
        "--disable-almanac", "-r", "iqfile", "--backend", backend,
        "--out-file", out_file, *extra,
    ]
    t = time.perf_counter()
    rc, stats = cli.run(argv)
    wall = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"CLI --backend {backend} exited {rc}")
    return stats, wall


def files_equal(what: str, ref_file: str, out_file: str,
                blocks: int | None = None) -> None:
    """Raise unless the two files hold the same bytes (and, given
    ``blocks``, that many 8-bit blocks of 3 Msps)."""
    import numpy as np

    ref = np.fromfile(ref_file, dtype=np.int8)
    out = np.fromfile(out_file, dtype=np.int8)
    if blocks is not None and out.size != blocks * 2 * 300_000:
        raise AssertionError(f"{what}: {out.size} bytes, not {blocks} "
                             "blocks")
    if not np.array_equal(ref, out):
        bad = np.flatnonzero(ref != out) if ref.size == out.size else []
        raise AssertionError(
            f"{what}: bytes != --backend native ({ref.size} vs {out.size} "
            f"bytes; {len(bad)} differ, first at "
            f"{int(bad[0]) if len(bad) else None})"
        )


def end_to_end(workdir: str) -> dict:
    """[4] the main path; leaves the native run's file for [4b]."""
    from gpssim_tpu_torch.config import SimConfig
    from gpssim_tpu_torch.runner import strict_parity_enabled

    if not strict_parity_enabled(SimConfig()):
        raise RuntimeError("strict parity is off: the native engine is "
                           "missing")
    ref_file = os.path.join(workdir, "native.bin")
    out_file = os.path.join(workdir, "cuda.bin")
    run_cli("native", ref_file)

    reset_launches()
    stats, wall = run_cli("cuda", out_file)
    launches = read_launches()

    if stats.blocks != 99:
        raise AssertionError(f"cuda run wrote {stats.blocks} blocks")
    files_equal("--backend cuda", ref_file, out_file, blocks=99)
    if launches["K1"] < 4 or launches["K2"] != 0:
        raise AssertionError(f"main path launches {launches} (expected K1 "
                             ">= 4, K2 0)")
    if stats.retries != 0:
        raise AssertionError(f"{stats.retries} window retries")
    # the spread of the end-to-end rate: four more runs of the same CLI
    walls = [stats.wall_seconds] + [
        run_cli("cuda", out_file)[0].wall_seconds for _ in range(4)]
    print(f"  cuda CLI: {stats.blocks} blocks in {stats.wall_seconds:.3f} s "
          f"= {stats.blocks / stats.wall_seconds:.1f} blocks/s, "
          f"{stats.samples_per_second / 1e6:.2f} Msps, "
          f"x{stats.realtime_factor:.2f} realtime (process wall incl. "
          f"set-up {wall:.3f} s); launches {launches}; retries "
          f"{stats.retries}; bytes equal to --backend native")
    med = statistics.median(walls)
    print(f"  5 runs: wall s {', '.join(f'{w:.4f}' for w in walls)}; median "
          f"{med:.4f} s = {stats.samples / med / 1e6:.2f} Msps, "
          f"x{stats.blocks * 0.1 / med:.2f} realtime")
    return dict(launches=launches, blocks=stats.blocks, wall_s_runs=walls,
                msps_median=stats.samples / med / 1e6,
                realtime_x_median=stats.blocks * 0.1 / med)


def two_stage_e2e(workdir: str) -> dict:
    """[4b] the 10 s CLI run with GPSSIM_FUSE_A=0: producer → K2 →
    finalize, the bytes of the native run of [4]."""
    out_file = os.path.join(workdir, "two_stage.bin")
    old = os.environ.get("GPSSIM_FUSE_A")
    os.environ["GPSSIM_FUSE_A"] = "0"
    try:
        reset_launches()
        stats, _ = run_cli("cuda", out_file)
        launches = read_launches()
    finally:
        if old is None:
            del os.environ["GPSSIM_FUSE_A"]
        else:
            os.environ["GPSSIM_FUSE_A"] = old
    files_equal("GPSSIM_FUSE_A=0 --backend cuda",
                os.path.join(workdir, "native.bin"), out_file, blocks=99)
    if launches["K2"] < 4 or launches["K1"] != 0:
        raise AssertionError(f"two-stage path launches {launches} "
                             "(expected K2 >= 4, K1 0)")
    print(f"  GPSSIM_FUSE_A=0 cuda CLI: {stats.blocks} blocks in "
          f"{stats.wall_seconds:.3f} s = {stats.samples_per_second / 1e6:.2f}"
          f" Msps; launches {launches}; bytes equal to --backend native")
    return dict(launches=launches, wall_s=stats.wall_seconds,
                msps=stats.samples_per_second / 1e6)


def fleet_e2e(workdir: str) -> dict:
    """[4c] ``--fleet`` with the 3-row roster, then the same fleet over a
    (1, 2) mesh of the one card; every member file equals its solo
    native run. Both runs are then repeated under the profiler."""
    import dataclasses

    import torch

    from gpssim_tpu_torch import cli
    from gpssim_tpu_torch.config import SimConfig, SynthBackend
    from gpssim_tpu_torch.fleet import (
        member_configs, parse_fleet_file, run_fleet,
    )
    from gpssim_tpu_torch.parallel.shard import make_mesh

    roster = os.path.join(workdir, "roster.csv")
    with open(roster, "w") as fp:
        fp.write("\n".join(FLEET_ROSTER) + "\n")
    blocks = FLEET_SECONDS * 10 - 1
    common = ["-e", FIXTURE, "-d", str(FLEET_SECONDS), "--disable-almanac",
              "-r", "iqfile"]
    solo = []
    for i, loc in enumerate(FLEET_ROSTER):
        solo.append(os.path.join(workdir, f"solo{i}.bin"))
        rc, _ = cli.run(common + ["-l", loc, "--backend", "native",
                                  "--out-file", solo[-1]])
        if rc != 0:
            raise RuntimeError(f"native solo run {i} exited {rc}")

    reset_launches()
    rc, stats = cli.run(common + ["--backend", "cuda", "--fleet", roster,
                                  "--out-file",
                                  os.path.join(workdir, "fleet.bin")])
    launches = read_launches()
    if rc != 0:
        raise RuntimeError(f"--fleet exited {rc}")
    for i, ref in enumerate(solo):
        files_equal(f"fleet member {i}", ref,
                    os.path.join(workdir, f"fleet_m{i}.bin"), blocks=blocks)
    if launches["K1"] < 1 or launches["K2"] != 0:
        raise AssertionError(f"fleet launches {launches} (expected K1 >= 1,"
                             " K2 0)")
    wall = max(st.wall_seconds for st in stats)
    agg = sum(st.blocks for st in stats) * 0.1 / wall
    print(f"  --fleet ({len(stats)} members x {blocks} blocks): wall "
          f"{wall:.3f} s, aggregate x{agg:.2f} realtime; launches "
          f"{launches}; every member equal to its solo native run")

    base = SimConfig(nav_file=FIXTURE, duration_sec=float(FLEET_SECONDS),
                     almanac_enable=False, backend=SynthBackend.CUDA,
                     sink="iqfile", out_file=os.path.join(workdir, "mesh.bin"))
    cfgs = member_configs(base, parse_fleet_file(roster))
    card = torch.device("cuda", 0)
    reset_launches()
    mstats = run_fleet(cfgs, mesh=make_mesh(1, 2, devices=[card, card]))
    mesh_launches = read_launches()
    for i, ref in enumerate(solo):
        files_equal(f"(1, 2) mesh fleet member {i}", ref,
                    os.path.join(workdir, f"mesh_m{i}.bin"), blocks=blocks)
    if mesh_launches["K1"] < 2 or mesh_launches["K2"] != 0:
        raise AssertionError(f"mesh fleet launches {mesh_launches} "
                             "(expected K1 >= 2, K2 0)")
    mwall = max(st.wall_seconds for st in mstats)
    magg = sum(st.blocks for st in mstats) * 0.1 / mwall
    print(f"  fleet over a (1, 2) mesh of one card: wall {mwall:.3f} s, "
          f"aggregate x{magg:.2f} realtime; launches {mesh_launches}; "
          "every member equal to its solo native run")
    prof = profile_run("--fleet", lambda: cli.run(
        common + ["--backend", "cuda", "--fleet", roster, "--out-file",
                  os.path.join(workdir, "fprof.bin")])[1])
    mprof = profile_run("(1, 2) mesh fleet", lambda: run_fleet(
        member_configs(dataclasses.replace(
            base, out_file=os.path.join(workdir, "mprof.bin")),
            parse_fleet_file(roster)),
        mesh=make_mesh(1, 2, devices=[card, card])))
    return dict(launches=launches, wall_s=wall, realtime_x_aggregate=agg,
                mesh_launches=mesh_launches, mesh_wall_s=mwall,
                mesh_realtime_x_aggregate=magg, profile=prof,
                mesh_profile=mprof)


def sharded_window(window) -> dict:
    """[4d] make_sharded_synth(kernel="cuda") over a (1, 2) mesh of the
    one card on the 25-block window: the bytes of K1's output."""
    import torch

    from gpssim_tpu_torch.ops.synth_cuda import synth_blocks_batch_cuda
    from gpssim_tpu_torch.parallel.shard import (
        make_mesh, make_sharded_synth, pad_batch, pad_channels,
    )

    packed, spec, n, n_rows, wide, args_np = window
    card = torch.device("cuda", 0)
    fn = make_sharded_synth(make_mesh(1, 2, devices=[card, card]), n_rows,
                            n, wide=wide, out_bits=8, kernel="cuda")
    batch, pad = pad_batch(pad_channels(args_np, 2), 1)
    reset_launches()
    got = torch.from_numpy(fn(batch).result())
    launches = read_launches()
    want = synth_blocks_batch_cuda(on_card(packed, spec), n_rows=n_rows,
                                   num_samples=n, out_bits=8, wide=wide,
                                   fuse_a=True).cpu()
    if pad or launches["K2"] != 2 or launches["K1"] != 0:
        raise AssertionError(f"sharded window: pad {pad}, launches "
                             f"{launches} (expected K2 2, K1 0)")
    max_diff("(1, 2) mesh, kernel cuda, against K1", got, want,
             f"B={got.shape[0]} N={n} launches {launches}")
    return dict(launches=launches)


class Receiver:
    """A loopback TCP receiver: accepts one connection and keeps every
    byte until the sender closes it."""

    def __init__(self):
        import socket

        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(600)
        self.port = self.srv.getsockname()[1]
        self.received = bytearray()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        conn, _ = self.srv.accept()
        with conn:
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    return
                self.received.extend(data)

    def join(self):
        self._t.join(60)
        self.srv.close()
        if self._t.is_alive():
            raise RuntimeError("loopback receiver did not see the stream end")


def paced_child(argv: list, profiled: bool) -> int:
    """The child process of [4e]: ``cli.run(argv)`` in a fresh process
    (CUDA's start-up, the kernel library's load and build inside the
    run), optionally under torch.profiler; prints one JSON line with the
    run's stats, the wrappers' launch counts and, when profiled, K1's
    device time per launch."""
    sys.path.insert(0, REPO)
    from gpssim_tpu_torch import cli

    reset_launches()
    t = time.perf_counter()
    k1 = None
    if profiled:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rc, stats = cli.run(argv)
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        events = [e for e in device if "synth_k1_kernel" in e.key]
        n = sum(e.count for e in events)
        if n:
            busy = sum(e.self_device_time_total for e in device) / 1e3
            k1 = dict(launches=n, device_ms_per_launch=sum(
                e.self_device_time_total for e in events) / n / 1e3,
                device_busy_ms=busy,
                idle_share=1 - busy / (stats.wall_seconds * 1e3))
    else:
        rc, stats = cli.run(argv)
    print(json.dumps(dict(
        rc=rc, blocks=stats.blocks, wall_s=stats.wall_seconds,
        process_wall_s=time.perf_counter() - t,
        realtime_x=stats.realtime_factor, underruns=stats.underruns,
        failovers=stats.failovers, failbacks=stats.failbacks,
        events=stats.events, launches=read_launches(), k1_profiled=k1)))
    return 0


def run_child(argv: list, profiled: bool) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--paced-child",
         json.dumps(argv), "profile" if profiled else "plain"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"paced child exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def paced_e2e(workdir: str) -> dict:
    """[4e] a paced 10 s ``-r tcp --realtime`` CLI run in a fresh process
    to a loopback receiver: the bytes received equal [4]'s native file,
    no failover, no underrun, one K1 launch per 4-block window. Then the
    same run profiled, for K1's device time per launch."""
    import math

    blocks = PACED_SECONDS * 10 - 1
    out = {}
    for profiled in (False, True):
        rx = Receiver()
        res = run_child(["-e", FIXTURE, "-d", str(PACED_SECONDS), "-l",
                         LOCATION, "--disable-almanac", "-r", "tcp",
                         "--realtime", "--tcp-addr", f"127.0.0.1:{rx.port}",
                         "--backend", "cuda"], profiled)
        rx.join()
        path = os.path.join(workdir, "paced.bin")
        with open(path, "wb") as fp:
            fp.write(rx.received)
        what = "paced run" + (" (profiled)" if profiled else "")
        files_equal(what, os.path.join(workdir, "native.bin"), path,
                    blocks=blocks)
        want = math.ceil(blocks / PACED_WINDOW)
        if (res["rc"] != 0 or res["blocks"] != blocks or res["failovers"]
                or res["underruns"] or res["launches"]["K1"] != want
                or res["launches"]["K2"]):
            raise AssertionError(f"{what}: {res} (expected {blocks} blocks, "
                                 f"0 failovers, 0 underruns, K1 {want})")
        k1 = res["k1_profiled"]
        print(f"  {what}: {blocks} blocks, wall {res['wall_s']:.3f} s "
              f"(process {res['process_wall_s']:.3f} s), x"
              f"{res['realtime_x']:.4f} realtime, {res['underruns']} "
              f"underruns, {res['failovers']} failovers, launches "
              f"{res['launches']}; K1 device time per launch "
              + (f"{k1['device_ms_per_launch']:.4f} ms over "
                 f"{k1['launches']}, device busy {k1['device_busy_ms']:.3f} "
                 f"ms, idle share {k1['idle_share']:.5f}"
                 if k1 else "not measured" if profiled else "(next run)")
              + "; bytes received equal to --backend native")
        out["profiled" if profiled else "plain"] = res
    out["launches"] = out["plain"]["launches"]
    return out


class Throttle:
    """``ops.args.pack_args`` stalls 0.6 s per window (more than a paced
    window's 0.4 s of signal) from start() for ``seconds``: a deficit on
    the device path's host side, which the failback probe's own windows
    go through too."""

    def __init__(self, seconds: float):
        import gpssim_tpu_torch.ops.args as args_mod

        self.mod, self.real, self.seconds = args_mod, args_mod.pack_args, seconds
        self.until = 0.0

    def pack(self, args):
        if time.perf_counter() < self.until:
            time.sleep(0.6)
        return self.real(args)

    def __enter__(self):
        self.until = time.perf_counter() + self.seconds
        self.mod.pack_args = self.pack
        return self

    def __exit__(self, *exc):
        self.mod.pack_args = self.real


def check_round_trip(what: str, stats) -> None:
    probe_errors = [e for e in stats.events if "probe failed" in e]
    if stats.failovers < 1 or stats.failbacks < 1 or probe_errors:
        raise AssertionError(f"{what}: failovers {stats.failovers}, "
                             f"failbacks {stats.failbacks}, events "
                             f"{stats.events}")


def failover_round_trip(workdir: str) -> dict:
    """[4f] in-process: a paced 12 s 3 Msps run whose pack_args stalls for
    its first 2 s fails over to the native engine, then fails back on the
    production probe margin; the bytes equal --backend native, every
    block is written and K1 launches after the failback."""
    from gpssim_tpu_torch.config import LocationConfig, SimConfig, SynthBackend
    from gpssim_tpu_torch.runner import DeviceProbe, run_simulation

    ref = os.path.join(workdir, "native_rt.bin")
    run_cli("native", ref, seconds=ROUNDTRIP_SECONDS)
    lat, lon, hgt = (float(v) for v in LOCATION.split(","))
    cfg = SimConfig(nav_file=FIXTURE, duration_sec=float(ROUNDTRIP_SECONDS),
                    almanac_enable=False, location=LocationConfig(lat, lon,
                                                                  hgt),
                    backend=SynthBackend.CUDA, realtime=True,
                    failback_probe_sec=0.5,
                    out_file=os.path.join(workdir, "roundtrip.bin"))
    seen = []  # (failbacks, K1 launches) at each hook call

    def hook(stats, sim, plan):
        seen.append((stats.failbacks, read_launches()["K1"]))

    reset_launches()
    with Throttle(THROTTLE_SECONDS):
        stats = run_simulation(cfg, on_block=hook)
    launches = read_launches()
    check_round_trip("failover round trip", stats)
    before = max(n for fb, n in seen if fb == 0)
    blocks = ROUNDTRIP_SECONDS * 10 - 1
    files_equal("failover round trip", ref, cfg.out_file, blocks=blocks)
    if stats.blocks != blocks or launches["K1"] <= before:
        raise AssertionError(f"failover round trip: {stats.blocks} blocks, "
                             f"K1 {launches['K1']} launches, {before} "
                             "before the failback")
    print(f"  failover round trip (margin {DeviceProbe.MARGIN:g}): "
          f"{stats.failovers} failovers, {stats.failbacks} failbacks, "
          f"failover_latency_s {stats.failover_latency_s:.6f}, "
          f"{stats.underruns} underruns; K1 {launches['K1']} launches, "
          f"{launches['K1'] - before} after the failback; bytes equal to "
          "--backend native")
    for e in stats.events:
        print(f"    event: {e}")
    return dict(launches=launches, failovers=stats.failovers,
                failbacks=stats.failbacks,
                failover_latency_s=stats.failover_latency_s,
                launches_after_failback=launches["K1"] - before,
                events=stats.events, wall_s=stats.wall_seconds)


def paced_fleet(workdir: str) -> dict:
    """[4g] a paced ``--fleet`` of [4c]'s roster for 5 s, each member
    equal to its solo native run with no failover; then a 2-member paced
    fleet whose pack_args stalls for 2 s fails over and back, each member
    equal to its solo native run."""
    import math

    from gpssim_tpu_torch import cli
    from gpssim_tpu_torch.config import SimConfig, SynthBackend
    from gpssim_tpu_torch.fleet import (
        member_configs, parse_fleet_file, run_fleet,
    )

    roster = os.path.join(workdir, "roster.csv")
    blocks = FLEET_SECONDS * 10 - 1
    reset_launches()
    rc, stats = cli.run(["-e", FIXTURE, "-d", str(FLEET_SECONDS),
                         "--disable-almanac", "-r", "iqfile", "--realtime",
                         "--backend", "cuda", "--fleet", roster,
                         "--out-file", os.path.join(workdir, "rt.bin")])
    launches = read_launches()
    want = math.ceil(blocks * len(FLEET_ROSTER)
                     / (PACED_WINDOW * len(FLEET_ROSTER)))
    for i in range(len(FLEET_ROSTER)):
        files_equal(f"paced fleet member {i}",
                    os.path.join(workdir, f"solo{i}.bin"),
                    os.path.join(workdir, f"rt_m{i}.bin"), blocks=blocks)
    if rc or stats[0].failovers or launches["K1"] != want or launches["K2"]:
        raise AssertionError(f"paced fleet: rc {rc}, {stats[0].failovers} "
                             f"failovers, launches {launches} (K1 {want})")
    wall = max(st.wall_seconds for st in stats)
    print(f"  paced --fleet ({len(stats)} x {blocks} blocks): wall "
          f"{wall:.3f} s, {stats[0].failovers} failovers, launches "
          f"{launches}; every member equal to its solo native run")

    two = FLEET_ROSTER[:2]
    seconds = ROUNDTRIP_SECONDS - 4
    solo = []
    for i, loc in enumerate(two):
        solo.append(os.path.join(workdir, f"solo_rt{i}.bin"))
        run_cli("native", solo[-1], seconds=seconds, location=loc)
    path = os.path.join(workdir, "two.csv")
    with open(path, "w") as fp:
        fp.write("\n".join(two) + "\n")
    base = SimConfig(nav_file=FIXTURE, duration_sec=float(seconds),
                     almanac_enable=False, backend=SynthBackend.CUDA,
                     realtime=True, failback_probe_sec=0.5, sink="iqfile",
                     out_file=os.path.join(workdir, "rtt.bin"))
    reset_launches()
    with Throttle(THROTTLE_SECONDS):
        tstats = run_fleet(member_configs(base, parse_fleet_file(path)))
    tlaunches = read_launches()
    check_round_trip("fleet round trip", tstats[0])
    for i, ref in enumerate(solo):
        files_equal(f"fleet round trip member {i}", ref,
                    os.path.join(workdir, f"rtt_m{i}.bin"),
                    blocks=seconds * 10 - 1)
    print(f"  2-member paced fleet round trip: {tstats[0].failovers} "
          f"failovers, {tstats[0].failbacks} failbacks, failover_latency_s "
          f"{tstats[0].failover_latency_s:.6f}; launches {tlaunches}; every "
          "member equal to its solo native run")
    return dict(launches=launches, wall_s=wall,
                roundtrip=dict(launches=tlaunches,
                               failovers=tstats[0].failovers,
                               failbacks=tstats[0].failbacks,
                               failover_latency_s=(
                                   tstats[0].failover_latency_s),
                               events=tstats[0].events))


def queued_sim(cfg, written):
    """[4h] a Simulation whose ``set_motion`` (what the TUI's keys call,
    from the key thread) queues the edit with ``written()`` — the blocks
    written when the key was sent — and whose ``step`` applies the queue
    before it plans a block. ``landed`` records (planned index the edit
    landed at, counted from 0; the set_motion kwargs; blocks written at
    the send)."""
    from gpssim_tpu_torch.scenario import Simulation

    class Queued(Simulation):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.lock = threading.Lock()
            self.queue, self.landed = [], []

        def set_motion(self, **kw):
            with self.lock:
                self.queue.append((kw, written()))

        def step(self):
            with self.lock:
                queue, self.queue = self.queue, []
            for kw, sent in queue:
                super().set_motion(**kw)
                self.landed.append((self._iumd - 1, kw, sent))
            return super().step()

    return Queued(cfg)


def replayed_sim(cfg, landed):
    """A Simulation that applies each recorded edit just before it plans
    the block the edit landed at."""
    from gpssim_tpu_torch.scenario import Simulation

    edits = {}
    for index, kw, _ in landed:
        edits.setdefault(index + 1, []).append(kw)  # _iumd counts from 1

    class Replayed(Simulation):
        def step(self):
            for kw in edits.get(self._iumd, ()):
                self.set_motion(**kw)
            return super().step()

    return Replayed(cfg)


def interactive_e2e(workdir: str) -> dict:
    """[4h] an interactive paced run (``interactive=True, realtime=True``,
    ``--backend cuda``, ``-r iqfile``) steered by keys: a thread calls the
    real key map, ``TuiApp.handle_key``, every 0.2 s on a TuiApp that is
    built but never run under curses. The recorded edits, replayed at
    their planned indices on ``--backend native``, give the same bytes;
    no failover, no underrun, and no key waits more than the runner's
    structural worst case, two windows (2 x 4 = ``fifo_depth`` = 8
    blocks), to reach the stream."""
    from gpssim_tpu_torch.config import LocationConfig, SimConfig, SynthBackend
    from gpssim_tpu_torch.io.sinks import make_configured_sink
    from gpssim_tpu_torch.runner import dispatch_window, run_simulation
    from gpssim_tpu_torch.tui import TuiApp

    lat, lon, hgt = (float(v) for v in LOCATION.split(","))
    cfg = SimConfig(nav_file=FIXTURE, duration_sec=float(KEY_SECONDS),
                    almanac_enable=False, location=LocationConfig(lat, lon,
                                                                  hgt),
                    backend=SynthBackend.CUDA, interactive=True,
                    realtime=True,
                    out_file=os.path.join(workdir, "interactive.bin"))
    sink = make_configured_sink(cfg)
    sim = queued_sim(cfg, lambda: app.stats.blocks if app.stats else 0)
    app = TuiApp(cfg, sim, sink)
    done = threading.Event()
    sent = []

    def keys():
        while not done.wait(0.2):
            key = KEYS[len(sent) % len(KEYS)]
            app.handle_key(ord(key))
            sent.append(key)

    def hook(stats, sim, plan):  # as TuiApp.run's own hook
        app.stats = stats

    thread = threading.Thread(target=keys, daemon=True, name="keys")
    reset_launches()
    thread.start()
    try:
        stats = run_simulation(cfg, sink=sink, sim=sim, on_block=hook)
    finally:
        done.set()
        thread.join(5)
    launches = read_launches()
    blocks = KEY_SECONDS * 10 - 1
    lat_blocks = [index - at for index, _, at in sim.landed]
    if not lat_blocks:
        raise AssertionError(f"[4h]: no edit landed ({len(sent)} sent)")

    ref = SimConfig(**{**cfg.__dict__, "backend": SynthBackend.NATIVE,
                       "realtime": False,
                       "out_file": os.path.join(workdir, "replayed.bin")})
    run_simulation(ref, sim=replayed_sim(ref, sim.landed))
    files_equal("interactive run against its native replay", ref.out_file,
                cfg.out_file, blocks=blocks)
    want = -(-blocks // PACED_WINDOW)
    # Two windows of W blocks are in flight: a key sent as window i-1
    # starts to drain (window i planned) lands at the first block of
    # window i+1, 2W blocks after the written stream, as in the JAX
    # package's runner (tests/test_torch_interactive.py); 2W = fifo_depth.
    bound = 2 * dispatch_window(cfg)
    if (stats.blocks != blocks or stats.failovers or stats.underruns
            or launches["K1"] != want or launches["K2"]
            or max(lat_blocks) > bound):
        raise AssertionError(
            f"[4h]: {stats.blocks} blocks, {stats.failovers} failovers, "
            f"{stats.underruns} underruns, launches {launches} (K1 {want}),"
            f" latency {lat_blocks} blocks (at most {bound})")
    print(f"  interactive paced run: {len(sent)} keys sent, "
          f"{len(sim.landed)} edits landed; key-to-stream latency median "
          f"{statistics.median(lat_blocks)} blocks, max {max(lat_blocks)} "
          f"(bound {bound}); {stats.blocks} blocks, wall "
          f"{stats.wall_seconds:.3f} s, {stats.underruns} underruns, "
          f"{stats.failovers} failovers; launches {launches}; bytes equal "
          "to the edits replayed on --backend native")
    return dict(launches=launches, keys_sent=len(sent),
                edits_landed=len(sim.landed),
                latency_blocks_median=statistics.median(lat_blocks),
                latency_blocks_max=max(lat_blocks), blocks=stats.blocks,
                wall_s=stats.wall_seconds, underruns=stats.underruns,
                failovers=stats.failovers)


def build_mock(workdir: str, name: str, tag: str) -> str:
    """``native/<name>.c`` built with ``cc`` into a library of its own (a
    mock keeps its capture in global state: one fresh copy per run)."""
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler (cc) to build the mock radios")
    out = os.path.join(workdir, f"lib{name}_{tag}.so")
    subprocess.run([cc, "-O2", "-shared", "-fPIC", "-pthread", "-o", out,
                    os.path.join(REPO, "native", f"{name}.c")],
                   check=True, capture_output=True, timeout=120)
    return out


def radios_e2e(workdir: str) -> dict:
    """[4i] interactive runs into the mock HackRF (8-bit, 24 blocks) and
    the mock Pluto (16-bit, 8 blocks: its whole capture), each sink
    binding its library itself (``HackRfSink(lib_path=...)``, as ``-r
    hackrf`` does): the capture of ``--backend cuda`` equals that of
    ``--backend native`` through a fresh copy of the same mock (whole
    262,144-byte transfers for the HackRF), and the mock saw a clean
    teardown."""
    import ctypes

    import numpy as np

    from gpssim_tpu_torch.config import (
        LocationConfig, SampleFormat, SimConfig, SynthBackend,
    )
    from gpssim_tpu_torch.io.hw_hackrf import TRANSFER_SIZE
    from gpssim_tpu_torch.io.sinks import make_sink
    from gpssim_tpu_torch.runner import run_simulation

    lat, lon, hgt = (float(v) for v in LOCATION.split(","))
    out = {}
    for radio, mock_name, seconds, fmt in (
            ("hackrf", "mock_hackrf", HACKRF_SECONDS, SampleFormat.SC08),
            ("plutosdr", "mock_iio", PLUTO_SECONDS, SampleFormat.SC16)):
        blocks = int(seconds * 10 + 0.5) - 1
        nbytes = blocks * 2 * 300_000 * fmt.value // 8
        if radio == "hackrf":
            nbytes = nbytes // TRANSFER_SIZE * TRANSFER_SIZE
        caps, res = {}, {}
        for backend in ("cuda", "native"):
            path = build_mock(workdir, mock_name, backend)
            cfg = SimConfig(nav_file=FIXTURE, duration_sec=seconds,
                            almanac_enable=False,
                            location=LocationConfig(lat, lon, hgt),
                            backend=SynthBackend(backend), interactive=True,
                            sink=radio, sample_format=fmt,
                            pluto_gain_boost=radio == "plutosdr")
            reset_launches()
            t = time.perf_counter()
            stats = run_simulation(cfg, sink=make_sink(radio, lib_path=path))
            wall = time.perf_counter() - t
            launches = read_launches()
            mock = ctypes.CDLL(path)
            mock.mock_copy_capture.restype = ctypes.c_long
            got = np.empty(nbytes, dtype=np.int8)
            n = mock.mock_copy_capture(got.ctypes.data_as(ctypes.c_void_p),
                                       nbytes)
            if (stats.blocks != blocks or mock.mock_captured_bytes() != nbytes
                    or n != nbytes or mock.mock_teardown_ok() != 1):
                raise AssertionError(
                    f"[4i] {radio} --backend {backend}: {stats.blocks} "
                    f"blocks, {mock.mock_captured_bytes()} bytes captured "
                    f"(expected {nbytes}), teardown ok "
                    f"{mock.mock_teardown_ok()}")
            caps[backend] = got
            res[backend] = dict(launches=launches, wall_s=wall,
                                blocks=stats.blocks)
        if not np.array_equal(caps["cuda"], caps["native"]):
            bad = np.flatnonzero(caps["cuda"] != caps["native"])
            raise AssertionError(f"[4i] {radio}: capture != --backend native"
                                 f" ({len(bad)} bytes differ, first at "
                                 f"{int(bad[0])})")
        want = -(-blocks // PACED_WINDOW)
        launches = res["cuda"]["launches"]
        if launches["K1"] != want or launches["K2"]:
            raise AssertionError(f"[4i] {radio}: launches {launches} "
                                 f"(expected K1 {want})")
        print(f"  {radio} mock: {blocks} blocks, {nbytes} bytes captured, "
              f"equal to --backend native's capture; teardown ok; launches "
              f"{launches}; wall {res['cuda']['wall_s']:.3f} s (native "
              f"{res['native']['wall_s']:.3f} s)")
        out[radio] = dict(res["cuda"], bytes=nbytes,
                          native_wall_s=res["native"]["wall_s"])
    return out


def fleet_member_configs(workdir: str) -> list:
    """The member configs of [4c]'s ``--fleet`` run, as the CLI made them
    from its flags and the roster."""
    from gpssim_tpu_torch import cli
    from gpssim_tpu_torch.fleet import member_configs, parse_fleet_file

    roster = os.path.join(workdir, "roster.csv")
    args = cli.build_parser().parse_args([
        "-e", FIXTURE, "-d", str(FLEET_SECONDS), "--disable-almanac", "-r",
        "iqfile", "--backend", "cuda", "--fleet", roster, "--out-file",
        os.path.join(workdir, "fleet.bin")])
    return member_configs(cli.args_to_config(args), parse_fleet_file(roster))


def qa_e2e(workdir: str) -> dict:
    """[4j] ``qa.verify_stream`` on the card on [4c]'s fleet member files,
    each against its member config: all verify; a copy of member 0 with
    block 10 zeroed fails. The time of the correlations (``qa.correlate``,
    synchronized) is kept apart from the rest (the host's replicas, the
    reads and the copies to the card). Member 0 again on the host CPU, for
    scale: the same verdicts, ratios within 1e-4."""
    import dataclasses

    import numpy as np
    import torch

    from gpssim_tpu_torch import qa

    cfgs = fleet_member_configs(workdir)
    blocks = FLEET_SECONDS * 10 - 1
    correlate, spent = qa.correlate, []

    def timed_correlate(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = correlate(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    qa.correlate = timed_correlate
    try:
        members = []
        for i, cfg in enumerate(cfgs):
            spent.clear()
            t = time.perf_counter()
            rep = qa.verify_stream(cfg.out_file, cfg)
            wall = time.perf_counter() - t
            if not rep.ok or rep.blocks != blocks:
                raise AssertionError(f"[4j] member {i}: {rep}")
            members.append(dict(
                wall_s=wall, correlate_s=sum(spent),
                channels=len(rep.channels),
                min_ratio=min(c.min_ratio for c in rep.channels),
                mean_ratios=[c.mean_ratio for c in rep.channels]))
            print(f"  member {i}: {rep.blocks} blocks, {len(rep.channels)} "
                  f"PRNs verified in {wall:.3f} s on the card (correlations"
                  f" {sum(spent):.3f} s, the rest {wall - sum(spent):.3f} "
                  "s)")
    finally:
        qa.correlate = correlate
    raw = np.fromfile(cfgs[0].out_file, np.int8)
    block = 2 * cfgs[0].samples_per_epoch
    raw[10 * block:11 * block] = 0
    bad = os.path.join(workdir, "qa_damaged.bin")
    raw.tofile(bad)
    t = time.perf_counter()
    rep_bad = qa.verify_stream(bad, cfgs[0])
    bad_wall = time.perf_counter() - t
    if rep_bad.ok:
        raise AssertionError("[4j] member 0 with block 10 zeroed verified")
    print(f"  member 0 with block 10 zeroed: FAILED as it must (worst ratio "
          f"{min(c.min_ratio for c in rep_bad.channels):.4f}), "
          f"{bad_wall:.3f} s")
    t = time.perf_counter()
    rep_cpu = qa.verify_stream(cfgs[0].out_file,
                               dataclasses.replace(cfgs[0], device="cpu"))
    cpu_wall = time.perf_counter() - t
    err = max(abs(a - c.mean_ratio) for a, c in
              zip(members[0]["mean_ratios"], rep_cpu.channels))
    if not rep_cpu.ok or len(rep_cpu.channels) != members[0]["channels"] \
            or err >= 1e-4:
        raise AssertionError(f"[4j] member 0 on the host CPU: {rep_cpu} "
                             f"(mean ratios differ by up to {err})")
    per = statistics.median(m["wall_s"] for m in members)
    print(f"  {len(members)} members: median {per:.3f} s per member on the "
          f"card; member 0 on the host CPU {cpu_wall:.3f} s (same verdicts, "
          f"mean ratios within {err:.2e})")
    return dict(members=members, s_per_member_median=per,
                damaged_wall_s=bad_wall, cpu_wall_s=cpu_wall,
                cpu_max_mean_ratio_diff=err)


def acquire_e2e(workdir: str) -> dict:
    """[4k] ``acquire(backend="torch")`` on the card on [4]'s native file
    against ``backend="numpy"``: the same PRNs, Doppler bins and code
    phases, SNR within 1e-2; both timed (the torch search's first call,
    with cuFFT's plans, and the median of 5 after it)."""
    import torch

    from gpssim_tpu_torch.acquire import acquire, load_iq

    x = load_iq(os.path.join(workdir, "native.bin"), 8)
    t = time.perf_counter()
    ref = acquire(x)
    numpy_s = time.perf_counter() - t

    def on_card():
        t = time.perf_counter()
        got = acquire(x, backend="torch", device="cuda")
        torch.cuda.synchronize()
        return got, time.perf_counter() - t

    got, first_s = on_card()
    warm = [on_card()[1] for _ in range(5)]
    a = {d.prn: d for d in got}
    b = {d.prn: d for d in ref}
    if set(a) != set(b) or not b:
        raise AssertionError(f"[4k] PRNs {sorted(a)} on the card, "
                             f"{sorted(b)} by numpy")
    snr_err = 0.0
    for prn, d in b.items():
        if (a[prn].doppler_hz, a[prn].code_phase_chips) != (
                d.doppler_hz, d.code_phase_chips):
            raise AssertionError(f"[4k] PRN {prn}: {a[prn]} vs {d}")
        snr_err = max(snr_err, abs(a[prn].snr - d.snr) / d.snr)
    if snr_err >= 1e-2:
        raise AssertionError(f"[4k] SNR differs by {snr_err:.3e} relative")
    warm_s = statistics.median(warm)
    print(f"  {len(b)} PRNs, same Doppler bins and code phases, SNR within "
          f"{snr_err:.2e} relative; torch on the card {first_s:.4f} s first "
          f"call, {warm_s:.4f} s median of 5 after; numpy {numpy_s:.4f} s")
    return dict(prns=sorted(b), torch_first_s=first_s, torch_s=warm_s,
                torch_runs_s=warm, numpy_s=numpy_s, snr_rel_err=snr_err)


def entry_e2e() -> dict:
    """[4l] ``entry()`` on the card: its one K1 launch byte-equal to K1's
    plain version on the same args; then ``dryrun_multichip(2, devices=
    ["cuda:0"] * 2)``, all nine passes, with K1 and K2 launched in this
    process and K1 in the gloo children of passes 8 and 9 (their counts
    come back on a JSON line each)."""
    from gpssim_tpu_torch.entry import dryrun_multichip, entry
    from gpssim_tpu_torch.ops.args import ARG_ORDER, LANES
    from gpssim_tpu_torch.ops.synth_torch import synth_blocks_batch_torch

    fn, ex = entry()
    reset_launches()
    got = fn(*ex)
    launches = read_launches()
    want = synth_blocks_batch_torch(dict(zip(ARG_ORDER, ex)),
                                    n_rows=-(-300_000 // LANES),
                                    num_samples=300_000)
    if launches != {"K1": 1, "K2": 0}:
        raise AssertionError(f"[4l] entry() launches {launches}")
    err = max_diff("entry() against K1's plain version", got, want,
                   f"B={got.shape[0]} N=300000 launches {launches}")
    ms = time_ms(lambda: fn(*ex), 11, 5, inner=20)
    dev = device_ms(lambda: fn(*ex), "synth_k1_kernel")
    print(f"  entry(): {ms:.4f} ms per call (events), device "
          + (f"{dev:.4f} ms per launch" if dev else "not measured"))

    reset_launches()
    t = time.perf_counter()
    res = dryrun_multichip(2, devices=["cuda:0"] * 2)
    wall = time.perf_counter() - t
    dry = read_launches()
    kids = res["child_launches"]
    if len(res["passes"]) != 9 or dry["K1"] < 1 or dry["K2"] < 1 \
            or kids["K1"] < 1 or set(res["child_backends"].values()) != {
                "gloo"}:
        raise AssertionError(f"[4l] dryrun: {res}, launches here {dry}")
    print(f"  dryrun_multichip(2) on cuda:0: {len(res['passes'])} passes in "
          f"{wall:.3f} s; launches in this process {dry}, in the children "
          f"{kids}; pass walls " + ", ".join(
              f"{k} {v:.3f} s" for k, v in res["wall_s"].items()))
    return dict(launches=launches, max_abs_err=err, ms=ms, device_ms=dev,
                dryrun=dict(res, wall_s_total=wall, launches=dry))


def stage_timers() -> dict:
    """[4m] in a rank's process: wrap the host stages that
    ``run_scenario_multihost`` calls (planning, collation, the mesh
    synthesis with its copies, the strict-parity corrections) so that
    each adds its seconds to the returned dict. The rest of a run's wall
    is the part file's writes and bookkeeping."""
    import gpssim_tpu_torch.ops.args as args_mod
    import gpssim_tpu_torch.ops.synth_seq as seq_mod
    from gpssim_tpu_torch.parallel import multihost
    from gpssim_tpu_torch.scenario import Simulation

    spent = dict(plan_s=0.0, collate_s=0.0, synth_s=0.0, corrections_s=0.0)

    def timed(name, fn):
        def wrapper(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return wrapper

    args_mod.collate_plans = timed("collate_s", args_mod.collate_plans)
    seq_mod.seq_corrections = timed("corrections_s", seq_mod.seq_corrections)
    seq_mod.apply_corrections = timed("corrections_s",
                                      seq_mod.apply_corrections)
    multihost.synthesize_multihost = timed("synth_s",
                                           multihost.synthesize_multihost)
    plans = Simulation.iter_plans

    def iter_plans(self):
        it = plans(self)
        while True:
            t = time.perf_counter()
            plan = next(it, None)
            spent["plan_s"] += time.perf_counter() - t
            if plan is None:
                return
            yield plan

    Simulation.iter_plans = iter_plans
    return spent


def chan_major_stream(cfg) -> tuple:
    """[4m] ``cfg``'s whole scenario through ``synthesize_chan_major`` on
    a chan-major mesh with one column per rank (this rank's cards), in
    windows of WINDOW blocks on the full channel axis, then the
    strict-parity corrections: (sha256 of the stream, wall seconds)."""
    import hashlib
    import itertools

    from gpssim_tpu_torch.ops.args import LANES, collate_plans
    from gpssim_tpu_torch.ops.synth_seq import (
        apply_corrections, seq_corrections_window,
    )
    from gpssim_tpu_torch.parallel import multihost
    from gpssim_tpu_torch.parallel.shard import pad_batch, pad_channels
    from gpssim_tpu_torch.scenario import Simulation

    t = time.perf_counter()
    mesh = multihost.global_mesh_chan_major()
    nb, nc = mesh.shape["blocks"], mesh.shape["chan"]
    n = cfg.samples_per_epoch
    sha = hashlib.sha256()
    it = Simulation(cfg).iter_plans()
    while plans := list(itertools.islice(it, WINDOW)):
        batch = collate_plans(plans, compact=False)
        args, _ = pad_batch(pad_channels(batch.args, nc), nb)
        out = multihost.synthesize_chan_major(args, mesh, -(-n // LANES), n,
                                              out_bits=8)
        for blk, corr in zip(out, seq_corrections_window(plans)):
            sha.update(apply_corrections(blk.copy(), 8, *corr).tobytes())
    return sha.hexdigest(), time.perf_counter() - t


def profiled_device_ms(fn, name: str, calls: int, before=None
                       ) -> float | None:
    """Device time per call of the kernels whose names hold ``name``,
    from torch.profiler over ``calls`` calls of ``fn``, each after
    ``before()`` and followed by a synchronize (exactly ``calls`` calls:
    every rank of a collective makes the same ones), or None where the
    profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if before is not None:
                before()
            fn()
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
    if not sum(e.count for e in events):
        return None
    return sum(e.self_device_time_total for e in events) / calls / 1e3


def allreduce_times(rank: int, world: int, card: int) -> dict:
    """[4m] the chan-major sum of one 25-block, 12-channel window at 3
    Msps over every rank, one card each: ``sum_over_processes`` of int16
    raw rows (2, 25, 2368, 128) drawn from seed ``rank``, summed as int32
    (60.6 MB). Its result is held against the int16 sum of every rank's
    rows, made here from their seeds. Times, over ALLREDUCE_CALLS calls
    each, every call after a barrier of the ranks on the host (so that
    they launch together: an NCCL kernel's device time also holds its
    wait for the last rank to launch): NCCL's all-reduce kernel on the
    card (profiler, per call) and the NCCL path's wall (host clock,
    synchronized); then the same sum through a gloo group of the same
    ranks (a pinned copy to the host, the all-reduce, the copy back) on
    the host's clock."""
    import torch
    import torch.distributed as dist

    from gpssim_tpu_torch.parallel.multihost import sum_over_processes

    dev = torch.device("cuda", card)
    shape = (2, 25, 2368, 128)

    def rows(r):
        g = torch.Generator().manual_seed(r)
        return torch.randint(-2 ** 15, 2 ** 15, shape, generator=g,
                             dtype=torch.int16)

    mine = [rows(rank).to(dev)]
    want = sum(rows(r).to(torch.int32) for r in range(world)).to(torch.int16)
    if not torch.equal(sum_over_processes(mine, dev).cpu(), want):
        raise AssertionError(f"rank {rank}: NCCL sum != the int16 sum of "
                             "every rank's rows")
    gloo = dist.new_group(backend="gloo")
    if not torch.equal(sum_over_processes(mine, dev, gloo).cpu(), want):
        raise AssertionError(f"rank {rank}: gloo sum != the int16 sum")
    buf = torch.empty(shape, dtype=torch.int32, device=dev)

    def walls(fn):
        out = []
        for _ in range(ALLREDUCE_CALLS):
            dist.barrier(group=gloo)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            out.append(time.perf_counter() - t)
        return out

    nccl_ms = profiled_device_ms(lambda: dist.all_reduce(buf), "AllReduce",
                                 ALLREDUCE_CALLS,
                                 before=lambda: dist.barrier(group=gloo))
    nccl_wall = walls(lambda: sum_over_processes(mine, dev))
    gloo_wall = walls(lambda: sum_over_processes(mine, dev, gloo))
    return dict(bytes=buf.numel() * 4, nccl_device_ms=nccl_ms,
                nccl_wall_ms=statistics.median(nccl_wall) * 1e3,
                gloo_wall_ms=statistics.median(gloo_wall) * 1e3,
                nccl_wall_ms_runs=[w * 1e3 for w in nccl_wall],
                gloo_wall_ms_runs=[w * 1e3 for w in gloo_wall])


def rank_child(spec: dict, rank: int) -> None:
    """[4m] one rank of a multi-process run, in its own process: join the
    group on ``spec["cards"][rank]`` (``local_device_ids``: NCCL), run
    the blocks-axis scenario (``run_scenario_multihost``: its part file,
    its host stages timed), then the chan-major stream
    (:func:`chan_major_stream`) and, with more than one rank, the sum's
    timings (:func:`allreduce_times`). Prints one JSON line: the backend,
    the launches of each run, the stages, the sha256 of the chan-major
    stream and the wall-clock ends of the set-up and the blocks-axis run."""
    import torch.distributed as dist

    from gpssim_tpu_torch.config import LocationConfig, SimConfig, SynthBackend
    from gpssim_tpu_torch.parallel import multihost

    world, cards = spec["world"], spec["cards"][rank]
    backend = multihost.initialize(spec["coord"], world, rank,
                                   local_device_ids=cards)
    spent = stage_timers()
    lat, lon, hgt = (float(v) for v in LOCATION.split(","))
    cfg = SimConfig(nav_file=FIXTURE, duration_sec=float(MULTI_SECONDS),
                    almanac_enable=False,
                    location=LocationConfig(lat, lon, hgt),
                    backend=SynthBackend.CUDA, out_file=spec["out"])
    dist.barrier(device_ids=[cards[0]])  # the NCCL communicator: set-up
    t_ready = time.time()
    reset_launches()
    t = time.perf_counter()
    multihost.run_scenario_multihost(cfg)
    blocks_wall = time.perf_counter() - t
    t_blocks = time.time()
    blocks_launches = read_launches()
    stages = dict(spent, wall_s=blocks_wall)
    stages["write_other_s"] = blocks_wall - sum(spent.values())
    reset_launches()
    sha, chan_wall = chan_major_stream(cfg)
    chan_launches = read_launches()
    sums = allreduce_times(rank, world, cards[0]) if world > 1 else None
    multihost.shutdown()
    print(json.dumps(dict(
        backend=backend, cards=cards, t_ready=t_ready, t_blocks=t_blocks,
        stages=stages, blocks_launches=blocks_launches, chan_sha=sha,
        chan_wall_s=chan_wall, chan_launches=chan_launches,
        allreduce=sums)))


_RANK_CHILD = """
import json, sys
sys.path.insert(0, {repo!r})
import chip_smoke
chip_smoke.rank_child(json.loads({spec!r}), int(sys.argv[1]))
"""


def multi_rank(workdir: str, world: int, ref: str) -> dict:
    """[4m] ``world`` ranks, rank r on card r (an NCCL group; one rank on
    cuda:0 where there is one card): the merged blocks-axis stream and
    every rank's chan-major stream equal ``ref`` (the 30 s native run).
    The blocks-axis rate counts from the moment every rank was ready to
    the last rank's part file, plus ``merge_parts``."""
    import hashlib

    from gpssim_tpu_torch.entry import _free_port, run_children
    from gpssim_tpu_torch.parallel.multihost import merge_parts

    out = os.path.join(workdir, f"ranks{world}.bin")
    spec = dict(world=world, cards=[[r] for r in range(world)],
                coord=f"tcp://127.0.0.1:{_free_port()}", out=out)
    # NCCL's own log says how the cards are linked (its transports)
    log = os.path.join(workdir, f"nccl{world}")
    env = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_FILE": f"{log}.%p.log"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        res = run_children(_RANK_CHILD.format(
            repo=REPO, spec=json.dumps(spec)), world, timeout=600)
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    links = {}
    for name in os.listdir(workdir):
        if name.startswith(f"nccl{world}."):
            with open(os.path.join(workdir, name), errors="replace") as fp:
                for m in re.finditer(r" via (\S+)", fp.read()):
                    links[m.group(1)] = links.get(m.group(1), 0) + 1
    t = time.perf_counter()
    merge_parts(out, world)
    merge_s = time.perf_counter() - t
    blocks = MULTI_SECONDS * 10 - 1
    files_equal(f"{world}-rank blocks-axis stream", ref, out, blocks=blocks)
    with open(ref, "rb") as fp:
        want = hashlib.sha256(fp.read()).hexdigest()
    bad = [r for r, x in enumerate(res) if x["chan_sha"] != want]
    if bad or {x["backend"] for x in res} != {"nccl"}:
        raise AssertionError(
            f"{world} ranks: backends {[x['backend'] for x in res]}; the "
            f"chan-major streams of ranks {bad} != --backend native")
    launches = {k: sum(x["blocks_launches"][k] + x["chan_launches"][k]
                       for x in res) for k in ("K1", "K2")}
    if launches["K1"] < world or launches["K2"]:
        raise AssertionError(f"{world} ranks: launches {launches}")
    wall = max(x["t_blocks"] for x in res) - min(x["t_ready"] for x in res)
    msps = blocks * 300_000 / (wall + merge_s) / 1e6
    print(f"  {world} rank(s), one card each, over "
          f"{res[0]['backend']}: blocks-axis {blocks} blocks in {wall:.3f} s "
          f"+ merge_parts {merge_s:.3f} s = {msps:.2f} Msps; chan-major "
          "stream walls " + ", ".join(f"{x['chan_wall_s']:.3f}" for x in res)
          + f" s; launches {launches}; every stream equal to --backend "
          f"native; NCCL's links (log lines by transport) {links}")
    for r, x in enumerate(res):
        print(f"    rank {r} host stages: " + ", ".join(
            f"{k[:-2]} {v:.4f} s" for k, v in x["stages"].items()))
    sums = [x["allreduce"] for x in res if x["allreduce"]]
    if sums:
        dev = [x["nccl_device_ms"] for x in sums]
        print(f"    chan-major sum of one 25-block window ({sums[0]['bytes']}"
              " bytes of int32) per call: NCCL all-reduce device "
              + ("not measured" if None in dev else ", ".join(
                  f"{v:.4f}" for v in dev) + " ms by rank")
              + ", NCCL path wall " + ", ".join(
                  f"{x['nccl_wall_ms']:.4f}" for x in sums)
              + " ms, gloo path wall " + ", ".join(
                  f"{x['gloo_wall_ms']:.3f}" for x in sums) + " ms")
    return dict(world=world, backend=res[0]["backend"], launches=launches,
                nccl_links=links, wall_s=wall, merge_s=merge_s, msps=msps,
                stages=[x["stages"] for x in res],
                chan_wall_s=[x["chan_wall_s"] for x in res],
                allreduce=sums or None)


def mesh_cards(window, cards: int, workdir: str) -> dict:
    """[4m] one process over ``cards`` distinct cards: make_sharded_synth
    over a (cards, 1) and a (1, cards) mesh on the 25-block window, with
    K1's raw mode and with the two-stage path, against K1's output on
    cuda:0; then [4c]'s fleet over both meshes, each member against its
    solo native run, its aggregate realtime factor beside [4c]'s."""
    import torch

    from gpssim_tpu_torch.config import SimConfig, SynthBackend
    from gpssim_tpu_torch.fleet import (
        member_configs, parse_fleet_file, run_fleet,
    )
    from gpssim_tpu_torch.ops.synth_cuda import synth_blocks_batch_cuda
    from gpssim_tpu_torch.parallel.shard import (
        make_mesh, make_sharded_synth, pad_batch, pad_channels,
    )

    packed, spec, n, n_rows, wide, args_np = window
    devices = [torch.device("cuda", i) for i in range(cards)]
    want = synth_blocks_batch_cuda(on_card(packed, spec), n_rows=n_rows,
                                   num_samples=n, out_bits=8, wide=wide,
                                   fuse_a=True).cpu()
    out = {}
    for nb, nc in ((cards, 1), (1, cards)):
        mesh = make_mesh(nb, nc, devices=devices)
        batch, pad = pad_batch(pad_channels(args_np, nc), nb)
        for kernel, k in (("cuda-fused", "K1"), ("cuda", "K2")):
            fn = make_sharded_synth(mesh, n_rows, n, wide=wide, out_bits=8,
                                    kernel=kernel)
            reset_launches()
            got = fn(batch).result()
            launches = read_launches()
            got = torch.from_numpy(got[:-pad] if pad else got)
            if launches != {"K1": 0, "K2": 0, k: nb * nc}:
                raise AssertionError(f"({nb}, {nc}) mesh, {kernel}: "
                                     f"launches {launches}")
            max_diff(f"({nb}, {nc}) mesh of distinct cards, kernel {kernel},"
                     " against K1", got, want,
                     f"B={got.shape[0]} N={n} launches {launches}")
            out[f"{nb}x{nc} {kernel}"] = launches
        base = SimConfig(nav_file=FIXTURE, duration_sec=float(FLEET_SECONDS),
                         almanac_enable=False, backend=SynthBackend.CUDA,
                         sink="iqfile",
                         out_file=os.path.join(workdir, f"m{nb}x{nc}.bin"))
        cfgs = member_configs(base, parse_fleet_file(
            os.path.join(workdir, "roster.csv")))
        reset_launches()
        stats = run_fleet(cfgs, mesh=mesh)
        launches = read_launches()
        for i in range(len(cfgs)):
            files_equal(f"({nb}, {nc}) mesh fleet member {i}",
                        os.path.join(workdir, f"solo{i}.bin"),
                        cfgs[i].out_file, blocks=FLEET_SECONDS * 10 - 1)
        if launches["K1"] < nb * nc or launches["K2"]:
            raise AssertionError(f"({nb}, {nc}) mesh fleet: launches "
                                 f"{launches}")
        wall = max(st.wall_seconds for st in stats)
        agg = sum(st.blocks for st in stats) * 0.1 / wall
        print(f"  fleet over a ({nb}, {nc}) mesh of distinct cards: wall "
              f"{wall:.3f} s, aggregate x{agg:.2f} realtime; launches "
              f"{launches}; every member equal to its solo native run")
        out[f"{nb}x{nc} fleet"] = dict(launches=launches, wall_s=wall,
                                       realtime_x_aggregate=agg)
    return out


def multicard_e2e(workdir: str, window, cards: int) -> dict:
    """[4m] the multi-process and mesh paths on ``cards`` distinct cards:
    NCCL ranks (one on cuda:0 on a one-card machine) for the 30 s main
    scenario, blocks-axis and chan-major, against --backend native; with
    two cards or more, also 2 and ``cards`` ranks, one-process meshes over
    distinct cards and ``dryrun_multichip(cards)``."""
    from gpssim_tpu_torch.entry import dryrun_multichip

    ref = os.path.join(workdir, "native30.bin")
    run_cli("native", ref, seconds=MULTI_SECONDS)
    out = {"ranks": {w: multi_rank(workdir, w, ref)
                     for w in sorted({1, min(2, cards), cards})}}
    if cards < 2:
        return out
    out["mesh"] = mesh_cards(window, cards, workdir)
    reset_launches()
    t = time.perf_counter()
    res = dryrun_multichip(cards)
    wall = time.perf_counter() - t
    dry = read_launches()
    want = {"multiproc-dcn": "nccl",
            "multiproc-dcn4": "nccl" if cards >= 4 else "gloo"}
    if len(res["passes"]) != 9 or res["child_backends"] != want \
            or dry["K1"] < 1 or dry["K2"] < 1:
        raise AssertionError(f"dryrun_multichip({cards}): {res}, launches "
                             f"here {dry}")
    print(f"  dryrun_multichip({cards}) over distinct cards: 9 passes in "
          f"{wall:.3f} s, children over {res['child_backends']}; launches "
          f"in this process {dry}, in the children {res['child_launches']}")
    out["dryrun"] = dict(res, wall_s_total=wall, launches=dry)
    return out


def profile_run(what: str, run) -> dict:
    """``run()`` (returning RunStats, or a fleet's list of them) under
    torch.profiler: the host stages (a fleet books them on member 0) and
    the device time by name (kernels and copies, summed over streams)
    against the run's wall time. The device's idle share is 1 - busy/wall
    (a lower bound where one window's copies overlap another's kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = run()
    members = stats if isinstance(stats, list) else [stats]
    st = members[0]
    by_name = {}
    for e in prof.key_averages():  # device-side events: kernels, copies
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = e.self_device_time_total / 1e3
    busy_ms = sum(by_name.values())
    wall_ms = max(m.wall_seconds for m in members) * 1e3
    host = dict(
        plan_ms=st.plan_seconds * 1e3,
        collate_launch_ms=st.synth_seconds * 1e3,
        fetch_wait_ms=st.fetch_seconds * 1e3,
        corrections_ms=st.correct_seconds * 1e3,
    )
    host["sink_other_ms"] = wall_ms - sum(host.values())
    print(f"  profiled {what}, host stages: " + ", ".join(
        f"{k[:-3]} {v:.3f} ms" for k, v in host.items()))
    if not by_name:
        print("  profiler: no device time recorded (not measured)")
        return dict(host, device_busy_ms=None, wall_ms=wall_ms,
                    idle_share=None)
    print(f"  wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
          f"share {1 - busy_ms / wall_ms:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {ms:9.3f} ms  {name[:90]}")
    return dict(host, device_busy_ms=busy_ms, wall_ms=wall_ms,
                idle_share=1 - busy_ms / wall_ms,
                device_ms_by_name=dict(sorted(by_name.items(),
                                              key=lambda kv: -kv[1])[:6]))


def profile_e2e(workdir: str) -> dict:
    """The main path's cuda CLI run again, profiled."""
    return profile_run(
        "cuda CLI", lambda: run_cli("cuda", os.path.join(workdir,
                                                         "prof.bin"))[0])


def time_ms(fn, reps: int, warmup: int, inner: int = 1) -> float:
    """Median per-call device time of ``fn`` (CUDA events around ``inner``
    back-to-back calls, so a short kernel's launch overhead hides behind
    the kernels queued before it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, kernel: str, calls: int = 20) -> float | None:
    """Device time per launch of the kernel whose name holds ``kernel``,
    from torch.profiler over ``calls`` calls of ``fn``: the kernel alone,
    however long the host takes per call (CUDA events around back-to-back
    calls time the host once its time per call nears the kernel's). A run
    that records no such kernel is profiled once more; None, with the
    device events the profiler did see printed, where neither records
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        events = [e for e in device if kernel in e.key]
        n = sum(e.count for e in events)
        if n:
            return sum(e.self_device_time_total for e in events) / n / 1e3
    seen = sorted({e.key[:80] for e in device})
    print(f"  profiler: no {kernel} in two runs of {calls} calls; device "
          f"events seen: {seen if seen else 'none'}")
    return None


def bound(ops: int, nbytes: int, wavefronts: int) -> dict:
    """The least time of the work: the largest of its floors, and which
    binds (``operations``, ``shared`` or ``bytes``)."""
    floors = {"operations": ops / INT32_OPS_PER_S,
              "shared": wavefronts / SHARED_WAVEFRONTS_PER_S,
              "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(floors, key=floors.get)
    return dict(bound_ms=floors[by] * 1e3, bound_by=by,
                floors_ms={k: v * 1e3 for k, v in floors.items()},
                ops=ops, bytes=nbytes, wavefronts=wavefronts)


def kernel_times(window, out_bits: int) -> dict:
    """K1 per window (kernel, plain, kernel, plain in turns)."""
    from gpssim_tpu_torch.ops.synth_cuda import synth_blocks_batch_cuda
    from gpssim_tpu_torch.ops.synth_torch import synth_blocks_batch_torch

    packed, spec, n, n_rows, wide, _ = window
    args = on_card(packed, spec)
    kw = dict(n_rows=n_rows, num_samples=n, out_bits=out_bits, wide=wide)
    plain_a = time_ms(lambda: synth_blocks_batch_torch(args, **kw), 5, 1)
    k_ms = time_ms(lambda: synth_blocks_batch_cuda(args, **kw, fuse_a=True),
                   11, 5, inner=20)
    plain_b = time_ms(lambda: synth_blocks_batch_torch(args, **kw), 5, 1)
    B = packed.shape[0]
    C = args["gain_a"].shape[1]
    return dict(
        ms=k_ms, plain_ms=statistics.median([plain_a, plain_b]),
        **bound(OPS_PER_CHANNEL_SAMPLE * C * B * n,
                packed.nbytes + 2 * 512 * 2 + B * 2 * n * out_bits // 8,
                WAVEFRONTS_PER_WARP_CHANNEL * C * B * n_rows),
        B=B, C=C, N=n,
    )


def k2_times(window, out_bits: int) -> dict:
    """K2 per window over its packed bases, beside its plain version, and
    the two other steps of the two-stage path: the producer and the
    finalize."""
    from gpssim_tpu_torch.ops.synth_cuda import stage_b_packed_cuda
    from gpssim_tpu_torch.ops.synth_torch import (
        finalize_rows, padded_rows, row_bases_packed, stage_b_packed_torch,
    )

    packed_args, spec, n, n_rows, wide, _ = window
    args = on_card(packed_args, spec)
    R = padded_rows(n_rows)

    def producer():
        return row_bases_packed(args["code_l"], args["carr_l"], args["nav"],
                                args["ca_packed"], R, wide)

    bases = producer()
    kw = (bases, args["lane_steps"], args["gain_a"], args["gain_b"], wide)
    rows = stage_b_packed_cuda(*kw)
    plain_a = time_ms(lambda: stage_b_packed_torch(*kw), 5, 1)
    k_ms = time_ms(lambda: stage_b_packed_cuda(*kw), 11, 5, inner=20)
    plain_b = time_ms(lambda: stage_b_packed_torch(*kw), 5, 1)
    prod_ms = time_ms(producer, 11, 2)
    fin_ms = time_ms(lambda: finalize_rows(*rows, n, out_bits), 11, 2)
    B, C = bases.shape[0], args["gain_a"].shape[1]
    small = sum(args[k].numel() * 4 for k in ("lane_steps", "gain_a",
                                               "gain_b")) + 2 * 512 * 2
    return dict(
        ms=k_ms, plain_ms=statistics.median([plain_a, plain_b]),
        **bound(OPS_PER_CHANNEL_SAMPLE * C * B * R * 128,
                bases.nbytes + small + 2 * rows[0].nbytes,
                WAVEFRONTS_PER_WARP_CHANNEL * C * B * R),
        producer_ms=prod_ms, finalize_ms=fin_ms, B=B, C=C, R_pad=R,
    )


def k1_raw_times(window) -> dict:
    """K1's raw mode per window at a (1, 2) mesh shard's shape: half the
    window's channels, all R_pad rows (the mesh fleet launches it once per
    shard and window), held byte for byte against its plain version and
    timed beside it (kernel, plain, kernel, plain in turns)."""
    from gpssim_tpu_torch.ops.synth_cuda import synth_k1_raw
    from gpssim_tpu_torch.ops.synth_torch import (
        padded_rows, synth_batch_torch_raw,
    )

    C = window[5]["gain_a"].shape[1] // 2
    packed, spec, n, n_rows, wide, _ = edited_window(window, channels=C)
    args = on_card(packed, spec)

    def plain():
        return synth_batch_torch_raw(args, n_rows=n_rows, wide=wide,
                                     fuse_a=True)

    def kernel():
        return synth_k1_raw(args, n_rows=n_rows, wide=wide)

    B, R = packed.shape[0], padded_rows(n_rows)
    dev_ms = device_ms(kernel, "synth_k1_kernel")
    err = max(max_diff(f"K1 raw {plane} rows, mesh shard", g, w,
                       f"B={B} R_pad={R} C={C}", pairs=False)
              for plane, g, w in zip("iq", kernel(), plain()))
    plain_a = time_ms(plain, 5, 1)
    k_ms = time_ms(kernel, 11, 5, inner=20)
    plain_b = time_ms(plain, 5, 1)
    return dict(
        ms=k_ms, plain_ms=statistics.median([plain_a, plain_b]),
        **bound(OPS_PER_CHANNEL_SAMPLE * C * B * R * 128,
                packed.nbytes + 2 * 512 * 2 + 2 * B * R * 128 * 2,
                WAVEFRONTS_PER_WARP_CHANNEL * C * B * R),
        device_ms=dev_ms, max_abs_err=err, B=B, C=C, R_pad=R,
    )


def main(argv=()) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=None,
                    help="cards to use (default: every visible card); "
                    "fewer visible raise")
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "gpssim_tpu_torch")):
        print("chip_smoke: run from a checkout holding gpssim_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    visible = torch.cuda.device_count()
    cards = visible if args.cards is None else args.cards
    if not 1 <= cards <= visible:
        raise RuntimeError(f"--cards {cards}: {visible} cards visible")

    # 1. device facts
    smi = device_facts()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {kind}; {visible} visible, {cards} used")
    if cards > 1:
        topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True, timeout=60)
        print(f"  nvidia-smi topo -m (exit {topo.returncode}):\n"
              f"{topo.stdout}{topo.stderr}")

    # 2. build
    built = build_all()
    print("[2] built " + ", ".join(f"{k} in {v:.1f} s"
                                   for k, v in built.items()))
    resources = kernel_resources()

    # 3. kernels against their plain versions on the card
    print("[3] K1 and K2 against their plain versions, byte for byte")
    main_window = fixture_window(3_000_000)
    others = {
        "3 Msps int-NCO": fixture_window(3_000_000, int_nco=True),
        "1.2 Msps wide": fixture_window(1_200_000),
        "6 Msps q2 digits": fixture_window(6_000_000),
    }
    # the windows of a paced run: 4 blocks of one scenario, 12 of a
    # 3-member fleet, both on the full channel axis
    paced = {"paced 4 blocks": fixture_window(3_000_000,
                                              blocks=PACED_WINDOW,
                                              compact=False),
             "paced fleet 12 blocks": paced_fleet_window()}
    others.update(paced)
    others["3 Msps 16 channels"] = edited_window(main_window, channels=16)
    others["3 Msps wrapping gains"] = edited_window(main_window, seed=7)
    windows = [
        ("3 Msps", main_window, 8),
        ("3 Msps", main_window, 16),
        ("3 Msps int-NCO", others["3 Msps int-NCO"], 8),
        ("1.2 Msps wide", others["1.2 Msps wide"], 8),
        ("6 Msps q2 digits", others["6 Msps q2 digits"], 16),
        ("3 Msps 16 channels", others["3 Msps 16 channels"], 8),
        ("3 Msps wrapping gains", others["3 Msps wrapping gains"], 16),
    ] + [(name, w, 8) for name, w in paced.items()]
    # two windows a persistent grid can get wrong: fewer rows than
    # resident CTAs, and B x rows not a multiple of the CTA count
    from gpssim_tpu_torch.ops.synth_torch import padded_rows

    grids = {"3 Msps": k1_grid(main_window, raw=False)}
    few, seven = "1 block, 8 rows", "7 blocks"
    for name, w in ((few, sliced_window(main_window, 1, 1000)),
                    (seven, sliced_window(main_window, 7, main_window[2]))):
        grids[name] = {mode: k1_grid(w, raw=mode == "raw")
                       for mode in ("finalized", "raw")}
        for mode, g in grids[name].items():
            print(f"  K1 grid on {name} ({mode}): {g}")
            if (g["rows"] >= g["resident"] if name == few
                    else g["rows"] % g["resident"] == 0):
                raise AssertionError(f"{name} ({mode}) does not test the "
                                     f"grid's edge: {g}")
        windows += [(name, w, 8), (name, w, 16)]
        others[name] = w
    for name, w in paced.items():
        grids[name] = k1_grid(w, raw=False)
        print(f"  K1 grid on {name}: {grids[name]}")
    print(f"  K1 grid on 3 Msps: {grids['3 Msps']}")
    err = {"K1": max(compare_kernel(name, w, bits)
                     for name, w, bits in windows)}
    err["K2"] = max(compare_two_stage(name, w, bits)
                    for name, w, bits in windows)
    for name, w in [("3 Msps", main_window)] + list(others.items()):
        for k, e in compare_raw_rows(name, w).items():
            err[k] = max(err[k], e)
    from gpssim_tpu_torch.ops.synth_cuda import synth_blocks_batch_cuda

    packed, spec, n, n_rows, wide, _ = main_window
    args = on_card(packed, spec)
    for bits in (8, 16):
        kw = dict(n_rows=n_rows, num_samples=n, out_bits=bits, wide=wide)
        err["K2"] = max(err["K2"], max_diff(
            "K2 two-stage against K1 on 3 Msps",
            synth_blocks_batch_cuda(args, **kw, fuse_a=False),
            synth_blocks_batch_cuda(args, **kw, fuse_a=True),
            f"bits={bits}"))

    # 4. end to end, each path with the launch counts set to 0 before it
    print("[4] CLI end to end, --backend cuda against --backend native")
    workdir = os.path.join(REPO, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        e2e = end_to_end(workdir)
        e2e["profile"] = profile_e2e(workdir)
        print("[4b] two-stage path (GPSSIM_FUSE_A=0) against --backend "
              "native")
        e2e["two_stage"] = two_stage_e2e(workdir)
        print("[4c] --fleet, then the fleet over a (1, 2) one-card mesh, "
              "against solo --backend native runs")
        e2e["fleet"] = fleet_e2e(workdir)
        print("[4d] make_sharded_synth(kernel='cuda') on a (1, 2) one-card "
              "mesh")
        e2e["sharded"] = sharded_window(main_window)
        print(f"[4e] paced {PACED_SECONDS} s -r tcp --realtime in a fresh "
              "process, against --backend native")
        e2e["paced"] = paced_e2e(workdir)
        print(f"[4f] failover -> failback round trip, {ROUNDTRIP_SECONDS} s "
              "paced, pack_args stalled for the first "
              f"{THROTTLE_SECONDS:g} s")
        e2e["roundtrip"] = failover_round_trip(workdir)
        print(f"[4g] paced --fleet, {FLEET_SECONDS} s, then a 2-member "
              "fleet round trip")
        e2e["paced_fleet"] = paced_fleet(workdir)
        print(f"[4h] interactive paced {KEY_SECONDS} s, keys from a thread "
              "through TuiApp.handle_key, against the edits replayed on "
              "--backend native")
        e2e["interactive"] = interactive_e2e(workdir)
        print("[4i] HackRF and Pluto mock radios, against --backend native")
        e2e["radios"] = radios_e2e(workdir)
        print("[4j] qa.verify_stream on the card, [4c]'s fleet members")
        e2e["qa"] = qa_e2e(workdir)
        print("[4k] acquire(backend='torch') on the card against numpy, "
              "[4]'s native file")
        e2e["acquire"] = acquire_e2e(workdir)
        print("[4l] entry() on the card, then dryrun_multichip(2) over "
              "cuda:0 twice")
        e2e["entry"] = entry_e2e()
        print(f"[4m] NCCL ranks, one card each, and meshes over {cards} "
              "distinct card(s), against --backend native")
        e2e["multicard"] = multicard_e2e(workdir, main_window, cards)
    finally:
        for f in os.listdir(workdir):
            os.remove(os.path.join(workdir, f))

    # 5. times per 25-block window at the main path's shape (8-bit)
    def floors(t):
        f, dev = t["floors_ms"], t["device_ms"]
        return (f"bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
                f"(share {t['bound_ms'] / t['ms']:.3f}; floors: operations "
                f"{f['operations']:.4f} ms for {t['ops']:.3e} int32 ops, "
                f"shared {f['shared']:.4f} ms for {t['wavefronts']:.3e} "
                f"wavefronts, bytes {f['bytes']:.4f} ms for {t['bytes']} "
                "bytes); device time per launch (profiler) "
                + (f"{dev:.4f} ms, share {t['bound_ms'] / dev:.3f}" if dev
                   else "not measured"))

    from gpssim_tpu_torch.ops.synth_cuda import stage_b_packed_cuda
    from gpssim_tpu_torch.ops.synth_torch import row_bases_packed

    kw8 = dict(n_rows=n_rows, num_samples=n, out_bits=8, wide=wide)
    bases = row_bases_packed(args["code_l"], args["carr_l"], args["nav"],
                             args["ca_packed"], padded_rows(n_rows), wide)
    t = kernel_times(main_window, 8)
    t["device_ms"] = device_ms(lambda: synth_blocks_batch_cuda(
        args, **kw8, fuse_a=True), "synth_k1_kernel")
    print(f"[5] K1 per {t['B']}-block window (N={t['N']}, C={t['C']}, "
          f"8-bit): {t['ms']:.4f} ms; plain {t['plain_ms']:.3f} ms; "
          f"{floors(t)}; card {smi}")
    t2 = k2_times(main_window, 8)
    t2["device_ms"] = device_ms(lambda: stage_b_packed_cuda(
        bases, args["lane_steps"], args["gain_a"], args["gain_b"], wide),
        "synth_k2_kernel")
    print(f"    K2 per {t2['B']}-block window (R_pad={t2['R_pad']}, "
          f"C={t2['C']}): {t2['ms']:.4f} ms; plain {t2['plain_ms']:.3f} ms; "
          f"{floors(t2)}; producer {t2['producer_ms']:.3f} ms; finalize "
          f"(8-bit) {t2['finalize_ms']:.4f} ms; card {smi}")
    t3 = k1_raw_times(main_window)
    err["K1"] = max(err["K1"], t3["max_abs_err"])
    print(f"    K1 raw mode per {t3['B']}-block mesh shard (R_pad="
          f"{t3['R_pad']}, C={t3['C']}): {t3['ms']:.4f} ms; plain "
          f"{t3['plain_ms']:.3f} ms; {floors(t3)}; card {smi}")
    rt = {}
    for name, w in paced.items():
        wp, wspec, wn, wrows, wwide, _ = w
        wargs = on_card(wp, wspec)
        rt[name] = kernel_times(w, 8)
        rt[name]["device_ms"] = device_ms(
            lambda: synth_blocks_batch_cuda(
                wargs, n_rows=wrows, num_samples=wn, out_bits=8, wide=wwide,
                fuse_a=True), "synth_k1_kernel")
        print(f"    K1 per {name} window (B={rt[name]['B']}, C="
              f"{rt[name]['C']}, 8-bit): {rt[name]['ms']:.4f} ms; plain "
              f"{rt[name]['plain_ms']:.3f} ms; {floors(rt[name])}; card "
              f"{smi}")
    print(f"    fleet aggregate x{e2e['fleet']['realtime_x_aggregate']:.2f} "
          f"realtime ({len(FLEET_ROSTER)} members, 3 Msps, 8-bit)")
    print(f"    total {time.perf_counter() - t_start:.1f} s")

    def by_path(k):
        return {"main": e2e["launches"][k],
                "two_stage": e2e["two_stage"]["launches"][k],
                "fleet": e2e["fleet"]["launches"][k],
                "fleet_mesh": e2e["fleet"]["mesh_launches"][k],
                "sharded": e2e["sharded"]["launches"][k],
                "paced": e2e["paced"]["launches"][k],
                "roundtrip": e2e["roundtrip"]["launches"][k],
                "paced_fleet": e2e["paced_fleet"]["launches"][k],
                "fleet_roundtrip":
                    e2e["paced_fleet"]["roundtrip"]["launches"][k],
                "interactive": e2e["interactive"]["launches"][k],
                "hackrf": e2e["radios"]["hackrf"]["launches"][k],
                "pluto": e2e["radios"]["plutosdr"]["launches"][k],
                "entry": e2e["entry"]["launches"][k],
                "dryrun": e2e["entry"]["dryrun"]["launches"][k],
                "multihost": e2e["entry"]["dryrun"]["child_launches"][k],
                **{f"ranks_{w}": r["launches"][k]
                   for w, r in multi["ranks"].items()},
                **{f"mesh_{name}": v["launches"][k] if "fleet" in name
                   else v[k] for name, v in multi.get("mesh", {}).items()},
                **({"dryrun_cards": multi["dryrun"]["launches"][k],
                    "dryrun_cards_children":
                        multi["dryrun"]["child_launches"][k]}
                   if "dryrun" in multi else {})}

    multi = e2e["multicard"]

    print(smi)
    print(json.dumps({
        "kernels": [{
            "name": "K1 synth_k1 (fused block synthesis)",
            "route": "cuda",
            "source": "gpssim_tpu_torch/csrc/synth_k1.cu",
            "replaces": "gpssim_tpu/ops/synth_pallas.py:371",
            "launches": e2e["launches"]["K1"],
            "max_abs_err": err["K1"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            # a shared-memory wavefront is an operation of the shared pipe
            "bound_by": "bytes" if t["bound_by"] == "bytes" else "operations",
            "library_ms": None,
            "bound_resource": t["bound_by"],
            "floors_ms": t["floors_ms"],
            "launches_by_path": by_path("K1"),
            "resources": {k: v for k, v in resources.items()
                          if k.startswith("synth_k1")},
            "grid": grids,
            "device_ms": t["device_ms"],
            "raw_mesh_shard": {k: t3[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "floors_ms", "B", "C", "R_pad")},
            "paced_windows": {name: {k: v[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "floors_ms", "B", "C")} for name, v in rt.items()},
        }, {
            "name": "K2 synth_k2 (stage B over packed bases)",
            "route": "cuda",
            "source": "gpssim_tpu_torch/csrc/synth_k2.cu",
            "replaces": "gpssim_tpu/ops/synth_pallas.py:356",
            "launches": e2e["two_stage"]["launches"]["K2"],
            "max_abs_err": err["K2"],
            "ms": t2["ms"],
            "plain_ms": t2["plain_ms"],
            "bound_ms": t2["bound_ms"],
            "bound_by": "bytes" if t2["bound_by"] == "bytes" else "operations",
            "library_ms": None,
            "bound_resource": t2["bound_by"],
            "floors_ms": t2["floors_ms"],
            "launches_by_path": by_path("K2"),
            "resources": {k: v for k, v in resources.items()
                          if k.startswith("synth_k2")},
            "device_ms": t2["device_ms"],
            "producer_ms": t2["producer_ms"],
            "finalize_ms": t2["finalize_ms"],
        }],
        "card": smi,
        "e2e": e2e,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--paced-child"]:
        sys.exit(paced_child(json.loads(sys.argv[2]),
                             sys.argv[3] == "profile"))
    sys.exit(main(sys.argv[1:]))
