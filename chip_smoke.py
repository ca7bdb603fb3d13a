#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA package (``gpssim_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each of which
raises on failure (a failed phase ends the run with a non-zero exit):

1. Device facts: the card's name and power limit from ``nvidia-smi``.
2. Build: the CUDA kernel from ``gpssim_tpu_torch/csrc`` with ``nvcc`` and,
   alongside it, the native host engine (strict-parity corrections).
3. Kernel against plain version: ``synth_blocks_batch_cuda`` against
   ``synth_blocks_batch_torch`` on the card, byte for byte, at the main
   path's shapes (25 fixture blocks per window: 3 Msps at 8 and 16 bits,
   integer NCO, 1.2 Msps wide window, 6 Msps with the q2 row digit).
4. End to end: the CLI in-process on a 10 s scenario (99 blocks, 4
   windows) with ``--backend cuda``; its bytes must equal the same
   scenario on ``--backend native``. The kernel's launch count is reset
   just before that run and read just after. The run is then repeated
   under torch.profiler for the host stages and the device's idle share.
5. Times: the kernel and its plain version per 25-block window (CUDA
   events, median), beside the least time the card could take.

It prints the ``nvidia-smi`` line, one JSON line ``{"kernels": [...]}``
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "fixtures", "brdc_test.22n")
LOCATION = "35.681298,139.766247,10.0"
WINDOW = 25  # blocks per launch on the main path (cfg.dispatch_blocks)

# Published peaks of one H100 SXM (NVIDIA data sheet and Hopper white
# paper): 3.35 TB/s of HBM3; 132 SMs at a 1.98 GHz boost clock, each
# issuing one warp instruction per clock from each of its 4 schedulers,
# i.e. 128 int32 lane-operations per clock per SM. That issue rate is the
# ceiling of an int32 instruction mix (add, logic and shifts go to the
# INT32 pipe, IMAD to the FMA pipe); the same 128 lanes x 2 x 132 x
# 1.98 GHz give the data sheet's 67 TFLOP/s float32.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9
# int32 ALU operations per channel-sample in the kernel's stage-B loop
# body (gpssim_tpu_torch/csrc/synth_k1.cu), counted from the source: code
# phase 5, window word and chip sign 5, carrier index 6, two |LUT| 2, two
# split-Q44 gain folds 10, two sign selects 6, two accumulates 2.
OPS_PER_CHANNEL_SAMPLE = 36


def device_facts() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return smi


def build_all() -> dict:
    """nvcc for the kernel and g++ for the native engine, started
    together; returns seconds per build."""
    from gpssim_tpu_torch.ops import _build
    from gpssim_tpu_torch.ops.synth_seq import seq_available

    times, errors = {}, []

    def timed(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)
        times[name] = time.perf_counter() - t

    def kernel():
        _, report = _build.build("synth_k1.cu")
        if report:
            print(report.strip(), file=sys.stderr)
        _build.load("synth_k1.cu")

    def native():
        if not seq_available():
            raise RuntimeError("native engine did not build "
                               "(tools/build_native.sh)")

    threads = [threading.Thread(target=timed, args=(n, f))
               for n, f in (("synth_k1.cu", kernel), ("native", native))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return times


def fixture_window(sample_rate: int, int_nco: bool = False,
                   blocks: int = WINDOW) -> tuple:
    """(packed int32 args, spec, num_samples, n_rows, wide) for the first
    ``blocks`` blocks of the fixture scenario, collated as the main path
    collates them."""
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
    batch = collate_plans(plans, int_nco=int_nco, compact=True,
                          compact_multiple=4)
    packed, spec = pack_args(batch.args)
    n = cfg.samples_per_epoch
    return packed, spec, n, -(-n // LANES), needs_wide_window(1 / sample_rate)


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

    packed, spec, n, n_rows, wide = window
    args = on_card(packed, spec)
    kw = dict(n_rows=n_rows, num_samples=n, out_bits=out_bits, wide=wide)
    got = synth_blocks_batch_cuda(args, **kw)
    want = synth_blocks_batch_torch(args, **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"K1 on {name}: {tuple(got.shape)} {got.dtype}, plain version "
            f"{tuple(want.shape)} {want.dtype}")
    C = args["gain_a"].shape[1]
    diff = got.to(torch.int32) - want.to(torch.int32)
    max_err = int(diff.abs().max())
    print(f"  {name}: B={got.shape[0]} N={n} C={C} wide={wide} "
          f"bits={out_bits} max_abs_err={max_err}")
    if max_err:
        bad = torch.nonzero(diff.view(diff.shape[0], -1, 2).any(-1))
        raise AssertionError(
            f"K1 != plain version on {name}: first differing "
            f"(block, sample) {tuple(int(v) for v in bad[0])}, "
            f"{len(bad)} samples differ"
        )
    return max_err


def run_cli(backend: str, out_file: str, extra=()) -> tuple:
    from gpssim_tpu_torch import cli

    argv = [
        "-e", FIXTURE, "-d", "10", "-l", LOCATION, "--disable-almanac",
        "-r", "iqfile", "--backend", backend, "--out-file", out_file,
        *extra,
    ]
    t = time.perf_counter()
    rc, stats = cli.run(argv)
    wall = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"CLI --backend {backend} exited {rc}")
    return stats, wall


def end_to_end(workdir: str) -> dict:
    import numpy as np

    from gpssim_tpu_torch.config import SimConfig
    from gpssim_tpu_torch.ops.synth_cuda import synth_blocks_batch_cuda
    from gpssim_tpu_torch.runner import strict_parity_enabled

    if not strict_parity_enabled(SimConfig()):
        raise RuntimeError("strict parity is off: the native engine is "
                           "missing")
    ref_file = os.path.join(workdir, "native.bin")
    out_file = os.path.join(workdir, "cuda.bin")
    run_cli("native", ref_file)

    synth_blocks_batch_cuda.launches = 0
    stats, wall = run_cli("cuda", out_file)
    launches = synth_blocks_batch_cuda.launches

    ref = np.fromfile(ref_file, dtype=np.int8)
    out = np.fromfile(out_file, dtype=np.int8)
    if stats.blocks != 99 or out.size != 99 * 2 * 300_000:
        raise AssertionError(f"cuda run wrote {stats.blocks} blocks, "
                             f"{out.size} bytes")
    if not np.array_equal(ref, out):
        bad = np.flatnonzero(ref != out) if ref.size == out.size else []
        raise AssertionError(
            f"--backend cuda bytes != --backend native ({ref.size} vs "
            f"{out.size} bytes; {len(bad)} differ, first at "
            f"{int(bad[0]) if len(bad) else None})"
        )
    if launches < 4:
        raise AssertionError(f"K1 launched {launches} times on the main "
                             "path (expected >= 4)")
    if stats.retries != 0:
        raise AssertionError(f"{stats.retries} window retries")
    # the spread of the end-to-end rate: four more runs of the same CLI
    walls = [stats.wall_seconds] + [
        run_cli("cuda", out_file)[0].wall_seconds for _ in range(4)]
    print(f"  cuda CLI: {stats.blocks} blocks in {stats.wall_seconds:.3f} s "
          f"= {stats.blocks / stats.wall_seconds:.1f} blocks/s, "
          f"{stats.samples_per_second / 1e6:.2f} Msps, "
          f"x{stats.realtime_factor:.2f} realtime (process wall incl. "
          f"set-up {wall:.3f} s); K1 launches {launches}; retries "
          f"{stats.retries}; bytes equal to --backend native")
    med = statistics.median(walls)
    print(f"  5 runs: wall s {', '.join(f'{w:.4f}' for w in walls)}; median "
          f"{med:.4f} s = {stats.samples / med / 1e6:.2f} Msps, "
          f"x{stats.blocks * 0.1 / med:.2f} realtime")
    return dict(launches=launches, blocks=stats.blocks, wall_s_runs=walls,
                msps_median=stats.samples / med / 1e6,
                realtime_x_median=stats.blocks * 0.1 / med)


def profile_e2e(workdir: str) -> dict:
    """The cuda CLI run again under torch.profiler: device time by name
    (kernels and copies, summed over both streams) against the run's wall
    time. The device's idle share is 1 - busy/wall (a lower bound where
    the copies of one window overlap the other window's kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats, _ = run_cli("cuda", os.path.join(workdir, "prof.bin"))
    by_name = {}
    for e in prof.key_averages():  # device-side events: kernels, copies
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = e.self_device_time_total / 1e3
    busy_ms = sum(by_name.values())
    wall_ms = stats.wall_seconds * 1e3
    host = dict(
        plan_ms=stats.plan_seconds * 1e3,
        collate_launch_ms=stats.synth_seconds * 1e3,
        fetch_wait_ms=stats.fetch_seconds * 1e3,
        corrections_ms=stats.correct_seconds * 1e3,
    )
    host["sink_other_ms"] = wall_ms - sum(host.values())
    print("  profiled cuda CLI, host stages: " + ", ".join(
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
                idle_share=1 - busy_ms / wall_ms)


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


def kernel_times(window, out_bits: int) -> dict:
    from gpssim_tpu_torch.ops.synth_cuda import synth_blocks_batch_cuda
    from gpssim_tpu_torch.ops.synth_torch import synth_blocks_batch_torch

    packed, spec, n, n_rows, wide = window
    args = on_card(packed, spec)
    kw = dict(n_rows=n_rows, num_samples=n, out_bits=out_bits, wide=wide)
    plain_a = time_ms(lambda: synth_blocks_batch_torch(args, **kw), 5, 1)
    k_ms = time_ms(lambda: synth_blocks_batch_cuda(args, **kw), 11, 5,
                   inner=20)
    plain_b = time_ms(lambda: synth_blocks_batch_torch(args, **kw), 5, 1)
    B = packed.shape[0]
    C = args["gain_a"].shape[1]
    ops = OPS_PER_CHANNEL_SAMPLE * C * B * n
    nbytes = packed.nbytes + 2 * 512 * 2 + B * 2 * n * out_bits // 8
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(
        ms=k_ms, plain_ms=statistics.median([plain_a, plain_b]),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        ops=ops, bytes=nbytes, B=B, C=C, N=n,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "gpssim_tpu_torch")):
        print("chip_smoke: run from a checkout holding gpssim_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    # 1. device facts
    smi = device_facts()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {kind}; {torch.cuda.device_count()} visible")

    # 2. build
    built = build_all()
    print("[2] built " + ", ".join(f"{k} in {v:.1f} s"
                                   for k, v in built.items()))

    # 3. kernel against plain version on the card
    print("[3] K1 against its plain version, byte for byte")
    main_window = fixture_window(3_000_000)
    windows = [
        ("3 Msps", main_window, 8),
        ("3 Msps", main_window, 16),
        ("3 Msps int-NCO", fixture_window(3_000_000, int_nco=True), 8),
        ("1.2 Msps wide", fixture_window(1_200_000), 8),
        ("6 Msps q2 digits", fixture_window(6_000_000), 16),
    ]
    max_err = max(compare_kernel(name, w, bits) for name, w, bits in windows)

    # 4. end to end through the CLI
    print("[4] CLI end to end, --backend cuda against --backend native")
    workdir = os.path.join(REPO, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        e2e = end_to_end(workdir)
        e2e["profile"] = profile_e2e(workdir)
    finally:
        for f in os.listdir(workdir):
            os.remove(os.path.join(workdir, f))

    # 5. times per 25-block window at the main path's shape (8-bit)
    t = kernel_times(main_window, 8)
    print(f"[5] K1 per {t['B']}-block window (N={t['N']}, C={t['C']}, "
          f"8-bit): {t['ms']:.4f} ms; plain {t['plain_ms']:.3f} ms; bound "
          f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['ops']:.3e} int32 "
          f"ops, {t['bytes']} bytes); card {smi}")
    print(f"    total {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({
        "kernels": [{
            "name": "K1 synth_k1 (fused block synthesis)",
            "route": "cuda",
            "source": "gpssim_tpu_torch/csrc/synth_k1.cu",
            "replaces": "gpssim_tpu/ops/synth_pallas.py:371",
            "launches": e2e["launches"],
            "max_abs_err": max_err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
        }],
        "card": smi,
        "e2e": e2e,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
