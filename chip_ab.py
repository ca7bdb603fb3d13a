#!/usr/bin/env python3
"""On-card A/B timing of the port's kernels, K1 and K2, built from several
source trees.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_ab.py [label=csrc_dir ...]

Each argument names a directory holding ``synth_k1.cu``, ``synth_k2.cu``
and the headers they include: the ``gpssim_tpu_torch/csrc`` of another
commit (``git archive <commit> gpssim_tpu_torch/csrc | tar -x -C
build/ab/<label>``, then ``<label>=build/ab/<label>/gpssim_tpu_torch/csrc``)
or a copy of this tree's with one line edited. This tree's own sources are
always ``current``. A tree must keep this tree's C entry points
(``gpssim_k1_launch``, ``gpssim_k2_launch``) and their arguments.

For every tree it builds both kernels with the flags of
``gpssim_tpu_torch/ops/_build.py`` (all ``nvcc`` runs started together),
prints each kernel's registers, shared memory and spills and its stage-B
loop's SASS counts per channel-sample (as ``chip_smoke.py`` counts them),
holds every kernel byte for byte against its plain version on the
fixture's 3 Msps, integer-NCO and 1.2 Msps windows (25 blocks), and times
K2 and K1 per 25-block window at 3 Msps (float and integer NCO) with CUDA
events, the trees in turns (A, B, ..., B, A) so that a drift of the card
shows, each beside the host's time per wrapper call (where that nears
the kernel's time, the events time the host) and the kernel's device
time per launch from torch.profiler (``chip_smoke.device_ms``), which
the host cannot inflate. It prints the ``nvidia-smi`` line and, last,
one JSON object of the times and their medians. Without a CUDA device it
exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "ab", "libs")


def build_trees(trees: dict) -> dict:
    """{(label, "k1"|"k2"): (library path, ptxas report)}, every nvcc
    started together; raises on a failed build."""
    from gpssim_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    done, errors = {}, []

    def one(label, k, src):
        out = os.path.join(OUT, f"{label}_{k}.so")
        p = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                            src], capture_output=True, text=True)
        if p.returncode:
            errors.append(f"{label} {k}: {p.stderr[-3000:]}")
        done[(label, k)] = (out, p.stderr)

    threads = [threading.Thread(target=one, args=(label, k, os.path.join(
        d, f"synth_{k}.cu"))) for label, d in trees.items()
        for k in ("k1", "k2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def loop_per_channel_sample(instrs: list):
    """The stage-B loop's SASS counts per channel-sample. The loop before
    this tree's read the two int16 carrier tables, two 16-bit loads per
    channel-sample; the current loop does one 64-bit gather of the folded
    table (``chip_smoke.is_gather``)."""
    import chip_smoke as cs

    loop, per = cs.stage_b_loop(instrs, lambda b, i: bool(
        re.match(r"LDS\.(S|U)16$", b[i][1]))), 2
    if loop is None:
        loop, per = cs.stage_b_loop(instrs), 1
    if loop is None:
        return None
    n = loop["gathers"] / per
    return dict(channel_samples=n,
                instructions=loop["instructions"] / n,
                shared_loads=loop["shared_loads"] / n,
                imad=loop["imad"] / n)


def host_us(fn, calls: int = 200) -> float:
    """Host time per call of ``fn``, in microseconds: the enqueue alone,
    the device not waited for. Where it nears the device time per call,
    back-to-back launches are host-bound and the CUDA events time the
    host, not the kernel."""
    import time

    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def launcher(path: str, k: str):
    fn = getattr(ctypes.CDLL(path), f"gpssim_{k}_launch")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([p, ll] * 7 + [p, p] + [i] * 7 + [p] if k == "k1" else
                   [p] + [p, ll] * 3 + [p, p, p] + [i] * 4 + [p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch finds no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "gpssim_tpu_torch")):
        print("chip_ab: run from a checkout holding gpssim_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gpssim_tpu_torch.ops import synth_cuda
    from gpssim_tpu_torch.ops.synth_torch import (
        padded_rows, row_bases_packed, stage_b_packed_torch,
        synth_blocks_batch_torch,
    )

    trees = {"current": os.path.join(REPO, "gpssim_tpu_torch", "csrc")}
    for arg in sys.argv[1:]:
        label, _, d = arg.partition("=")
        trees[label] = os.path.abspath(d)
    smi = cs.device_facts()
    built = build_trees(trees)
    tool = "/usr/local/cuda/bin/cuobjdump"
    for (label, k), (lib, report) in sorted(built.items()):
        sass = cs.sass_functions(subprocess.run(
            [tool, "-sass", lib], capture_output=True, text=True,
            timeout=120).stdout) if os.path.exists(tool) else {}
        for name, r in sorted(cs.ptxas_resources(report).items()):
            loop = loop_per_channel_sample(sass.get(name, []))
            print(f"{label} {name}: {json.dumps(r)}; stage-B loop per "
                  f"channel-sample: {json.dumps(loop)}")
    fns = {key: launcher(lib, key[1]) for key, (lib, _) in built.items()}

    labels = list(trees)
    turns = labels + labels[::-1]
    times, host, device = {}, {}, {}
    for wname, win, timed in (
            ("3 Msps", cs.fixture_window(3_000_000), True),
            ("3 Msps int-NCO", cs.fixture_window(3_000_000, int_nco=True),
             True),
            ("1.2 Msps wide", cs.fixture_window(1_200_000), False)):
        packed, spec, n, n_rows, wide, _ = win
        args = cs.on_card(packed, spec)
        R = padded_rows(n_rows)
        kw2 = (row_bases_packed(args["code_l"], args["carr_l"], args["nav"],
                                args["ca_packed"], R, wide),
               args["lane_steps"], args["gain_a"], args["gain_b"], wide)
        kw1 = dict(n_rows=n_rows, num_samples=n, out_bits=8, wide=wide)
        plain = {"k2": stage_b_packed_torch(*kw2),
                 "k1": synth_blocks_batch_torch(args, **kw1)}
        calls = {"k2": lambda: synth_cuda.stage_b_packed_cuda(*kw2),
                 "k1": lambda: synth_cuda.synth_blocks_batch_cuda(
                     args, **kw1, fuse_a=True)}
        for k in ("k2", "k1"):
            for label in turns if timed else labels:
                fn = fns[(label, k)]
                if k == "k1":
                    synth_cuda._kernel = lambda fn=fn: fn
                else:
                    synth_cuda._kernel_k2 = lambda fn=fn: fn
                got = calls[k]()
                torch.cuda.synchronize()
                want = plain[k]
                same = (all(torch.equal(g, w) for g, w in zip(got, want))
                        if k == "k2" else torch.equal(got, want))
                if not same:
                    raise AssertionError(f"{label} {k} differs from its "
                                         f"plain version on {wname}")
                if not timed:
                    print(f"{wname}: {label} {k.upper()} byte-equal")
                    continue
                ms = cs.time_ms(calls[k], 11, 5, inner=20)
                us = host_us(calls[k])
                dev = cs.device_ms(calls[k], f"synth_{k}_kernel")
                key = f"{k.upper()} {label}"
                for d, v in ((times, ms), (host, us), (device, dev)):
                    d.setdefault(wname, {}).setdefault(key, []).append(v)
                print(f"{wname}: {label} {k.upper()} {ms:.4f} ms "
                      f"(byte-equal; host {us:.1f} us per wrapper call; "
                      "device " + (f"{dev:.4f} ms" if dev else
                                   "not measured")
                      + " per launch, profiler)")
    print(smi)

    def medians(d):
        return {w: {k: statistics.median(v) for k, v in x.items()
                    if None not in v} for w, x in d.items()}

    print(json.dumps({"card": smi, "ms": times, "host_us": host,
                      "device_ms": device, "median_ms": medians(times),
                      "median_device_ms": medians(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
