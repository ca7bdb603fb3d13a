"""How often the port's device path (K1 plus the strict-parity
corrections) departs from its native engine's full sequential replay of
the reference C (``synth_block_seq_native``), per carrier mode: the
program fault that keeps the strict cells out (PERF.md, Open questions).
On the machine with the card:

    python3 benchmark/tools/parity_faults.py [blocks] [seed ...]
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import drive, harness, workload  # noqa: E402


def main() -> int:
    from gpssim_tpu_torch import runner
    from gpssim_tpu_torch.config import CarrierMode
    from gpssim_tpu_torch.ops.args import collate_plans, pack_args
    from gpssim_tpu_torch.ops.synth_seq import (apply_corrections,
                                                seq_corrections_window,
                                                synth_block_seq_native)
    from gpssim_tpu_torch.scenario import Simulation

    blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    seeds = [int(s) for s in sys.argv[2:]] or [2718281828, 8675309]
    with open(os.path.join(harness.ROOT, "benchmark", "configs",
                           "single-3msps-sc8.json")) as fp:
        conf = json.load(fp)
    traffic = workload.load_json("traffic", "static")
    pool = ThreadPoolExecutor(os.cpu_count() or 1)
    for mode in ("float", "int_nco"):
        for seed in seeds:
            t0 = time.perf_counter()
            inp = workload.generate(conf, traffic, seed)
            cfg = drive.program_config(inp, inp.members[0], backend="cuda",
                                       device="cuda")
            cfg.carrier_mode = CarrierMode(mode)
            nco = mode == "int_nco"
            sim = Simulation(cfg)
            kernel, wide, n_rows, bits = runner.resolve_batch_kernel(cfg)
            dispatch = runner.make_packed_kernel(
                kernel, n_rows, cfg.samples_per_epoch, bits, wide,
                torch.device("cuda"))
            bad = []
            for w in range(blocks // 25):
                win = [sim.step() for _ in range(25)]
                packed, spec = pack_args(collate_plans(
                    win, int_nco=nco, compact=True,
                    compact_multiple=4).args)
                host = dispatch(packed, spec).result()
                corrs = seq_corrections_window(win, int_nco=nco)
                want = list(pool.map(lambda p: synth_block_seq_native(
                    p, int_nco=nco, bits=8), win))
                for k in range(25):
                    got = apply_corrections(host[k].copy(), 8, *corrs[k])
                    if not np.array_equal(got, want[k]):
                        bad.append(w * 25 + k + 1)
            print(f"{mode} seed {seed}: {len(bad)} of {blocks} blocks differ "
                  f"from the sequential replay: {bad[:20]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
