"""Find where the port's collation refuses a deployment's scenario: the
Q44 gain split of ``ops/args.args_from_arrays`` raises "not
truncation-exact" when a carrier-table magnitude times a channel's gain
lies a hair above an integer. The planner and the collation run on the
host alone, so this needs no card:

    python3 benchmark/tools/gain_split_fault.py \
        --config single-3msps-sc8-closedform --traffic static \
        --seed 1301000003 [--blocks 200000]

For each member it prints the first block whose window the collation
refuses, with the channel, the magnitude, the gain, the float64 product,
its truncation and the split's, or that none was refused.
"""

import argparse
import os
import sys

import numpy as np

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmark import drive, workload  # noqa: E402


def split_trunc(gain: np.ndarray, mags: np.ndarray) -> np.ndarray:
    """trunc(mag * gain) as the collation's two 22-bit halves give it."""
    ga = np.floor(gain * 2.0**22).astype(np.int64)
    gb = (np.floor(gain * 2.0**44) - ga * 2.0**22).astype(np.int64)
    m = mags.astype(np.int64)[:, None]
    return (ga[None] * m + ((gb[None] * m) >> 22)) >> 22


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True,
                    help="a file of benchmark/configs, without .json")
    ap.add_argument("--traffic", required=True,
                    help="a file of benchmark/traffic, without .json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=200_000)
    a = ap.parse_args()
    from gpssim_tpu_torch.ops.args import _LUT_MAGS
    from gpssim_tpu_torch.scenario import Simulation

    inputs = workload.generate(workload.load_json("configs", a.config),
                               workload.load_json("traffic", a.traffic),
                               a.seed)
    mags = np.asarray(_LUT_MAGS, np.float64)
    for k, member in enumerate(inputs.members):
        cfg = drive.program_config(inputs, member, backend="torch",
                                   device="cpu")
        found = None
        for n, plan in enumerate(Simulation(cfg).iter_plans(), 1):
            g = np.where(plan.active, plan.gain, 0.0)
            prod = mags[:, None] * g[None, :]
            bad = ((np.trunc(prod).astype(np.int64) != split_trunc(g, mags))
                   & (g[None, :] > 0))
            if bad.any():
                i, j = np.argwhere(bad)[0]
                found = (f"block {n}: channel {j}, magnitude {mags[i]:g}, "
                         f"gain {g[j]!r}, product {prod[i, j]!r}, trunc "
                         f"{np.trunc(prod[i, j]):g}, split "
                         f"{split_trunc(g, mags)[i, j]}")
                break
            if n >= a.blocks:
                break
        print(f"member {k}: {found or f'none refused in {n} blocks'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
