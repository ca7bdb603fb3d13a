"""Run a cell on its strict-parity configuration (``single-3msps-sc8``,
``farm8-3msps-sc8``: every byte the reference C's), which the benchmark
leaves out while the program fails it (PERF.md, Open questions).

    python3 benchmark/tools/strict_cell.py --workload farm8.static \
        --seed 4123 --seconds 5 [--trace 0|1]

It prints the cell's result line, checked by the strict reference on
every block the window wrote.
"""

import argparse
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

STRICT = {"single-3msps-sc8-closedform": "single-3msps-sc8",
          "farm8-3msps-sc8-closedform": "farm8-3msps-sc8"}


def strict_benchmark() -> dict:
    bench = harness.load_benchmark()
    for c in list(bench["configs"]):
        name = STRICT[c["name"]]
        bench["configs"].append({**c, "name": name,
                                 "file": f"benchmark/configs/{name}.json"})
    for w in bench["workloads"]:
        w["config"] = STRICT[w["config"]]
    return bench


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()
    result, numbers = harness.run_cell(
        a.workload, a.seed, a.seconds, bool(a.trace),
        traffic_overrides={"compare_every": 1}, bench=strict_benchmark())
    print(f"check: {json.dumps(numbers)}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
