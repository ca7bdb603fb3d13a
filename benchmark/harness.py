"""One run of one cell: set up, warm up, measure, check, print.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<name>.json``, its
traffic in ``traffic/<name>.json``, each per-layer metric's reader in
``metrics/<name>.py``. A new cell, configuration or metric is new files
and new entries; nothing here changes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

from . import drive, workload
from .reference import planner
from .reference.check import check_all
from .tracing import Tracer, breakdown

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpssim_tpu")


class CellError(RuntimeError):
    """The cell cannot run here (no card, unknown name, bad files)."""


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        return json.load(fp)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def receivers(inputs, rec=None) -> list:
    """The reference's view of each member: the generated inputs only,
    and for a live run the edits at the blocks they landed at."""
    c = inputs.config
    out = []
    for k, m in enumerate(inputs.members):
        edits: dict = {}
        if rec is not None and rec.mode == "live":
            for index, kw, _ctx in rec.sims[k].landed:
                edits.setdefault(index, []).append(dict(kw))
        out.append(planner.Receiver(
            nav_file=workload.data_path(c["nav_file"]), start=m.start,
            lat=m.lat, lon=m.lon, height=m.height,
            sample_rate=int(c["sample_rate"]),
            num_channels=int(c["num_channels"]),
            ionosphere=bool(c["ionosphere"]),
            almanac_file=(workload.data_path(c["almanac_file"])
                          if c["almanac"] else None),
            interactive=inputs.traffic["mode"] == "live",
            parity_exact=bool(c["parity_exact"]), edits=edits))
    return out


class Ctx:
    """What the metric readers read: the run's record, its trace, the
    deployment's sizes."""

    def __init__(self, rec, cfgs, trace):
        self.rec = rec
        self.trace = trace
        self.samples_per_block = cfgs[0].samples_per_epoch
        self.sample_bits = cfgs[0].sample_format.value

    def window_blocks(self) -> int:
        return self.rec.end.blocks - self.rec.start.blocks

    def stage_ms_per_block(self, stage: str):
        n = self.window_blocks()
        if not n:
            return None
        d = getattr(self.rec.end, stage) - getattr(self.rec.start, stage)
        return 1e3 * d / n

    def sink_seconds(self) -> float:
        a, b = self.rec.start.t, self.rec.end.t
        return sum(e - s for tee in self.rec.tees for s, e in tee.spans
                   if a <= s and e <= b)

    def written_in_trace(self) -> tuple:
        """Blocks the sinks were handed while the profiler ran, and their
        active channels summed."""
        tr = self.trace
        blocks = chans = 0
        for sim, tee in zip(self.rec.sims, self.rec.tees):
            for k, (_s, e) in enumerate(tee.spans):
                if tr.t0 < e <= tr.t1:
                    blocks += 1
                    chans += sim.active.get(k + 1, 0)
        return blocks, chans

    def edit_lags(self) -> list:
        sim = self.rec.sims[0]
        return [(index - 1) - ctx[1] for index, _kw, ctx in sim.landed]

    @staticmethod
    def p95(values: list):
        v = sorted(values)
        return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def key_latencies(rec) -> tuple:
    """(latency of each key sent in the window in ms, keys that never
    reached the reader): from the key's due time to the first byte of the
    block its edit landed at. A key that did not arrive counts with the
    time the run waited for it."""
    sim = rec.sims[0]
    at = rec.reader.first_byte_at
    landed = {ctx[0]: index for index, _kw, ctx in sim.landed}
    out, failed = [], 0
    end = rec.drained_at or time.perf_counter()
    for due, _key, _written in rec.keys_sent:
        index = landed.get(due)
        if index is not None and index - 1 < len(at):
            out.append(1e3 * (at[index - 1] - due))
        else:
            failed += 1
            out.append(1e3 * (end - due))
    return out, failed


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             config_overrides: dict | None = None,
             traffic_overrides: dict | None = None, control: bool = False,
             t_process: float | None = None,
             bench: dict | None = None) -> tuple:
    """Run cell ``name`` once. Returns (result dict, compared numbers).

    ``device="cpu"`` runs the port's plain PyTorch kernels on the CPU
    (tests); ``config_overrides`` and ``traffic_overrides`` change the
    deployment's and the traffic's parameters, and ``overrides`` the
    program's SimConfig fields alone (tests shrink the rate, the launch
    window and the warm-up);
    ``control=True`` runs the control that the check must fail: under the
    reference C's parity the program's own closed-form path
    (``parity_exact=False``); in the port's closed form the reference
    itself in float32 in the program's place.
    """
    t_process = time.perf_counter() if t_process is None else t_process
    bench = load_benchmark() if bench is None else bench
    cell = find(bench["workloads"], name, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    with open(os.path.join(ROOT, conf["file"])) as fp:
        config = json.load(fp)
    config.update(config_overrides or {})
    traffic = workload.load_json("traffic", cell["traffic"])
    traffic.update(traffic_overrides or {})
    chips = int(cell["chips"])

    import torch

    marks = {"torch": time.perf_counter()}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise CellError("torch finds no CUDA device")
        if torch.cuda.device_count() < chips:
            raise CellError(f"{torch.cuda.device_count()} CUDA devices, the "
                            f"cell needs {chips}")
        backend = "cuda"
    else:
        backend = "torch"
    inputs = workload.generate(config, traffic, seed)
    marks["inputs"] = time.perf_counter()
    overrides = dict(overrides or {})
    if control and config["parity_exact"]:
        overrides["parity_exact"] = False
    cfgs = [drive.program_config(inputs, m, backend=backend, device=device,
                                 overrides=overrides)
            for m in inputs.members]
    tracer = None
    if trace:
        tracer = Tracer(traffic["trace_offset"] * seconds,
                        min(traffic["trace_max_s"], 0.4 * seconds))
        if device == "cuda":
            tracer.warm()
    marks["configs"] = time.perf_counter()
    if traffic["mode"] == "live":
        rec = drive.run_live(inputs, cfgs[0], seconds, tracer)
    else:
        rec = drive.run_offline(inputs, cfgs, seconds, tracer)
    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules loaded in this process: {bad}")
    peak = torch.cuda.max_memory_allocated(0) if device == "cuda" else 0
    tr = tracer.reduce() if tracer is not None else None
    ctx = Ctx(rec, cfgs, tr)

    metrics: dict = {}
    window_s = rec.end.t - rec.start.t
    attempted = rec.end.blocks - rec.start.blocks
    failed = 0
    if rec.mode == "live":
        lat, failed_keys = key_latencies(rec)
        underruns = rec.stats[0].underruns
        attempted = len(rec.keys_sent) + attempted
        failed = failed_keys + underruns
    if not trace:
        for m in bench["end_to_end"]:
            if not applies(m, name):
                continue
            if m["name"] == "setup_s":
                v = rec.start.t - t_process
            elif m["name"] == "msps":
                v = (rec.end.samples - rec.start.samples) / window_s / 1e6
            elif m["name"] == "key_to_stream_p95_ms":
                v = Ctx.p95(lat) if lat else None
            else:
                raise CellError(f"no measure for end-to-end {m['name']!r}")
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if applies(m, name):
                v = load_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs
    records = [(sim.phases, tee.count, tee.sums,
                rec.reader.sums if rec.reader is not None else None)
               for sim, tee in zip(rec.sims, rec.tees)]
    rxs = receivers(inputs, rec)
    spans = ([("sink write", s, e) for tee in rec.tees for s, e in tee.spans]
             + [("planning", s, e) for sim in rec.sims for s, e in sim.steps])
    ends = sorted(e for tee in rec.tees for _s, e in tee.spans
                  if rec.start.t <= e <= rec.end.t)
    per_2s = np.bincount(((np.array(ends) - rec.start.t) // 2).astype(int))
    del rec.sims, rec.tees
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check_all(rxs, records, seed=seed, device=device,
                        control=control and not config["parity_exact"])
    numbers["check_s"] = time.perf_counter() - t_check
    numbers["blocks_per_2s"] = per_2s.tolist()
    numbers["setup_parts_s"] = {k: v - t_process for k, v in marks.items()}
    compared = {
        "blocks_mismatched": {"value": numbers["blocks_mismatched"],
                              "limit": 0},
        "phases_mismatched": {"value": numbers["phases_mismatched"],
                              "limit": 0},
    }
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr, spans)
    result["compared"] = compared
    return result, numbers


def main(argv=None, t_process: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        result, numbers = run_cell(a.workload, a.seed, a.seconds,
                                   bool(a.trace), t_process=t_process)
    except CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    detail = {k: v for k, v in numbers.items()
              if k not in ("blocks_mismatched", "phases_mismatched")}
    print(f"check: {json.dumps(detail)}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
