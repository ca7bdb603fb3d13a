"""The harness end to end on the CPU, at a size a test can hold: the port's
plain PyTorch kernels at 1.03 Msps in windows of 4 blocks. Each cell
reads correct on a sound run, and false under its control and with the
timed path broken underneath; a cell added as new files only is found
and run; a run without a card prints nothing and fails."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, workload

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SMALL = dict(config_overrides={"sample_rate": 1_030_000},
             overrides={"dispatch_blocks": 4},
             traffic_overrides={"warmup_blocks": 8,
                                "warmup_stream_blocks": 3})


def run(cell, seed, seconds=1.5, **kw):
    opts = {**SMALL, **kw}
    return harness.run_cell(cell, seed, seconds, False, device="cpu",
                            **opts)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell, 20261018)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    names = {m["name"] for m in harness.load_benchmark()["end_to_end"]
             if harness.applies(m, cell)}
    assert set(res["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run(cell, 777001, control=True)
    assert not res["correct"]
    assert res["compared"]["blocks_mismatched"]["value"] > 0
    assert res["compared"]["phases_mismatched"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    import gpssim_tpu_torch.ops.synth_torch as st

    real = st.synth_blocks_batch_torch

    def altered(*a, **kw):
        out = real(*a, **kw)
        out[:, 4321] += 1  # one byte of every block
        return out

    monkeypatch.setattr(st, "synth_blocks_batch_torch", altered)
    res = run(cell, 777002)
    assert not res["correct"]
    assert res["compared"]["blocks_mismatched"]["value"] > 0


def test_a_carrier_phase_chained_wrong(monkeypatch):
    from gpssim_tpu_torch.ops.plan import BlockPlan

    real = BlockPlan.end_carr_phase
    monkeypatch.setattr(BlockPlan, "end_carr_phase",
                        lambda self: real(self) + 1e-12)
    res = run("live.keys", 777003)
    assert not res["correct"]
    assert res["compared"]["phases_mismatched"]["value"] > 0


def test_a_cell_added_as_new_files_is_found(tmp_path, monkeypatch):
    bench = harness.load_benchmark()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs").mkdir()
    traffic = workload.load_json("traffic", "static")
    traffic["lat"] = [40.0, 50.0]
    (tmp_path / "traffic" / "north.json").write_text(json.dumps(traffic))
    conf = json.load(open(os.path.join(
        ROOT, "benchmark", "configs", "single-3msps-sc8-closedform.json")))
    for key in ("nav_file", "almanac_file"):
        conf[key] = os.path.join(ROOT, conf[key])
    conf["name"] = "north-3msps"
    (tmp_path / "configs" / "north-3msps.json").write_text(json.dumps(conf))
    (tmp_path / "metrics" / "blocks_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.window_blocks())\n")
    bench["configs"].append({
        "name": "north-3msps", "source": "test",
        "file": str(tmp_path / "configs" / "north-3msps.json"),
        "reduced": [], "why": "test"})
    bench["workloads"].append({
        "name": "record.north", "config": "north-3msps", "traffic": "north",
        "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "blocks_in_window", "unit": "blocks", "better": "higher",
        "source": "program_counter", "layer": "sink", "moves": "msps",
        "workloads": ["record.north"]})
    monkeypatch.setattr(workload, "HERE", str(tmp_path))
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    res, _ = harness.run_cell("record.north", 5, 1.5, True, device="cpu",
                              bench=bench, **SMALL)
    assert res["correct"]
    assert set(res["metrics"]) == {"blocks_in_window"}
    assert res["metrics"]["blocks_in_window"]["value"] > 0


def test_without_a_card_nothing_is_printed(tmp_path):
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "farm8.static", "--seed", "3", "--seconds", "1", "--trace", "0"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def test_jax_in_the_process_is_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "gpssim_tpu.ops", object())
    assert harness.forbidden_modules() == ["gpssim_tpu", "jax"]
