"""On the card, at each cell's own size (its window of ``run_seconds``):
the control and the fault that the check must fail. The benchmark's own
runs do not run these. Run them on a machine with the card:

    python -m pytest -s benchmark/tests/test_bench_chip.py
"""

import pytest

from benchmark import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = [4100001, 4100002, 4100003]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")


def cell_run(cell, seed, **kw):
    res, numbers = harness.run_cell(cell, seed, BENCH["run_seconds"], False,
                                    **kw)
    print(f"{cell} seed {seed} {kw}: "
          + ", ".join(f"{k} {v['value']} (limit {v['limit']})"
                      for k, v in res["compared"].items())
          + f"; blocks {numbers['blocks']}, compared {numbers['compared']}")
    return res


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, seed):
    assert not cell_run(cell, seed, control=True)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_in_k1(card, cell, monkeypatch):
    import gpssim_tpu_torch.ops.synth_cuda as sc

    real = sc.synth_blocks_batch_cuda

    def altered(*a, **kw):
        out = real(*a, **kw)
        out[:, 4321] += 1  # one byte of every block
        return out

    monkeypatch.setattr(sc, "synth_blocks_batch_cuda", altered)
    res = cell_run(cell, 4100009)
    assert not res["correct"]
    assert res["compared"]["blocks_mismatched"]["value"] > 0
