"""The port's process groups and dry run over several cards, on the CPU.

This machine has no card and its torch has no NCCL, so the backend rule
(``parallel.multihost.initialize``) runs with ``init_process_group``,
``set_device`` and the card count replaced by recorders; the rendezvous
store in front of it is real. The chan-major sum runs for real over gloo
in two processes, through the same function that reduces device tensors
under NCCL, against the JAX package's ``synthesize_chan_major`` on the
same plans (its 8-device virtual CPU mesh). Every comparison of samples is
``np.array_equal``.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gpssim_tpu_torch import entry
from gpssim_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_cards(monkeypatch):
    """Four visible cards named ``card0`` .. ``card3``; ``set_device`` and
    ``init_process_group`` record their calls, in order, into the list
    returned."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(multihost, "_card_key", lambda i: f"card{i}")
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(("init", kw)))
    monkeypatch.setattr(multihost, "_cards", None)
    return calls


def _coord() -> str:
    return f"tcp://127.0.0.1:{entry._free_port()}"


@pytest.mark.parametrize("ids,device,backend,local", [
    (None, "cpu", "gloo", ["cpu"]),
    ([2], "cuda", "nccl", ["cuda:2"]),
    ([3, 1], "cuda", "nccl", ["cuda:3", "cuda:1"]),
    (None, "cuda", "gloo", ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
], ids=["cpu-rank", "own-card", "own-cards", "shared-card"])
def test_backend_rule(fake_cards, ids, device, backend, local):
    """NCCL only for a rank with cards of its own (its first card current
    before the group forms); gloo for a CPU rank and for ranks that share
    a card. ``local_device_ids`` narrows ``local_devices`` to the cards
    named, as in ``jax.distributed.initialize``."""
    got = multihost.initialize(_coord(), 1, 0, local_device_ids=ids)
    assert got == backend
    inits = [kw for name, kw in fake_cards if name == "init"]
    assert len(inits) == 1
    assert inits[0]["backend"] == backend
    assert (inits[0]["world_size"], inits[0]["rank"]) == (1, 0)
    assert isinstance(inits[0]["store"], dist.TCPStore)
    if backend == "nccl":
        assert fake_cards[0] == ("set_device", ids[0])
    else:
        assert not [c for c in fake_cards if c[0] == "set_device"]
    assert [str(d) for d in multihost.local_devices(device)] == local


@pytest.mark.parametrize("everyone,backend", [
    ([None, None], "gloo"),
    ([["a"], ["b"]], "nccl"),
    ([["a", "b"], ["c", "d"]], "nccl"),
])
def test_choose_backend(everyone, backend):
    assert multihost.choose_backend(everyone) == backend


@pytest.mark.parametrize("everyone,match", [
    ([["a"], ["a"]], "ranks 0 and 1 both name card a"),
    ([["a", "b"], ["c", "b"]], "ranks 0 and 1 both name card b"),
    ([["a"], None], "ranks disagree"),
    ([None, ["a"]], "ranks disagree"),
])
def test_choose_backend_refuses(everyone, match):
    with pytest.raises(ValueError, match=match):
        multihost.choose_backend(everyone)


def test_two_ranks_on_one_card_refused_before_any_collective(fake_cards):
    """Two ranks that name card 0 both raise at the rendezvous, before
    ``set_device`` and before the group (and so any collective) exists."""
    coord = _coord()
    errors = {}

    def rank(r):
        try:
            multihost.initialize(coord, 2, r, local_device_ids=[0])
        except ValueError as e:
            errors[r] = str(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(errors) == [0, 1]
    assert all("both name card card0" in e for e in errors.values())
    assert fake_cards == []


def test_local_device_ids_out_of_range(fake_cards):
    with pytest.raises(ValueError, match="4 cards visible"):
        multihost.initialize(_coord(), 1, 0, local_device_ids=[4])
    assert fake_cards == []


def test_mesh_refuses_another_ranks_card(monkeypatch):
    """A rank in an NCCL group builds its meshes from its own cards."""
    monkeypatch.setattr(multihost, "_cards", [1])
    with pytest.raises(ValueError, match="not among this rank's cards"):
        multihost.global_mesh(1, ["cuda:0"])


@pytest.mark.parametrize("devices,n_proc,per_child,want", [
    (["cpu"] * 2, 4, 2, [[None, ["cpu"] * 2]] * 4),
    (["cuda:0"] * 2, 2, 4, [[None, ["cuda:0"] * 4]] * 2),
    (["cuda:0", "cuda:1"], 2, 4,
     [[[0], ["cuda:0"] * 4], [[1], ["cuda:1"] * 4]]),
    (["cuda:0", "cuda:1"], 4, 2,
     [[None, ["cuda:0"] * 2], [None, ["cuda:1"] * 2]] * 2),
    ([f"cuda:{i}" for i in range(4)], 2, 4,
     [[[0, 1], ["cuda:0", "cuda:1"] * 2], [[2, 3], ["cuda:2", "cuda:3"] * 2]]),
    ([f"cuda:{i}" for i in range(4)], 4, 2,
     [[[i], [f"cuda:{i}"] * 2] for i in range(4)]),
], ids=["cpu", "one-card", "2-cards-2-ranks", "2-cards-4-ranks",
        "4-cards-2-ranks", "4-cards-4-ranks"])
def test_child_layout(devices, n_proc, per_child, want):
    """The dry run's children own distinct cards where there are enough
    (NCCL) and share them otherwise (gloo)."""
    assert entry.child_layout(devices, n_proc, per_child) == want


def test_dryrun_needs_distinct_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 distinct cards, 1 "
                                           "visible"):
        entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="names one card"):
        entry.dryrun_multichip(2, device="cuda:0")
    with pytest.raises(ValueError, match="3 devices for a dry run over 2"):
        entry.dryrun_multichip(2, devices=["cpu"] * 3)


_CHAN_CHILD = """
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from gpssim_tpu_torch.config import SimConfig
from gpssim_tpu_torch.ops.args import LANES, collate_plans
from gpssim_tpu_torch.parallel import multihost, shard
from gpssim_tpu_torch.scenario import Simulation

rank = int(sys.argv[1])
backend = multihost.initialize({coord!r}, 2, rank)
plans = list(Simulation(SimConfig(
    nav_file=os.path.join({repo!r}, "fixtures", "brdc_test.22n"),
    duration_sec=0.9, almanac_enable=False)).iter_plans())
for p in plans:
    p.num_samples = 512
mesh = multihost.global_mesh_chan_major(["cpu", "cpu"])
batch, _ = shard.pad_batch(shard.pad_channels(collate_plans(plans).args, 2),
                           2)
out = multihost.synthesize_chan_major(batch, mesh, -(-512 // LANES), 512,
                                      out_bits=8)
np.save({out!r} + f".{{rank}}.npy", out)
# a sum that wraps int16: 30000 + 30000 -> -5536, as an int16 psum wraps
wrap = multihost.sum_over_processes(
    [torch.full((2, 1, 2, 4), 30000, dtype=torch.int16)],
    torch.device("cpu"))
multihost.shutdown()
print(json.dumps({{"backend": backend, "mesh": mesh.shape,
                  "wrap": sorted(set(wrap.flatten().tolist())),
                  "dtype": str(wrap.dtype)}}))
"""


def test_chan_major_gloo_equals_jax(fixtures_dir, tmp_path):
    """Two gloo ranks, each one column of a (2, 2) chan-major mesh: the
    channel sum crosses the process boundary through
    ``sum_over_processes`` (host tensors), and each rank's 8-bit batch
    equals the JAX package's ``synthesize_chan_major`` over a (2, 2) mesh
    of its virtual CPU devices, on the same plans."""
    import jax

    from gpssim_tpu.config import SimConfig as JSimConfig
    from gpssim_tpu.ops.synth_jax import LANES
    from gpssim_tpu.parallel import multihost as jmultihost
    from gpssim_tpu.parallel import shard as jshard
    from gpssim_tpu.parallel.blocks import collate_plans as jcollate
    from gpssim_tpu.scenario import Simulation as JSimulation

    out = str(tmp_path / "chan")
    results = entry.run_children(_CHAN_CHILD.format(
        repo=REPO, coord=_coord(), out=out), 2, timeout=300)
    assert [r["backend"] for r in results] == ["gloo", "gloo"]
    assert all(r["mesh"] == {"blocks": 2, "chan": 2} for r in results)
    assert all(r["wrap"] == [-5536] and r["dtype"] == "torch.int16"
               for r in results)

    jplans = list(JSimulation(JSimConfig(
        nav_file=f"{fixtures_dir}/brdc_test.22n", duration_sec=0.9,
        almanac_enable=False)).iter_plans())
    for p in jplans:
        p.num_samples = 512
    jbatch, _ = jshard.pad_batch(
        jshard.pad_channels(jcollate(jplans).args, 2), 2)
    mesh = jshard.make_mesh(2, 2, devices=jax.devices()[:4])
    want = jmultihost.synthesize_chan_major(jbatch, mesh, -(-512 // LANES),
                                            512, out_bits=8)
    assert want.dtype == np.int8 and want.shape == (8, 1024)
    for rank in (0, 1):
        got = np.load(f"{out}.{rank}.npy")
        assert got.dtype == want.dtype and np.array_equal(got, want), rank
