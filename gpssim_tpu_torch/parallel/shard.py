"""Mesh layout and the sharded synthesis step, in one process.

The counterpart of the JAX package's ``parallel/shard.py``, which runs
``shard_map`` over a ``jax.sharding.Mesh``. Here a mesh is a small
(blocks, chan) array of ``torch.device``, and one process drives every
device of it:

* **blocks** axis: time-block parallelism. Each 0.1 s block is a pure
  function of its plan, so a batch of B blocks splits over the blocks
  axis with no traffic between devices.
* **chan** axis: channel parallelism. Each device synthesizes its channel
  range of its block range into raw int16 rows (before the finalize). The
  partial rows of one block range are summed over chan in int32 on the
  range's first device and cast to int16: modular, like the JAX ``psum``
  of int16 rows, and equal to the cast of the full int32 channel sum
  (int16 truncation is a ring homomorphism). Only then come the
  interleave and the 8-bit ``>> 4`` (the reference shifts the full short
  accumulator, gps.c:2841-2845), so the sharded bytes equal the unsharded
  ones. With chan == 1 nothing crosses devices and nothing is summed.

A device may appear in a mesh more than once: a (1, 2) mesh over one
card, or one CPU, runs the channel sum on that device. Over distinct
cards, each card's copies and kernels run on its own current stream (the
kernels' wrappers take the stream of their tensors' card); the copy of a
partial row to the range's first card is ordered after the stream that
made it and before the sum (a copy between cards waits on both cards'
streams); and the host buffer is written by the finalize's stream, after
the sum, with one event per block range (``runner.InFlight``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.args import ARG_ORDER, pack_args, unpack_args
from ..ops.synth_cuda import synth_batch_cuda_raw
from ..ops.synth_torch import finalize_rows, synth_batch_torch_raw
from ..runner import InFlight

#: kernels of the per-device body: the two-stage path (producer + K2),
#: K1's raw mode, and the plain version of either
KERNELS = ("cuda", "cuda-fused", "torch")

# Channel axis per batched arg (block axis is 0 for all of them).
_CHAN_AXIS = {
    "code_l": 2, "carr_l": 2, "nav": 2, "lane_steps": 2,
    "ca_packed": 1, "gain_a": 1, "gain_b": 1,
}


class Mesh:
    """A (blocks, chan) grid of torch devices."""

    axis_names = ("blocks", "chan")

    def __init__(self, devices):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        for d in (d for row in grid for d in row):
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"mesh device {d}: expected cuda or cpu")
        self.devices = grid
        self.shape = {"blocks": len(grid), "chan": len(grid[0])}


def make_mesh(n_blocks_shards: int | None = None, n_chan_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (blocks, chan) mesh over ``devices`` (default: every CUDA
    device; without one it raises, the CPU is used only when named)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch finds no CUDA device; pass "
                               "devices=['cpu', ...] to mesh the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_blocks_shards is None:
        n_blocks_shards = len(devices) // n_chan_shards
    if n_blocks_shards < 1 or n_blocks_shards * n_chan_shards != len(devices):
        raise ValueError(f"{n_blocks_shards}x{n_chan_shards} != "
                         f"{len(devices)} devices")
    return Mesh([devices[i * n_chan_shards:(i + 1) * n_chan_shards]
                 for i in range(n_blocks_shards)])


def _shard(batch: dict, blocks: slice, chans: slice) -> dict:
    out = {}
    for k in ARG_ORDER:
        idx = [blocks] + [slice(None)] * (batch[k].ndim - 1)
        idx[_CHAN_AXIS[k]] = chans
        out[k] = batch[k][tuple(idx)]
    return out


def _to_device(args: dict, device: torch.device) -> dict:
    """One block-by-channel shard of numpy args → int32 views of one
    device tensor (one copy, non-blocking from pinned memory on a card)."""
    packed, spec = pack_args(args)
    t = torch.from_numpy(packed)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return unpack_args(t, spec)


def raw_body(kernel: str):
    """``(args, n_rows, wide) -> (i_rows, q_rows)`` of one device's shard
    for a mesh ``kernel`` (:data:`KERNELS`)."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r}: expected one of {KERNELS}")
    body = synth_batch_torch_raw if kernel == "torch" else synth_batch_cuda_raw
    return lambda args, n_rows, wide: body(args, n_rows=n_rows, wide=wide,
                                           fuse_a=kernel != "cuda")


def make_sharded_synth(mesh: Mesh, n_rows: int, num_samples: int,
                       wide: bool = False, out_bits: int = 16,
                       kernel: str = "cuda-fused"):
    """(batched numpy args) → :class:`runner.InFlight` of int16 (int8 for
    8 bits) [B, 2*num_samples], synthesized over ``mesh``.

    The batch's block count must divide by the mesh's blocks dimension and
    its channel count by the chan dimension (``pad_batch``,
    ``pad_channels``). ``kernel`` selects the per-device body:

    * ``"cuda-fused"`` (the default, as ``"pallas-fused"`` is in the JAX
      package): K1's raw mode;
    * ``"cuda"``: the two-stage path, the packed-bases producer and K2;
    * ``"torch"``: the plain version, on whichever device the mesh names.

    On CUDA devices ``cuda`` and ``cuda-fused`` launch their kernels or
    raise; CPU devices run the plain versions."""
    body = raw_body(kernel)
    if out_bits not in (8, 16):
        raise ValueError(f"out_bits={out_bits} (8 or 16)")
    nb, nc = mesh.shape["blocks"], mesh.shape["chan"]

    on_card = any(d.type == "cuda" for row in mesh.devices for d in row)

    def call(batch: dict) -> InFlight:
        B, C = batch["gain_a"].shape
        if B % nb or C % nc:
            raise ValueError(f"batch of {B} blocks x {C} channels does not "
                             f"split over a {nb}x{nc} mesh (pad_batch, "
                             "pad_channels)")
        bs, cs = B // nb, C // nc
        host = torch.empty((B, 2 * num_samples), pin_memory=on_card,
                           dtype=torch.int16 if out_bits == 16 else torch.int8)
        done = []
        for i, row in enumerate(mesh.devices):
            blocks = slice(i * bs, (i + 1) * bs)
            parts = [
                body(_to_device(_shard(batch, blocks,
                                       slice(j * cs, (j + 1) * cs)), dev),
                     n_rows, wide)
                for j, dev in enumerate(row)
            ]
            dev0 = row[0]
            i_rows, q_rows = parts[0]
            if nc > 1:
                # int32 sum on the row's first device, then the int16
                # cast: modular, as the JAX package's psum of int16 rows
                i_sum = i_rows.to(torch.int32)
                q_sum = q_rows.to(torch.int32)
                for pi, pq in parts[1:]:
                    i_sum += pi.to(dev0)
                    q_sum += pq.to(dev0)
                i_rows, q_rows = i_sum.to(torch.int16), q_sum.to(torch.int16)
            out = finalize_rows(i_rows, q_rows, num_samples, out_bits)
            host[blocks].copy_(out, non_blocking=dev0.type == "cuda")
            if dev0.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev0))
                done.append(event)
        return InFlight(host, tuple(done))

    call.kernel = kernel
    return call


def pad_batch(batch: dict, multiple: int) -> tuple[dict, int]:
    """Pad the block axis to a multiple of the mesh's blocks dimension."""
    b = batch["gain_a"].shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch, 0
    out = {
        k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
        for k, v in batch.items()
    }
    return out, pad


def pad_channels(batch: dict, multiple: int) -> dict:
    """Pad the channel axis with silent channels (gain 0) so any chan-mesh
    size works; zero-gain channels contribute exactly nothing."""
    c = batch["gain_a"].shape[1]
    pad = (-c) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        widths = [(0, 0)] * v.ndim
        widths[_CHAN_AXIS[k]] = (0, pad)
        out[k] = np.pad(v, widths)
    return out
