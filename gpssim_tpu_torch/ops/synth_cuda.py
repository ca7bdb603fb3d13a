"""K1 on the card: the wrapper of the hand-written CUDA synthesis kernel.

``synth_blocks_batch_cuda`` launches ``csrc/synth_k1.cu`` on PyTorch's
current stream for tensors on a CUDA device, and raises if the kernel
cannot be built or launched: nothing falls back. For tensors on the CPU it
runs the plain PyTorch version (ops/synth_torch.py), which computes the
same bytes.

The kernel replaces the JAX package's fused Pallas TPU kernel
``_synth_tile_fused_kernel`` (gpssim_tpu/ops/synth_pallas.py:371) plus
``finalize_iq`` (gpssim_tpu/ops/synth_jax.py:586). It is bound by integer
ALU throughput, not memory (see the note at the top of the source).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load
from .args import ARG_ORDER, LANES
from .synth_torch import lut_tables, synth_blocks_batch_torch

SOURCE = "synth_k1.cu"
MAX_CHANNELS = 16  # the kernel's shared-memory channel capacity

_luts: dict[torch.device, torch.Tensor] = {}


def _kernel():
    lib = load(SOURCE)
    fn = lib.gpssim_k1_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, ll] * 7 + [p, p] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _lut(device: torch.device) -> torch.Tensor:
    """The carrier tables on ``device``, copied once. The copy completes
    before the first use, so launches on any stream may read them."""
    t = _luts.get(device)
    if t is None:
        t = torch.from_numpy(lut_tables()).to(device)
        torch.cuda.current_stream(device).synchronize()
        _luts[device] = t
    return t


def _check_args(args: dict) -> tuple[int, int]:
    """Validate dtype, device, shapes and layout; returns (B, C).

    Every field must be int32 with contiguous trailing dims; the block
    stride is free, so the views unpack_args makes of one packed window
    pass without a copy."""
    missing = [k for k in ARG_ORDER if k not in args]
    if missing:
        raise ValueError(f"K1: missing kernel args {missing}")
    dev = args["code_l"].device
    B, _, C, _ = args["code_l"].shape
    want = {
        "code_l": (B, 4, C, 3), "carr_l": (B, 4, C, 3), "nav": (B, 3, C),
        "lane_steps": (B, 4, C), "ca_packed": (B, C, 36),
        "gain_a": (B, C), "gain_b": (B, C),
    }
    for k, shape in want.items():
        t = args[k]
        if t.dtype != torch.int32:
            raise TypeError(f"K1: {k} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"K1: {k} on {t.device}, expected {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"K1: {k} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        inner = 1
        for size, stride in reversed(list(zip(t.shape[1:], t.stride()[1:]))):
            if size != 1 and stride != inner:
                raise ValueError(f"K1: {k} trailing dims are not contiguous")
            inner *= size
    if not 1 <= B <= 65535:
        raise ValueError(f"K1: {B} blocks (1..65535)")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"K1: {C} channels (1..{MAX_CHANNELS})")
    return B, C


def synth_blocks_batch_cuda(args: dict, *, n_rows: int, num_samples: int,
                            out_bits: int = 16, wide: bool = False):
    """Batch of B blocks → int16[B, 2*num_samples] (int8 for 8 bits).

    Same arguments and result as ops/synth_torch.synth_blocks_batch_torch.
    CUDA tensors launch K1 (one launch per call, counted in
    ``synth_blocks_batch_cuda.launches``); CPU tensors run the plain
    version."""
    dev = args["code_l"].device
    if dev.type == "cpu":
        return synth_blocks_batch_torch(
            args, n_rows=n_rows, num_samples=num_samples, out_bits=out_bits,
            wide=wide,
        )
    if dev.type != "cuda":
        raise ValueError(f"K1: tensors on {dev}; expected cuda or cpu")
    B, C = _check_args(args)
    if out_bits not in (8, 16):
        raise ValueError(f"K1: out_bits={out_bits} (8 or 16)")
    if num_samples < 1 or n_rows * LANES < num_samples:
        raise ValueError(
            f"K1: n_rows={n_rows} rows of {LANES} cannot hold "
            f"{num_samples} samples"
        )
    fn = _kernel()
    with torch.cuda.device(dev):
        out = torch.empty(
            (B, 2 * num_samples),
            dtype=torch.int16 if out_bits == 16 else torch.int8, device=dev,
        )
        ptr_stride = []
        for k in ARG_ORDER:
            t = args[k]
            ptr_stride += [t.data_ptr(), t.stride(0)]
        rc = fn(
            *ptr_stride, _lut(dev).data_ptr(), out.data_ptr(), B, C,
            n_rows, num_samples, out_bits, int(wide),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    synth_blocks_batch_cuda.launches += 1
    return out


#: kernel launches since the count was last reset (plain int)
synth_blocks_batch_cuda.launches = 0
