"""K1 and K2 on the card: the wrappers of the hand-written CUDA kernels.

For tensors on a CUDA device each wrapper launches its kernel on PyTorch's
current stream, and raises if the kernel cannot be built or launched:
nothing falls back. For tensors on the CPU it runs the kernel's plain
PyTorch version (ops/synth_torch.py), which computes the same bytes.

* K1 (``csrc/synth_k1.cu``) replaces the JAX package's fused Pallas TPU
  kernel ``_synth_tile_fused_kernel`` (gpssim_tpu/ops/synth_pallas.py:371)
  plus ``finalize_iq`` (gpssim_tpu/ops/synth_jax.py:586). Its raw mode
  stops before the finalize (:func:`synth_k1_raw`).
* K2 (``csrc/synth_k2.cu``) replaces ``_synth_tile_kernel``
  (synth_pallas.py:356): stage B over the packed bases that the torch op
  ``synth_torch.row_bases_packed`` produces (:func:`stage_b_packed_cuda`).

:func:`synth_blocks_batch_cuda` runs K1 by default and the two-stage path
(producer → K2 → finalize) when ``fuse_a`` is false, which
``GPSSIM_FUSE_A=0`` selects at call time, as in the JAX package. Both
kernels run on one persistent grid (``csrc/persistent_grid.cuh``: as many
CTAs as fit on the card, each owning one contiguous range of the rows,
folding the gains into the carrier tables once per block it touches;
:func:`k1_grid` reports K1's) and the same stage-B loop
(``csrc/stage_b.cuh``), bound by the card's integer pipes, not memory.
K1 computes each row's stage A in the warp that then runs the row. See
the notes at the top of the sources.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ._build import load
from .args import ARG_ORDER, LANES
from .synth_torch import (
    TILE_R, base_names, finalize_rows, lut_tables, padded_rows,
    row_bases_packed, stage_b_packed_torch, synth_batch_torch_raw,
    synth_blocks_batch_torch,
)

SOURCE = "synth_k1.cu"
SOURCE_K2 = "synth_k2.cu"
MAX_CHANNELS = 16  # the kernels' shared-memory channel capacity

#: kernel launches since the counts were last reset (plain ints); a
#: wrapper adds one where it launches its kernel, and nowhere else
launches = {"K1": 0, "K2": 0}

_luts: dict[torch.device, torch.Tensor] = {}


def fuse_a_default() -> bool:
    """Whether the fused kernel K1 is the default (``GPSSIM_FUSE_A``,
    ``"1"`` unless set; read at call time, as the JAX package's
    ``_fuse_a_default`` reads it). ``GPSSIM_FUSE_A=0`` selects the
    two-stage path."""
    return os.environ.get("GPSSIM_FUSE_A", "1") == "1"


def _kernel():
    lib = load(SOURCE)
    fn = lib.gpssim_k1_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, ll] * 7 + [p, p] + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return fn


def _kernel_k2():
    lib = load(SOURCE_K2)
    fn = lib.gpssim_k2_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p] + [p, ll] * 3 + [p, p, p] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def k1_grid(B: int, C: int, *, n_rows: int, num_samples: int, out_bits: int,
            wide: bool, raw: bool, device=None) -> dict:
    """The persistent grid K1 launches on a CUDA ``device`` for these
    arguments, as its C side computes it for the launch: the CTAs resident
    at once, the rows computed over the B blocks, the CTAs launched and the
    rows per CTA. Raises for arguments the kernel does not take."""
    resident, ctas = ctypes.c_int(0), ctypes.c_int(0)
    rows, per = ctypes.c_longlong(0), ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = load(SOURCE).gpssim_k1_grid(
            B, C, n_rows, num_samples, out_bits, int(wide), int(raw),
            ctypes.byref(resident), ctypes.byref(rows), ctypes.byref(ctas),
            ctypes.byref(per))
    if rc != 0:
        raise RuntimeError(f"K1 grid query failed: CUDA error {rc}")
    return dict(resident=resident.value, rows=rows.value, ctas=ctas.value,
                rows_per_cta=per.value)


def _lut(device: torch.device) -> torch.Tensor:
    """The carrier tables on ``device``, copied once. The copy completes
    before the first use, so launches on any stream may read them."""
    t = _luts.get(device)
    if t is None:
        t = torch.from_numpy(lut_tables()).to(device)
        torch.cuda.current_stream(device).synchronize()
        _luts[device] = t
    return t


def prepare(device, *, blocks: int, channels: int, n_rows: int,
            num_samples: int, out_bits: int, wide: bool,
            fuse_a: bool | None = None) -> None:
    """Make the first :func:`synth_blocks_batch_cuda` call on a CUDA
    ``device`` for these arguments cost what later ones do: load (and,
    the first time, build) the kernel's library, copy the carrier tables
    to the device and, for K1, make the grid query its launch makes (the
    kernel's attributes and occupancy, cached; it loads the kernel's
    module). Launches nothing: the launch counts stay those of the
    calls."""
    if fuse_a is None:
        fuse_a = fuse_a_default()
    _lut(device)
    if not fuse_a:
        _kernel_k2()
        return
    _kernel()
    k1_grid(blocks, channels, n_rows=n_rows, num_samples=num_samples,
            out_bits=out_bits, wide=wide, raw=False, device=device)


def _check_field(name: str, t: torch.Tensor, shape: tuple, dev) -> None:
    """int32 on ``dev`` with ``shape`` and contiguous trailing dims (the
    block stride is free)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    inner = 1
    for size, stride in reversed(list(zip(t.shape[1:], t.stride()[1:]))):
        if size != 1 and stride != inner:
            raise ValueError(f"{name} trailing dims are not contiguous")
        inner *= size


def _check_blocks_channels(B: int, C: int, what: str) -> None:
    if not 1 <= B <= 65535:
        raise ValueError(f"{what}: {B} blocks (1..65535)")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{what}: {C} channels (1..{MAX_CHANNELS})")


def _check_args(args: dict) -> tuple[int, int]:
    """Validate K1's arguments: dtype, device, shapes and layout; returns
    (B, C).

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
        _check_field(f"K1: {k}", args[k], shape, dev)
    _check_blocks_channels(B, C, "K1")
    return B, C


def _check_packed(packed, lane_steps, gain_a, gain_b, wide: bool
                  ) -> tuple[int, int, int]:
    """Validate K2's arguments; returns (B, R_pad, C)."""
    dev = packed.device
    if packed.dim() != 3:
        raise ValueError(f"K2: packed has shape {tuple(packed.shape)}, "
                         "expected (B, R_pad, 128)")
    B, R, _ = packed.shape
    C = gain_a.shape[-1]
    if R < 1 or R % TILE_R:
        raise ValueError(f"K2: {R} packed rows (a positive multiple of "
                         f"{TILE_R})")
    _check_field("K2: packed", packed, (B, R, LANES), dev)
    if not packed.is_contiguous():
        raise ValueError("K2: packed is not contiguous")
    _check_field("K2: lane_steps", lane_steps, (B, 4, C), dev)
    _check_field("K2: gain_a", gain_a, (B, C), dev)
    _check_field("K2: gain_b", gain_b, (B, C), dev)
    _check_blocks_channels(B, C, "K2")
    if len(base_names(wide)) * C > LANES:
        raise ValueError(f"K2: {C} channels exceed the packed layout")
    return B, R, C


def _device_of(t: torch.Tensor, what: str):
    dev = t.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: tensors on {dev}; expected cuda or cpu")
    return dev


def _launch_k1(args: dict, out: torch.Tensor, *, n_rows: int,
               num_samples: int, out_bits: int, wide: bool,
               raw: bool) -> None:
    dev = out.device
    B, C = _check_args(args)
    fn = _kernel()
    with torch.cuda.device(dev):
        ptr_stride = []
        for k in ARG_ORDER:
            t = args[k]
            ptr_stride += [t.data_ptr(), t.stride(0)]
        rc = fn(
            *ptr_stride, _lut(dev).data_ptr(), out.data_ptr(), B, C,
            n_rows, num_samples, out_bits, int(wide), int(raw),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    launches["K1"] += 1


def synth_k1_raw(args: dict, *, n_rows: int, wide: bool = False):
    """K1's raw mode: (i_rows, q_rows), int16 (B, R_pad, 128), all R_pad
    rows, before the finalize. CPU tensors run the plain version."""
    dev = _device_of(args["code_l"], "K1")
    if dev.type == "cpu":
        return synth_batch_torch_raw(args, n_rows=n_rows, wide=wide,
                                     fuse_a=True)
    n_rows_pad = padded_rows(n_rows)
    B = args["code_l"].shape[0]
    out = torch.empty((2, B, n_rows_pad, LANES), dtype=torch.int16,
                      device=dev)
    _launch_k1(args, out, n_rows=n_rows_pad, num_samples=n_rows_pad * LANES,
               out_bits=16, wide=wide, raw=True)
    return out[0], out[1]


def stage_b_packed_cuda(packed, lane_steps, gain_a, gain_b,
                        wide: bool = False):
    """K2: stage B over packed bases (B, R_pad, 128) → raw rows (i_rows,
    q_rows), int16 (B, R_pad, 128). Same arguments and result as
    synth_torch.stage_b_packed_torch, which CPU tensors run."""
    dev = _device_of(packed, "K2")
    if dev.type == "cpu":
        return stage_b_packed_torch(packed, lane_steps, gain_a, gain_b,
                                    wide=wide)
    B, R, C = _check_packed(packed, lane_steps, gain_a, gain_b, wide)
    fn = _kernel_k2()
    with torch.cuda.device(dev):
        out = torch.empty((2, B, R, LANES), dtype=torch.int16, device=dev)
        rc = fn(
            packed.data_ptr(), lane_steps.data_ptr(), lane_steps.stride(0),
            gain_a.data_ptr(), gain_a.stride(0), gain_b.data_ptr(),
            gain_b.stride(0), _lut(dev).data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), B, C, R, int(wide),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {rc}")
    launches["K2"] += 1
    return out[0], out[1]


def synth_batch_cuda_raw(args: dict, *, n_rows: int, wide: bool,
                         fuse_a: bool):
    """Raw rows of a batch before the finalize: (i_rows, q_rows), int16
    (B, R_pad, 128); the counterpart of the JAX package's
    ``synth_batch_pallas_raw``. ``fuse_a`` runs K1's raw mode, otherwise
    the producer feeds K2. CPU tensors run the plain versions."""
    dev = _device_of(args["code_l"], "synthesis")
    if dev.type == "cpu":
        return synth_batch_torch_raw(args, n_rows=n_rows, wide=wide,
                                     fuse_a=fuse_a)
    if fuse_a:
        return synth_k1_raw(args, n_rows=n_rows, wide=wide)
    packed = row_bases_packed(args["code_l"], args["carr_l"], args["nav"],
                              args["ca_packed"], padded_rows(n_rows),
                              wide=wide)
    return stage_b_packed_cuda(packed, args["lane_steps"], args["gain_a"],
                               args["gain_b"], wide=wide)


def synth_blocks_batch_cuda(args: dict, *, n_rows: int, num_samples: int,
                            out_bits: int = 16, wide: bool = False,
                            fuse_a: bool | None = None):
    """Batch of B blocks → int16[B, 2*num_samples] (int8 for 8 bits).

    Same arguments and result as ops/synth_torch.synth_blocks_batch_torch.
    ``fuse_a`` (default :func:`fuse_a_default`, read at each call)
    selects K1, one launch per call; false runs the producer, K2 and the
    finalize. CPU tensors run the plain versions."""
    if fuse_a is None:
        fuse_a = fuse_a_default()
    dev = _device_of(args["code_l"], "K1" if fuse_a else "K2")
    if out_bits not in (8, 16):
        raise ValueError(f"out_bits={out_bits} (8 or 16)")
    if num_samples < 1 or n_rows * LANES < num_samples:
        raise ValueError(
            f"n_rows={n_rows} rows of {LANES} cannot hold "
            f"{num_samples} samples"
        )
    if not fuse_a:
        i_rows, q_rows = synth_batch_cuda_raw(args, n_rows=n_rows,
                                              wide=wide, fuse_a=False)
        return finalize_rows(i_rows, q_rows, num_samples, out_bits)
    if dev.type == "cpu":
        return synth_blocks_batch_torch(
            args, n_rows=n_rows, num_samples=num_samples, out_bits=out_bits,
            wide=wide,
        )
    with torch.cuda.device(dev):
        out = torch.empty(
            (args["code_l"].shape[0], 2 * num_samples),
            dtype=torch.int16 if out_bits == 16 else torch.int8, device=dev,
        )
    _launch_k1(args, out, n_rows=n_rows, num_samples=num_samples,
               out_bits=out_bits, wide=wide, raw=False)
    return out

