"""Host-side kernel arguments: block plans → int32 arrays → device tensors.

Every block plan is converted, on the host and in float64, into the
fixed-point int32 arrays the synthesis kernel consumes (Q46 code phase and
Q53 carrier phase as base-2^23 limbs, the split per-lane steps, the 8-bit
data-bit window, the split Q44 gain and the bit-packed C/A words):
:func:`args_from_arrays` in NumPy. A window of blocks is collated and
packed into ONE int32 array in one call of the port's collation engine
(``ops/collate.cc``, :func:`collate_plans`), which computes exactly what
``pack_args(args_from_arrays(...))`` of the compacted window gives, so it
ships to the device as a single copy; :func:`unpack_args` turns the device
copy back into per-field views.

Pure NumPy apart from the engine, :func:`unpack_args` and
:func:`to_device`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from operator import attrgetter

import numpy as np

from ..core.cacode import CA_PACKED_WORDS, ca_table_packed
from ..core.constants import (
    CA_SEQ_LEN, CODE_FREQ, COS_TABLE_512, SIN_TABLE_512,
)
from .plan import BlockPlan

LANES = 128
_Q_CODE = 46
_Q_CARR = 53
_M23 = (1 << 23) - 1

#: kernel argument names, in the order of the kernel's parameters
ARG_ORDER = (
    "code_l", "carr_l", "nav", "lane_steps", "ca_packed", "gain_a", "gain_b",
)

# The collation's errors, in the order it checks them. Real exceptions,
# not asserts: these invariants guard against silent output corruption
# (wrong chips / data bits) and must survive ``python -O``.
_Q46_RANGE = "block too long for the Q46 code-phase range"
_ROW_WINDOW = ("sample rate too low even for the 128-chip row window "
               "(minimum ~1.03 Msps)")
_BIT_WINDOW = "data-bit window overflow: block too long for the 8-bit window"
_NAV_BUFFER = "data-bit index past the 60-word nav buffer"


def needs_wide_window(delt: float) -> bool:
    """True when a 128-lane row can span ≥64 chips, i.e. the sample rate
    is below ~2.06 Msps and the kernel must build the 128-chip (4-word)
    window instead of the 64-chip (2-word) fast path. The 0.1% margin
    covers code Doppler and oscillator error (both ≤1e-5 relative)."""
    return CODE_FREQ * 1.001 * delt * (LANES - 1) >= 63.0


def _limbs3(v: np.ndarray) -> np.ndarray:
    """Non-negative int64 array (..., ) → int32 (..., 3) base-2^23 limbs."""
    v = np.asarray(v, dtype=np.int64)
    return np.stack(
        [v & _M23, (v >> 23) & _M23, v >> 46], axis=-1
    ).astype(np.int32)


def _limbs_shl(l: np.ndarray, s: int, mod_bits: int | None = None) -> np.ndarray:
    """Shift a base-2^23 limb vector left by s (< 23) bits, exactly.

    Values like step128*4096 overflow int64, so scaling happens in limb
    space with explicit carries. mod_bits (e.g. 53 for the carrier) drops
    bits at and above 2^mod_bits."""
    l = l.astype(np.int64)
    l0 = (l[..., 0] << s) & _M23
    c0 = l[..., 0] >> (23 - s)
    l1 = ((l[..., 1] << s) | c0) & _M23
    c1 = l[..., 1] >> (23 - s)
    l2 = (l[..., 2] << s) | c1
    if mod_bits is not None:
        l2 &= (1 << (mod_bits - 46)) - 1
    return np.stack([l0, l1, l2], axis=-1).astype(np.int32)


def _lut_mags() -> np.ndarray:
    """Distinct carrier-LUT magnitudes (shared by both tables), for the
    Q44 gain-fold exactness screen in args_from_arrays."""
    return np.unique(
        np.abs(np.concatenate([SIN_TABLE_512, COS_TABLE_512]))
    ).astype(np.float64)


_LUT_MAGS = _lut_mags()


def _fold_exact(g: float) -> tuple[int, int]:
    """A Q44 gain G, split into its high and low 22 bits, whose device
    product floor(T * G / 2^44) is the reference C's float64 trunc(T*g)
    for every LUT magnitude T (gps.c:2781-2782).

    Each T admits the G in [t * 2^44 / T, (t + 1) * 2^44 / T) with
    t = trunc(fl(T*g)); the nearest G to g * 2^44 in the intersection is
    taken. The intersection is empty only where two magnitudes round
    their products to opposite sides of integers: no single gain then
    gives the reference's bytes, and this raises."""
    lo, hi = 0, 1 << 62
    for T in _LUT_MAGS:
        if T == 0.0:
            continue
        t, m = int(np.trunc(T * g)), int(T)
        lo = max(lo, -((-t << 44) // m))  # ceil(t * 2^44 / T)
        hi = min(hi, -((-(t + 1) << 44) // m) - 1)
    if lo > hi:
        raise ValueError(_no_gain(g))
    G = min(max(int(np.floor(g * float(1 << 44))), lo), hi)
    return G >> 22, G & ((1 << 22) - 1)


def _no_gain(g: float) -> str:
    return (f"no Q44 gain gives trunc(T*g) for every carrier-table "
            f"magnitude T at g = {g!r}")


def args_from_arrays(
    active: np.ndarray,
    code_phase: np.ndarray,
    f_code: np.ndarray,
    carr_phase: np.ndarray,
    f_carr: np.ndarray,
    carr_phase_i: np.ndarray,
    carr_step_i: np.ndarray,
    gain: np.ndarray,
    iword: np.ndarray,
    ibit: np.ndarray,
    icode: np.ndarray,
    prn: np.ndarray,
    dwrd: np.ndarray,
    num_samples: int,
    delt: float,
    int_nco: bool = False,
) -> dict:
    """Vectorized plan→kernel-args conversion over arbitrary leading dims.

    Per-channel arrays are (..., C); dwrd is (..., C, 60).
    Returns the kernel-args dict (see plan_to_args) with the same leading
    dims — pure NumPy, so converting a whole window of blocks costs the
    same handful of array ops as one block.
    """
    act = np.asarray(active)
    step = f_code * delt  # chips / sample, f64 (exactly as C forms it)
    if not np.all(np.where(act, step, 0.0) * num_samples < (1 << 17)):
        raise ValueError(_Q46_RANGE)
    # A 128-lane row must stay inside its pre-shifted chip window:
    # 64 chips (2 words) on the fast path, 128 chips (4 words) when
    # needs_wide_window(delt) — which supports rates down to ~1.03 Msps
    # (one sample per chip; below that the C/A code is undersampled).
    limit = 127.0 if needs_wide_window(delt) else 63.0
    if not np.all(np.where(act, step, 0.0) * (LANES - 1) < limit):
        raise ValueError(_ROW_WINDOW)

    code0_q = np.rint(code_phase * (1 << _Q_CODE)).astype(np.int64)
    cstep_q = np.rint(step * (1 << _Q_CODE)).astype(np.int64)

    if int_nco:
        # The reference's integer NCO counts 2^25 per carrier cycle in a
        # uint32 and indexes with (phase >> 16) & 511 (gps.h:221-223,
        # gps.c:2777). Embedding mod-2^25 phase in Q53 (<< 28) reproduces
        # both the index and the 128-cycle wrap exactly.
        carr0_q = (carr_phase_i.astype(np.int64) & ((1 << 25) - 1)) << (
            _Q_CARR - 25
        )
        kstep_q = carr_step_i.astype(np.int64) << (_Q_CARR - 25)
    else:
        carr0_q = np.rint(carr_phase * (1 << _Q_CARR)).astype(np.int64)
        kstep_q = np.rint((f_carr * delt) * float(1 << _Q_CARR)).astype(
            np.int64
        )

    # --- limb decomposition; ×128/×64 scalings happen in limb space with
    # explicit carries because step128*4096 overflows int64 ---
    mod = np.int64(1) << _Q_CARR
    c1 = _limbs_shl(_limbs3(cstep_q), 7)  # step128 (kstep_q<<7 fits int64,
    k1 = _limbs3((kstep_q << 7) % mod)    # cstep_q<<7 does too)
    c64, k64 = _limbs_shl(c1, 6), _limbs_shl(k1, 6, _Q_CARR)
    code_l = np.stack(
        [_limbs3(code0_q), c1, c64, _limbs_shl(c64, 6)], axis=-3
    )  # (..., 4, C, 3)
    carr_l = np.stack(
        [_limbs3(carr0_q % mod), k1, k64, _limbs_shl(k64, 6, _Q_CARR)],
        axis=-3,
    )

    # --- per-lane split steps (stage B) ---
    lane_steps = np.stack([
        (cstep_q >> 23).astype(np.int32),
        (cstep_q & _M23).astype(np.int32),
        (kstep_q >> 23).astype(np.int32),  # arithmetic shift for negatives
        (kstep_q & _M23).astype(np.int32),
    ], axis=-2)  # (..., 4, C)

    # --- data-bit window: all bits any row of this block can touch ---
    tcu0 = (iword * 600 + ibit * 20 + icode).astype(np.int64)
    bidx0 = tcu0 // 20
    # The 8-bit window must cover every data bit any row (incl. tile
    # padding, ≤ +32640 samples) can touch: tcu spans ≤ wraps_max + 1.
    wraps_max = int(
        np.max(
            np.where(act, (code_phase + (num_samples + 32768) * step)
                     // CA_SEQ_LEN, 0)
        )
    )
    if not np.all((tcu0 + wraps_max + 1) // 20 - bidx0 <= 7):
        raise ValueError(_BIT_WINDOW)
    bidx = bidx0[..., None] + np.arange(8, dtype=np.int64)  # (..., C, 8)
    iw = bidx // 30
    # A block never legitimately reads past word 59 (the window invariant
    # above bounds bidx); raise instead of clamping wrong bits in.
    if int(np.max(np.where(act[..., None], iw, 0))) > 59:
        raise ValueError(_NAV_BUFFER)
    iw = np.minimum(iw, 59)  # keep inactive-slot lanes in range
    ib = bidx - (bidx // 30) * 30
    wsel = np.take_along_axis(dwrd.astype(np.int64), iw, axis=-1)
    bits = (wsel >> (29 - ib)) & 1
    bits8 = (bits << np.arange(8, dtype=np.int64)).sum(-1).astype(np.int32)
    nav = np.stack([
        tcu0.astype(np.int32), bidx0.astype(np.int32), bits8
    ], axis=-2)  # (..., 3, C)

    # Gain in Q44 fixed point, split into two int32 halves (22 bits each)
    # so trunc(gain * LUT) is computed exactly on the device in int32.
    g = np.where(act, gain, 0.0)
    g44 = np.floor(g * float(1 << 44))
    ga = np.floor(g * float(1 << 22)).astype(np.int32)  # high 22+ bits
    gb = (g44 - ga.astype(np.float64) * float(1 << 22)).astype(np.int32)
    # The Q44 truncation drops gain bits below 2^-44, so the split computes
    # floor(T * g44 / 2^44) <= trunc(T*g): one less where the product T*g
    # sits a hair at or above an integer (within 2^-21). The LUT magnitude
    # set has only 115 distinct values T; a distance prescreen (2 array
    # passes) flags such products, and the exact comparison runs only when
    # something is flagged. A (block, channel) whose split is not exact
    # for every T gets another Q44 gain: see _fold_exact.
    mags = _LUT_MAGS[:, None]  # (M, 1)
    gf = g[..., None, :]  # (..., 1, C)
    prod = mags * gf  # (..., M, C)
    # Inactive slots carry g == 0: every product is exactly the integer
    # 0 and the split is trivially exact — exclude them or the prescreen
    # would flag every batch.
    flagged = (prod - np.floor(prod) < 2.0**-20) & (gf > 0.0)
    if np.any(flagged):
        exact = np.trunc(prod).astype(np.int64)
        q44 = (
            ga.astype(np.int64)[..., None, :] * mags.astype(np.int64)
            + ((gb.astype(np.int64)[..., None, :] * mags.astype(np.int64))
               >> 22)
        ) >> 22
        bad = np.any(exact != q44, axis=-2)  # (..., C)
        if np.any(bad):
            ga, gb = ga.copy(), gb.copy()
            for at in zip(*np.nonzero(bad)):
                ga[at], gb[at] = _fold_exact(float(g[at]))

    # Bit-packed C/A chips from the cached per-PRN table (wrap-extended);
    # packing 1023 chips per block would dominate collation otherwise.
    ca_packed = _packed_table0()[np.where(act, prn, 0)]

    return dict(
        code_l=code_l,
        carr_l=carr_l,
        nav=nav,
        lane_steps=lane_steps,
        ca_packed=ca_packed,
        gain_a=ga,
        gain_b=gb,
    )


def plan_to_args(plan: BlockPlan, int_nco: bool = False) -> dict:
    """Convert a BlockPlan to the int32 arrays the kernel consumes.

    Returns a dict of kernel args, every one int32/uint32:
      code_l  int32[4, C, 3] — Q46 code phase + step128·{1,64,4096} limbs
      carr_l  int32[4, C, 3] — Q53 carrier phase + step limbs (mod 2^53)
      nav     int32[3, C]    — tcu0, bidx0, packed 8-bit data-bit window
      lane_steps int32[4, C] — cA, cB, kA, kB per-lane split steps
      ca_packed uint32[C,36] — bit-packed C/A chips (wrap-extended)
      gain_a/gain_b int32[C] — split Q44 gain
    """
    return args_from_arrays(
        plan.active, plan.code_phase, plan.f_code, plan.carr_phase,
        plan.f_carr, plan.carr_phase_i, plan.carr_step_i, plan.gain,
        plan.iword, plan.ibit, plan.icode, plan.prn, plan.dwrd,
        plan.num_samples, plan.delt, int_nco=int_nco,
    )


@functools.cache
def _packed_table0() -> np.ndarray:
    """uint32[33, 36]: zero row (inactive) + packed chips per PRN."""
    return np.concatenate(
        [np.zeros((1, CA_PACKED_WORDS), np.uint32), ca_table_packed()], axis=0
    )


def packed_ca_for_prns(prns: np.ndarray) -> np.ndarray:
    """uint32[C, 36] packed chips for a PRN vector (0 = inactive → zeros)."""
    return _packed_table0()[np.maximum(np.asarray(prns), 0)]


# ---------------------------------------------------------------------------
# Windows of blocks
# ---------------------------------------------------------------------------


def chain_carrier_phases(
    carr0: np.ndarray, f_carr: np.ndarray, num_samples: int, delt: float
) -> np.ndarray:
    """Block-start carrier phases for a window of epochs via prefix sum.

    carr0: f64[C] phase at the window start; f_carr: f64[E, C] per-epoch
    Doppler. Returns f64[E, C] start phases. frac() after an f64 cumsum
    matches per-block chaining to ~1e-13/block — far below the 1/512 LUT
    quantum (same argument as ops/plan.py).
    """
    adv = f_carr * (num_samples * delt)
    starts = carr0[None, :] + np.concatenate(
        [np.zeros((1, adv.shape[1])), np.cumsum(adv[:-1], axis=0)], axis=0
    )
    return starts - np.floor(starts)


@dataclass
class PlanBatch:
    """A window of consecutive block plans collated for device dispatch."""

    packed: np.ndarray  # int32 (B, K): the window's args as they ship
    spec: tuple  # the layout of ``packed`` (pack_args, unpack_args)
    num_samples: int
    n_blocks: int
    folds: np.ndarray  # int32 (B,): the slots whose Q44 gain was folded

    @functools.cached_property
    def args(self) -> dict:
        """The batched kernel args (leading axis = blocks): NumPy views of
        ``packed``."""
        out, off = {}, 0
        B = self.packed.shape[0]
        for k, dtype_str, shape in self.spec:
            n = int(np.prod(shape))
            out[k] = self.packed[:, off:off + n].view(dtype_str).reshape(
                (B,) + shape)
            off += n
        return out


def pack_args(args) -> tuple[np.ndarray, tuple]:
    """Flatten a batch's kernel args into ONE int32 array (B, K).

    Every collated arg is 32-bit with a leading blocks axis, so the whole
    window ships to the device as a single contiguous copy. Returns
    (packed, spec) where spec is the static layout for :func:`unpack_args`
    (hashable: name, dtype str, trailing shape). A :class:`PlanBatch` is
    packed already: its array and spec are returned as they are.
    """
    if isinstance(args, PlanBatch):
        return args.packed, args.spec
    parts, spec = [], []
    for k in sorted(args):
        v = np.asarray(args[k])
        if v.dtype.itemsize != 4:
            raise ValueError(f"pack_args: {k} is not 32-bit ({v.dtype})")
        B = v.shape[0]
        parts.append(v.view(np.int32).reshape(B, -1))
        spec.append((k, v.dtype.str, v.shape[1:]))
    return np.concatenate(parts, axis=1), tuple(spec)


def unpack_args(packed, spec: tuple) -> dict:
    """Inverse of :func:`pack_args` on a torch int32 tensor (B, K).

    Every field is a view of ``packed`` (no copy): a column slice reshaped
    to the field's trailing shape, so each field's trailing dims are
    contiguous and its block stride is K. uint32 fields (``ca_packed``)
    stay in their int32 bit pattern — the kernels read them as bits.
    """
    out, off = {}, 0
    B = packed.shape[0]
    for k, _dtype_str, shape in spec:
        n = 1
        for s in shape:
            n *= s
        out[k] = packed[:, off:off + n].view((B,) + tuple(shape))
        off += n
    return out


def to_device(args: dict, device) -> dict:
    """numpy kernel args → int32 torch tensors on ``device``.

    uint32 arrays travel as their int32 bit pattern, exactly as
    :func:`pack_args` ships them."""
    import torch

    out = {}
    for k, v in args.items():
        a = np.ascontiguousarray(v)
        if a.dtype.itemsize != 4 or a.dtype.kind not in "iu":
            raise ValueError(f"to_device: {k} is not 32-bit integer ({a.dtype})")
        out[k] = torch.from_numpy(a.view(np.int32)).to(device)
    return out


#: the plan fields the collation engine reads, by dtype, in its order
_F64_FIELDS = attrgetter("code_phase", "f_code", "carr_phase", "f_carr",
                         "gain")
_I64_FIELDS = attrgetter("iword", "ibit", "icode", "prn")
_NCO_FIELDS = attrgetter("carr_phase_i", "carr_step_i")


@functools.cache
def load_engine():
    """The collation engine, ops/collate.cc's ``gcollate_window``, typed:
    built with g++ the first time, loaded once a process. A missing
    compiler or a failed build raises."""
    from ..io.native import load_collate

    fn = load_collate().gcollate_window
    c, p = ctypes, ctypes.c_void_p
    fn.restype = c.c_long
    fn.argtypes = [
        c.c_long, c.c_long, c.c_long, c.c_double, c.c_double,  # B..limit
        c.c_int, c.c_int, c.c_long,  # int_nco, compact, compact_multiple
        p, p, p, p, p,  # active, f64, i64, nco, dwrd
        p, c.c_long, p, c.c_long,  # ca_table, rows; mags, count
        p, p, p,  # out, folds, fault
    ]
    return fn


@functools.cache
def _spec(k: int) -> tuple:
    """pack_args' spec of a window of ``k`` channel slots."""
    u32, i32 = np.dtype(np.uint32).str, np.dtype(np.int32).str
    return (
        ("ca_packed", u32, (k, CA_PACKED_WORDS)), ("carr_l", i32, (4, k, 3)),
        ("code_l", i32, (4, k, 3)), ("gain_a", i32, (k,)),
        ("gain_b", i32, (k,)), ("lane_steps", i32, (4, k)),
        ("nav", i32, (3, k)),
    )


#: int32 words per channel slot of a packed block
_SLOT_WORDS = sum(int(np.prod(shape)) for _, _, shape in _spec(1))


def _gathered(plans, fields, dtype) -> np.ndarray:
    """The ``fields`` of every plan, in one array of ``dtype``."""
    return np.concatenate(
        [a for p in plans for a in fields(p)]).astype(dtype, copy=False)


def collate_plans(
    plans: list[BlockPlan], int_nco: bool = False, compact: bool = True,
    compact_multiple: int = 1,
) -> PlanBatch:
    """Collate and pack a window of plans in one call of the collation
    engine: ``pack_args(args_from_arrays(...))`` of the compacted window,
    word for word, and the same errors at the same inputs.

    With ``compact`` (default), each block's ACTIVE channels are moved to
    the front and the channel axis is trimmed to the batch's maximum
    active count: the kernel's channel loop is fully dense instead of
    computing zero-gain slots (typically 9-11 of 12 are active). The
    cross-channel sum is exact int32 addition — commutative and
    associative — so reordering/trimming is bit-identical.

    ``compact_multiple`` rounds the trimmed extent UP to a multiple
    (capped at the full channel count), bounding the number of distinct
    channel extents a long run produces.
    """
    fn = load_engine()
    p0 = plans[0]
    B, C = len(plans), len(p0.active)
    if any(len(p.active) != C for p in plans):
        raise ValueError("collate_plans: the plans' channel counts differ")
    active = np.concatenate([p.active for p in plans]).astype(
        bool, copy=False)
    f64 = _gathered(plans, _F64_FIELDS, np.float64)
    i64 = _gathered(plans, _I64_FIELDS, np.int64)
    nco = _gathered(plans, _NCO_FIELDS, np.int64) if int_nco else None
    dwrd = np.concatenate([p.dwrd for p in plans]).astype(
        np.uint32, copy=False)
    if (f64.size, i64.size, dwrd.size) != (5 * B * C, 4 * B * C, 60 * B * C):
        raise ValueError("collate_plans: a plan field has the wrong shape")
    out = np.empty(B * _SLOT_WORDS * C, np.int32)
    folds = np.empty(B, np.int32)
    fault = np.zeros(1, np.float64)
    table = _packed_table0()
    limit = 127.0 if needs_wide_window(p0.delt) else 63.0
    k = fn(B, C, p0.num_samples, p0.delt, limit, int_nco, compact,
           compact_multiple, active.ctypes.data, f64.ctypes.data,
           i64.ctypes.data, None if nco is None else nco.ctypes.data,
           dwrd.ctypes.data, table.ctypes.data, len(table),
           _LUT_MAGS.ctypes.data, len(_LUT_MAGS), out.ctypes.data,
           folds.ctypes.data, fault.ctypes.data)
    if k < 0:
        raise _engine_error(k, float(fault[0]), len(table))
    return PlanBatch(
        packed=out[:B * _SLOT_WORDS * k].reshape(B, _SLOT_WORDS * k),
        spec=_spec(k), num_samples=p0.num_samples, n_blocks=B, folds=folds,
    )


def _engine_error(code: int, fault: float, table_rows: int) -> Exception:
    """The exception the NumPy path raises where the engine returned
    ``code`` (``enum Error`` in ops/collate.cc)."""
    if code == -5:
        return IndexError(f"index {int(fault)} is out of bounds for axis 1 "
                          f"with size 60")
    if code == -6:
        return ValueError(_no_gain(fault))
    if code == -7:
        return IndexError(f"index {int(fault)} is out of bounds for axis 0 "
                          f"with size {table_rows}")
    return ValueError({-1: _Q46_RANGE, -2: _ROW_WINDOW, -3: _BIT_WINDOW,
                       -4: _NAV_BUFFER}[code])
