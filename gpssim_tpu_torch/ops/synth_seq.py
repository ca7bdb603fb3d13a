"""Sequential-parity layer: make any closed-form block output bit-exact
against the reference's sequential float64 recurrences.

The reference advances code/carrier phase by repeated accumulation inside
the sample loop (gps.c:2789 ``code_phase += f_code*delt``, gps.c:2820
carrier); the framework's kernels use the closed form ``phase0 + n*step``
(ops/plan.py) so blocks parallelize.  The divergence is a bounded rounding
random walk (≤ N half-ulps ≈ 1e-7 chips per block) — invisible except when
a sample's phase lands inside that band around a chip/LUT quantization
boundary, where the two semantics pick different indices.

The port's sequential engine (ops/seq.cc, built by io/native.py) replays
the sequential recurrences exactly and provides:

* :func:`carrier_chain` — block-boundary carrier phases with sequential
  semantics, used by the scenario planner so block-start state matches the
  reference bit-for-bit;
* :func:`seq_corrections` / :func:`seq_corrections_window` /
  :func:`correct_window` — the sparse set of samples where the sequential
  output differs from a closed form, with the sequential int16
  accumulators, so a closed-form block is patched into the sequential-
  exact stream.  The closed form is the one the caller's bytes hold:
  ``fixed_point=True`` (the default) is the device kernels' fixed point
  (Q46 code phase, Q53 carrier phase, ops/args.py), ``False`` the NumPy
  backend's float64 form.  O(hits), not O(samples): boundary candidates
  are located analytically on the exact closed-form progression with a
  modular first-hit solver, and the sequential state fast-forwards
  between candidates via the exact binade mantissa progression; the
  sample-major screen is kept as ``_ref=True`` and cross-checked by the
  tests;
* :func:`synth_block_seq` — closed-form NumPy synth + patch: the strict
  parity path of the NumPy backend.

:func:`synth_block_seq_native`, the full sequential synthesizer of the
native backend (and the yardstick of the tests), comes from the shared
host runtime (native/gpssim_native.cc, tools/build_native.sh).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.constants import COS_TABLE_512, SIN_TABLE_512
from .plan import BlockPlan
from .synth_numpy import synth_block_numpy

_SIN_F64 = np.ascontiguousarray(SIN_TABLE_512, dtype=np.float64)
_COS_F64 = np.ascontiguousarray(COS_TABLE_512, dtype=np.float64)

_configured = False
_shared_configured = False

#: the plan fields the engine reads, with their C types, in its order
_FIELDS = (
    ("code_phase", np.float64), ("f_code", np.float64),
    ("carr_phase", np.float64), ("f_carr", np.float64),
    ("carr_phase_i", np.uint32), ("carr_step_i", np.int32),
    ("gain", np.float64), ("iword", np.int64), ("ibit", np.int64),
    ("icode", np.int64), ("ca", np.int8), ("dwrd", np.uint32),
)


def _lib():
    """The port's sequential engine (ops/seq.cc), or None."""
    global _configured
    from ..io import native as _native

    lib = _native._load_seq()
    if lib is None:
        return None
    if not _configured:
        c = ctypes
        # argtypes mirror the C signatures exactly (ops/seq.cc); nothing
        # is left to ctypes' variadic default conversion.
        lib.gseq_carr_chain.restype = c.c_long
        lib.gseq_carr_chain.argtypes = [
            c.c_long, c.c_long, c.c_long, c.c_double,
            c.c_void_p, c.c_void_p, c.c_void_p,
        ]
        lib.gseq_diff_block.restype = c.c_long
        lib.gseq_diff_block.argtypes = (
            [c.c_long, c.c_long, c.c_double, c.c_int, c.c_int, c.c_int]
            + [c.c_void_p] * 15  # active..dwrd, sin/cos LUTs
            + [c.c_long]         # max_out
            + [c.c_void_p] * 5   # out_idx/i/q, end_carr, end_carr_i
            + [c.c_int]          # want_end
            + [c.c_void_p]       # n_cand
        )
        lib.gseq_diff_window.restype = c.c_long
        lib.gseq_diff_window.argtypes = (
            [c.c_long, c.c_long, c.c_long, c.c_double, c.c_int, c.c_int]
            + [c.c_void_p] * 15  # active..dwrd, sin/cos LUTs
            + [c.c_long]         # max_out (per block)
            + [c.c_void_p] * 5   # out_idx/i/q, out_n, out_cand
        )
        _configured = True
    return lib


def _shared():
    """The shared host runtime with gseq_synth_block, or None."""
    global _shared_configured
    from ..io import native as _native

    lib = _native._load()
    if lib is None:
        return None
    if not _shared_configured:
        c = ctypes
        lib.gseq_synth_block.restype = c.c_long
        lib.gseq_synth_block.argtypes = (
            [c.c_long, c.c_long, c.c_double, c.c_int, c.c_int]
            + [c.c_void_p] * 18      # active..dwrd, LUTs, out, end state
        )
        _shared_configured = True
    return lib


def seq_available() -> bool:
    """Whether strict parity can run: the port's engine (the corrections,
    the carrier chain) and the shared runtime's sequential synthesizer
    (the native backend, the realtime failover) both load."""
    return _lib() is not None and _shared() is not None


def carrier_chain(
    carr0: np.ndarray, f_carr: np.ndarray, num_samples: int, delt: float
) -> np.ndarray:
    """Sequential-f64 carrier chain over a window of K blocks.

    carr0: f64[C] phase at the window start; f_carr: f64[K, C] per-block
    Doppler (zero on inactive slots — their phase carries through exactly).
    Returns f64[K+1, C]: rows 0..K-1 are block-start phases, row K the
    end-of-window phase.  Raises RuntimeError if the native engine is
    unavailable.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("native sequential engine unavailable")
    f_carr = np.ascontiguousarray(f_carr, dtype=np.float64)
    K, C = f_carr.shape
    carr0 = np.ascontiguousarray(carr0, dtype=np.float64)
    out = np.empty((K + 1, C), dtype=np.float64)
    rc = lib.gseq_carr_chain(
        C, K, int(num_samples), float(delt),
        carr0.ctypes.data_as(ctypes.c_void_p),
        f_carr.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise ValueError(
            f"carrier_chain: {C} channels exceeds the native slot capacity"
        )
    return out


def seq_corrections(
    plan: BlockPlan, int_nco: bool = False, max_out: int = 4096,
    _ref: bool = False, want_end: bool = False, fixed_point: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Samples where sequential semantics differ from the closed form.

    Returns (idx, i16, q16, end_carr, end_carr_i): at sample ``idx[k]`` the
    sequential int16 accumulators are ``(i16[k], q16[k])``.  idx is empty
    for almost every block.  ``fixed_point`` picks the closed form the
    caller's bytes hold: the device kernels' fixed point (True) or the
    NumPy backend's float64 form (False).  With ``want_end`` the last two
    outputs are the sequential block-end carrier phases (inactive slots
    pass through); without it (the production default) the walk past the
    last candidate — the ENTIRE block when there are no candidates — is
    skipped, because the planner's carrier chain already owns
    block-boundary state, and end_carr/end_carr_i just pass the inputs
    through.

    ``_ref=True`` runs the sample-major reference screen instead of the
    binade-segment fast path — a test hook for the cross-check.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("native sequential engine unavailable")
    C = plan.num_channels
    cv = ctypes.c_void_p
    active = np.ascontiguousarray(plan.active, dtype=np.uint8)
    args = [np.ascontiguousarray(getattr(plan, name), dtype=dt)
            for name, dt in _FIELDS]
    out_idx = np.empty(max_out, dtype=np.int64)
    out_i = np.empty(max_out, dtype=np.int16)
    out_q = np.empty(max_out, dtype=np.int16)
    end_carr = np.empty(C, dtype=np.float64)
    end_carr_i = np.empty(C, dtype=np.uint32)
    n_cand = ctypes.c_long(0)
    n = lib.gseq_diff_block(
        C, int(plan.num_samples), float(plan.delt), int(int_nco),
        int(fixed_point), int(_ref), active.ctypes.data_as(cv),
        *[a.ctypes.data_as(cv) for a in args],
        _SIN_F64.ctypes.data_as(cv), _COS_F64.ctypes.data_as(cv),
        max_out,
        out_idx.ctypes.data_as(cv), out_i.ctypes.data_as(cv),
        out_q.ctypes.data_as(cv),
        end_carr.ctypes.data_as(cv), end_carr_i.ctypes.data_as(cv),
        int(want_end), ctypes.byref(n_cand),
    )
    if n == -1:
        raise ValueError(
            "invalid block plan for sequential replay (data-word index out "
            "of range or too many channels)"
        )
    if n == -2:
        raise ValueError(f"more than {max_out} corrections in one block")
    return out_idx[:n], out_i[:n], out_q[:n], end_carr, end_carr_i


def _diff_window(plans: list[BlockPlan], int_nco: bool, max_out: int,
                 fixed_point: bool) -> tuple[list, np.ndarray]:
    """The corrections of a window in one native call, and the candidates
    the screen evaluated in each block."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native sequential engine unavailable")
    B = len(plans)
    if not B:
        return [], np.zeros(0, dtype=np.int64)
    for p in plans[1:]:
        # The stacked native call replays every block with plans[0]'s
        # static facts — a heterogeneous window would be silently
        # replayed wrong (wrong sample count / phase step), so refuse.
        if p.num_samples != plans[0].num_samples or p.delt != plans[0].delt:
            raise ValueError(
                "seq_corrections_window needs a homogeneous window: "
                f"num_samples {p.num_samples} != {plans[0].num_samples} "
                f"or delt {p.delt} != {plans[0].delt}"
            )
    C = plans[0].num_channels
    cv = ctypes.c_void_p

    def stack(name, dt):
        return np.ascontiguousarray(
            np.stack([getattr(p, name) for p in plans]), dtype=dt
        )

    active = stack("active", np.uint8)
    args = [stack(name, dt) for name, dt in _FIELDS]
    out_idx = np.empty(B * max_out, dtype=np.int64)
    out_i = np.empty(B * max_out, dtype=np.int16)
    out_q = np.empty(B * max_out, dtype=np.int16)
    out_n = np.empty(B, dtype=np.int64)
    out_cand = np.empty(B, dtype=np.int64)
    rc = lib.gseq_diff_window(
        B, C, int(plans[0].num_samples), float(plans[0].delt),
        int(int_nco), int(fixed_point), active.ctypes.data_as(cv),
        *[a.ctypes.data_as(cv) for a in args],
        _SIN_F64.ctypes.data_as(cv), _COS_F64.ctypes.data_as(cv),
        max_out,
        out_idx.ctypes.data_as(cv), out_i.ctypes.data_as(cv),
        out_q.ctypes.data_as(cv), out_n.ctypes.data_as(cv),
        out_cand.ctypes.data_as(cv),
    )
    if rc == -2:
        # the per-plan path sizes its buffer larger and reports precisely
        out = [seq_corrections(p, int_nco=int_nco,
                               fixed_point=fixed_point)[:3] for p in plans]
        return out, out_cand
    if rc != 0:
        raise ValueError(
            "invalid block plan in window for sequential replay "
            "(data-word index out of range or too many channels)"
        )
    out = []
    for b in range(B):
        n = int(out_n[b])
        s = b * max_out
        out.append((out_idx[s:s + n], out_i[s:s + n], out_q[s:s + n]))
    return out, out_cand


def seq_corrections_window(
    plans: list[BlockPlan], int_nco: bool = False, max_out: int = 512,
    fixed_point: bool = True,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Corrections for a whole dispatch window in ONE native call.

    Identical results to calling :func:`seq_corrections` per plan (the
    native side runs the same screen per stacked block), but the
    per-block Python/ctypes marshalling collapses to one vectorized stack
    per field.  Returns
    [(idx, i16, q16), ...] aligned with ``plans``.

    A block overflowing ``max_out`` corrections (never observed) falls
    back to the per-plan path, which raises its descriptive error.
    """
    return _diff_window(plans, int_nco, max_out, fixed_point)[0]


def correct_window(blocks: list, plans: list[BlockPlan], bits: int,
                   int_nco: bool = False) -> tuple[list, np.ndarray,
                                                   np.ndarray]:
    """Patch a window of the device kernels' blocks (``bits``-bit
    interleaved I/Q, one per plan) into the sequential-exact stream.

    Returns (blocks, candidates, patched): the blocks, a patched one a
    writable copy and the others as given; the candidates the screen
    evaluated in each block; and the samples patched in each."""
    corrs, cands = _diff_window(plans, int_nco, 512, True)
    out = [apply_corrections(blk, bits, *corr)
           for blk, corr in zip(blocks, corrs)]
    patched = np.array([len(corr[0]) for corr in corrs], dtype=np.int64)
    return out, cands, patched


def apply_corrections(
    iq: np.ndarray, bits: int, idx: np.ndarray, i16: np.ndarray,
    q16: np.ndarray
) -> np.ndarray:
    """Patch a closed-form quantized block (interleaved I/Q) in place.

    ``iq`` is int16[2N] (bits=16) or int8[2N] (bits=8, post ``>>4``); the
    corrections carry absolute sequential accumulators so the patch is a
    plain overwrite in either format.  Device outputs arrive read-only;
    they are copied iff a patch is actually needed.
    """
    if len(idx) == 0:
        return iq
    if not iq.flags.writeable:
        iq = iq.copy()
    if bits == 16:
        iq[2 * idx] = i16
        iq[2 * idx + 1] = q16
    else:
        iq[2 * idx] = (i16 >> 4).astype(np.int8)
        iq[2 * idx + 1] = (q16 >> 4).astype(np.int8)
    return iq


def synth_block_seq(plan: BlockPlan, int_nco: bool = False) -> np.ndarray:
    """Sequential-exact block synth: closed-form NumPy + sparse patch.

    Bit-exact against the reference hot loop (gps.c:2767-2836) including
    its per-sample float64 phase accumulation.  int16[2N] interleaved.
    """
    iq16 = synth_block_numpy(plan, int_nco=int_nco)
    idx, i16, q16, _, _ = seq_corrections(plan, int_nco=int_nco,
                                          fixed_point=False)
    return apply_corrections(iq16, 16, idx, i16, q16)


def synth_block_seq_native(
    plan: BlockPlan, int_nco: bool = False, bits: int = 16
) -> np.ndarray:
    """Full native sequential synth (gseq_synth_block): the reference hot
    loop replayed in C++ — same output as :func:`synth_block_seq` but
    ~10x faster than the NumPy path, making hour-scale endurance goldens
    tractable on the host.  int16[2N] (bits=16) or int8[2N] (bits=8).
    """
    lib = _shared()
    if lib is None:
        raise RuntimeError("native sequential engine unavailable")
    C = plan.num_channels
    cv = ctypes.c_void_p

    def p(a, dt):
        return np.ascontiguousarray(a, dtype=dt)

    args = [
        p(plan.active, np.uint8),
        p(plan.code_phase, np.float64), p(plan.f_code, np.float64),
        p(plan.carr_phase, np.float64), p(plan.f_carr, np.float64),
        p(plan.carr_phase_i, np.uint32), p(plan.carr_step_i, np.int32),
        p(plan.gain, np.float64), p(plan.iword, np.int64),
        p(plan.ibit, np.int64), p(plan.icode, np.int64),
        p(plan.ca, np.int8), p(plan.dwrd, np.uint32),
    ]
    out = np.empty(
        2 * plan.num_samples, dtype=np.int16 if bits == 16 else np.int8
    )
    end_carr = np.empty(C, dtype=np.float64)
    end_carr_i = np.empty(C, dtype=np.uint32)
    rc = lib.gseq_synth_block(
        C, int(plan.num_samples), float(plan.delt), int(int_nco), int(bits),
        *[a.ctypes.data_as(cv) for a in args],
        _SIN_F64.ctypes.data_as(cv), _COS_F64.ctypes.data_as(cv),
        out.ctypes.data_as(cv),
        end_carr.ctypes.data_as(cv), end_carr_i.ctypes.data_as(cv),
    )
    if rc != 0:
        raise ValueError(
            "invalid block plan for native sequential synth (data-word "
            "index out of range or too many channels)"
        )
    return out
