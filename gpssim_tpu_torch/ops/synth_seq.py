"""Sequential-parity layer: make any closed-form block output bit-exact
against the reference's sequential float64 recurrences.

The reference advances code/carrier phase by repeated accumulation inside
the sample loop (gps.c:2789 ``code_phase += f_code*delt``, gps.c:2820
carrier); the framework's kernels use the closed form ``phase0 + n*step``
(ops/plan.py) so blocks parallelize.  The divergence is a bounded rounding
random walk (≤ N half-ulps ≈ 1e-7 chips per block) — invisible except when
a sample's phase lands inside that band around a chip/LUT quantization
boundary, where the two semantics pick different indices.

The native engine (native/gpssim_native.cc) replays the sequential
recurrences exactly and provides:

* :func:`carrier_chain` — block-boundary carrier phases with sequential
  semantics, used by the scenario planner so block-start state matches the
  reference bit-for-bit;
* :func:`seq_corrections` / :func:`apply_corrections` — the sparse set of
  samples where sequential and closed-form outputs differ, with the
  sequential int16 accumulators, so closed-form output from *any* backend
  (NumPy, XLA, Pallas — they are mutually bit-exact) is patched into the
  sequential-exact stream.  O(hits), not O(samples): boundary candidates
  are located analytically on the exact closed-form progression with a
  modular first-hit solver, and the sequential state fast-forwards
  between candidates via the exact binade mantissa progression (~640
  blocks/s on this host vs ~60 for the sample-major replay, which is
  kept as ``_ref=True`` and cross-checked by the fuzz tests);
* :func:`synth_block_seq` — closed-form NumPy synth + patch: the strict
  parity path used by the golden tests.

When the native library cannot be built, callers fall back to closed-form
semantics (the round-1 contract: rare ≤ chip-amplitude deviations at
16-bit, byte-identical at 8-bit on short runs).
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


def _lib():
    """The native library with the gseq_* symbols, or None."""
    global _configured
    from ..io import native as _native

    lib = _native._load()
    if lib is None:
        return None
    if not _configured:
        c = ctypes
        # argtypes mirror the C signatures exactly (native/gpssim_native.cc)
        # — the scalar max_out sits BETWEEN pointer groups in
        # gseq_diff_block, and nothing is left to ctypes' variadic
        # default conversion.
        lib.gseq_carr_chain.restype = c.c_long
        lib.gseq_carr_chain.argtypes = [
            c.c_long, c.c_long, c.c_long, c.c_double,
            c.c_void_p, c.c_void_p, c.c_void_p,
        ]
        for sym in (lib.gseq_diff_block, lib.gseq_diff_block_ref):
            sym.restype = c.c_long
            sym.argtypes = (
                [c.c_long, c.c_long, c.c_double, c.c_int]
                + [c.c_void_p] * 15  # active..dwrd, sin/cos LUTs
                + [c.c_long]         # max_out
                + [c.c_void_p] * 5   # out_idx/i/q, end_carr, end_carr_i
                + [c.c_int]          # want_end
            )
        lib.gseq_synth_block.restype = c.c_long
        lib.gseq_synth_block.argtypes = (
            [c.c_long, c.c_long, c.c_double, c.c_int, c.c_int]
            + [c.c_void_p] * 18      # active..dwrd, LUTs, out, end state
        )
        if hasattr(lib, "gseq_diff_window"):
            lib.gseq_diff_window.restype = c.c_long
            lib.gseq_diff_window.argtypes = (
                [c.c_long, c.c_long, c.c_long, c.c_double, c.c_int]
                + [c.c_void_p] * 15  # active..dwrd, sin/cos LUTs
                + [c.c_long]         # max_out (per block)
                + [c.c_void_p] * 4   # out_idx/i/q, out_n
            )
        _configured = True
    return lib


def seq_available() -> bool:
    return _lib() is not None


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
    _ref: bool = False, want_end: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Samples where sequential semantics differ from the closed form.

    Returns (idx, i16, q16, end_carr, end_carr_i): at sample ``idx[k]`` the
    sequential int16 accumulators are ``(i16[k], q16[k])``.  idx is empty
    for almost every block.  With ``want_end`` the last two outputs are
    the sequential block-end carrier phases (inactive slots pass
    through); without it (the production default) the walk past the last
    candidate — the ENTIRE block when there are no candidates — is
    skipped, because the planner's carrier chain already owns
    block-boundary state, and end_carr/end_carr_i just pass the inputs
    through.

    ``_ref=True`` runs the sample-major float-replay reference screen
    instead of the binade-segment fast path — a test hook for the
    cross-check in tests/test_synth_seq.py.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("native sequential engine unavailable")
    C = plan.num_channels
    cv = ctypes.c_void_p

    def p(a, dt):
        return np.ascontiguousarray(a, dtype=dt)

    active = p(plan.active, np.uint8)
    args = [
        p(plan.code_phase, np.float64), p(plan.f_code, np.float64),
        p(plan.carr_phase, np.float64), p(plan.f_carr, np.float64),
        p(plan.carr_phase_i, np.uint32), p(plan.carr_step_i, np.int32),
        p(plan.gain, np.float64), p(plan.iword, np.int64),
        p(plan.ibit, np.int64), p(plan.icode, np.int64),
        p(plan.ca, np.int8), p(plan.dwrd, np.uint32),
    ]
    out_idx = np.empty(max_out, dtype=np.int64)
    out_i = np.empty(max_out, dtype=np.int16)
    out_q = np.empty(max_out, dtype=np.int16)
    end_carr = np.empty(C, dtype=np.float64)
    end_carr_i = np.empty(C, dtype=np.uint32)
    fn = lib.gseq_diff_block_ref if _ref else lib.gseq_diff_block
    n = fn(
        C, int(plan.num_samples), float(plan.delt), int(int_nco),
        active.ctypes.data_as(cv),
        *[a.ctypes.data_as(cv) for a in args],
        _SIN_F64.ctypes.data_as(cv), _COS_F64.ctypes.data_as(cv),
        max_out,
        out_idx.ctypes.data_as(cv), out_i.ctypes.data_as(cv),
        out_q.ctypes.data_as(cv),
        end_carr.ctypes.data_as(cv), end_carr_i.ctypes.data_as(cv),
        int(want_end),
    )
    if n == -1:
        raise ValueError(
            "invalid block plan for sequential replay (data-word index out "
            "of range or too many channels)"
        )
    if n == -2:
        raise ValueError(f"more than {max_out} corrections in one block")
    return out_idx[:n], out_i[:n], out_q[:n], end_carr, end_carr_i


def seq_corrections_window(
    plans: list[BlockPlan], int_nco: bool = False, max_out: int = 512,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Corrections for a whole dispatch window in ONE native call.

    Identical results to calling :func:`seq_corrections` per plan (the
    native side runs the same gseq_diff_block per stacked block — fanned
    over threads on multi-core hosts), but the per-block Python/ctypes
    marshalling collapses to one vectorized stack per field, removing
    the strict-parity pipeline's per-block constant cost (VERDICT r3
    item 3).  Returns [(idx, i16, q16), ...] aligned with ``plans``.

    A block overflowing ``max_out`` corrections (never observed — the
    screen yields ~0/block) falls back to the per-plan path, which
    raises its descriptive error.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("native sequential engine unavailable")
    if not plans:
        return []
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
    if not hasattr(lib, "gseq_diff_window"):  # stale .so on disk
        return [
            seq_corrections(p, int_nco=int_nco)[:3] for p in plans
        ]
    B = len(plans)
    C = plans[0].num_channels
    cv = ctypes.c_void_p

    def stack(name, dt):
        return np.ascontiguousarray(
            np.stack([getattr(p, name) for p in plans]), dtype=dt
        )

    active = stack("active", np.uint8)
    args = [
        stack("code_phase", np.float64), stack("f_code", np.float64),
        stack("carr_phase", np.float64), stack("f_carr", np.float64),
        stack("carr_phase_i", np.uint32), stack("carr_step_i", np.int32),
        stack("gain", np.float64), stack("iword", np.int64),
        stack("ibit", np.int64), stack("icode", np.int64),
        stack("ca", np.int8), stack("dwrd", np.uint32),
    ]
    out_idx = np.empty(B * max_out, dtype=np.int64)
    out_i = np.empty(B * max_out, dtype=np.int16)
    out_q = np.empty(B * max_out, dtype=np.int16)
    out_n = np.empty(B, dtype=np.int64)
    rc = lib.gseq_diff_window(
        B, C, int(plans[0].num_samples), float(plans[0].delt),
        int(int_nco), active.ctypes.data_as(cv),
        *[a.ctypes.data_as(cv) for a in args],
        _SIN_F64.ctypes.data_as(cv), _COS_F64.ctypes.data_as(cv),
        max_out,
        out_idx.ctypes.data_as(cv), out_i.ctypes.data_as(cv),
        out_q.ctypes.data_as(cv), out_n.ctypes.data_as(cv),
    )
    if rc == -2:
        # per-plan path sizes its buffer larger and reports precisely
        return [seq_corrections(p, int_nco=int_nco)[:3] for p in plans]
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
    return out


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
    idx, i16, q16, _, _ = seq_corrections(plan, int_nco=int_nco)
    return apply_corrections(iq16, 16, idx, i16, q16)


def synth_block_seq_native(
    plan: BlockPlan, int_nco: bool = False, bits: int = 16
) -> np.ndarray:
    """Full native sequential synth (gseq_synth_block): the reference hot
    loop replayed in C++ — same output as :func:`synth_block_seq` but
    ~10x faster than the NumPy path, making hour-scale endurance goldens
    tractable on the host.  int16[2N] (bits=16) or int8[2N] (bits=8).
    """
    lib = _lib()
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
