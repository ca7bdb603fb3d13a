"""K1's structure (gpssim_tpu_torch/csrc/synth_k1.cu), emulated in numpy,
against the JAX package's fused Pallas kernel and K1's plain version.

The CUDA kernel cannot run on the CPU; its structure can. The emulation
below follows the kernel step for step:

* the persistent grid: ``min(B*rows, resident)`` CTAs, each owning one
  contiguous range of equal length of the B*rows rows, cut into one
  segment per block it touches;
* per segment, the CTA's staging: the block's gain-folded carrier tables
  and lane steps (build_gain_tables) and its stage-A inputs, flat as the
  kernel holds them in shared memory;
* per warp w of the 16, the rows w, w + 16, ... of the segment two at a
  time: lane 16h + c computes stage A for channel c of row r + 16h (the
  digit polynomial in base-2^23 limbs, the wrap by 1023, the data-bit
  window and the wrap mask) into the warp's channel-major double slot;
* the stage-B loop over each row of that slot (tests/test_torch_stage_b.py
  emulates the loop), and the stores: the raw int16 planes of every row,
  or the interleaved int16 / int8 (``>> 4``) samples with the trailing
  partial row masked.

numpy's uint32 arrays wrap as the card's registers do. Every comparison
is ``np.array_equal``, with no tolerance; the JAX package's Pallas kernel
runs in interpret mode.
"""

import numpy as np
import pytest
import torch

from gpssim_tpu.ops import synth_pallas as jpallas
from gpssim_tpu_torch.ops import synth_torch
from gpssim_tpu_torch.ops.args import to_device

from test_torch_stage_b import _random_args, gain_tables, stage_b_loop

_U = np.uint32
WARPS = 16  # warps of a 512-thread CTA
MAX_C = 16
CA_WORDS = 36
M23 = _U((1 << 23) - 1)
RESIDENT = 264  # two 512-thread CTAs on each of an H100's 132 SMs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grid(total, resident):
    """The persistent grid of K1 and K2 (csrc/persistent_grid.cuh,
    ``partition``): (CTAs, rows per CTA)."""
    ctas = min(total, resident)
    per = -(-total // ctas)
    return -(-total // per), per


def segments(cta, per, total, n_rows):
    """A CTA's row range cut at block boundaries: [(b, seg, seg_end)]."""
    seg, last = cta * per, min(cta * per + per, total)
    out = []
    while seg < last:
        b = seg // n_rows
        end = min(last, (b + 1) * n_rows)
        out.append((b, seg, end))
        seg = end
    return out


def pass_rows(seg, seg_end):
    """The first row r of every warp pass over a segment: warp w takes
    r = seg + w, seg + w + 32, ..., and with it row r + 16."""
    r = np.arange(seg, seg_end)
    return r[(r - seg) % (2 * WARPS) < WARPS]


def staged(args, b):
    """What a CTA stages for block b: the folded tables and lane steps
    (build_gain_tables), and the stage-A inputs, flat as the kernel holds
    them: code[(d*C + c)*3 + l], nav[k*C + c], ca[c*36 + word]."""
    def flat(k):
        return np.ascontiguousarray(args[k][b]).view(_U).ravel()

    return dict(
        tab=gain_tables(args["gain_a"][b], args["gain_b"][b]).view(_U),
        ls=np.ascontiguousarray(args["lane_steps"][b]).view(_U),
        code=flat("code_l"), carr=flat("carr_l"), nav=flat("nav"),
        ca=flat("ca_packed"),
    )


def shl_safe(x, k):
    """uint32 x << k, 0 where k >= 32 (k int64, >= 0)."""
    return np.where(k >= 32, _U(0), x << np.minimum(k, 31).astype(_U))


def stage_a(s, C, q, c, wide):
    """K1's stage A, one lane each: rows q (uint32, the row's index in its
    block) and channels c (int) → bases uint32 (M, 8): f_hi, f_lo, c_hi,
    c_lo, then the sign-folded window words."""
    dig = [np.ones_like(q), q & _U(63), (q >> _U(6)) & _U(63), q >> _U(12)]

    def limbs(L):
        p = []
        for l in range(3):
            t = np.zeros_like(q)
            for d in range(4):
                t = t + dig[d] * L[(d * C + c) * 3 + l]
            p.append(t)
        p[1] = p[1] + (p[0] >> _U(23))
        p[0] = p[0] & M23
        p[2] = p[2] + (p[1] >> _U(23))
        p[1] = p[1] & M23
        return p

    cp, kp = limbs(s["code"]), limbs(s["carr"])
    wraps = cp[2] // _U(1023)
    chip_base = cp[2] - wraps * _U(1023)
    c_hi = ((kp[2] & _U(127)) << _U(23)) + kp[1]

    nav = s["nav"]
    tcu, bidx0, bits = nav[c] + wraps, nav[C + c], nav[2 * C + c]

    def neg(t):
        return ((bits >> ((t // _U(20) - bidx0) & _U(31))) & _U(1)) ^ _U(1)

    neg_now, neg_next = neg(tcu), neg(tcu + _U(1))
    wordpos = (chip_base >> _U(5)).astype(np.int64)
    bitoff = (chip_base & _U(31)).astype(np.int64)
    wrap_off = 1023 - chip_base.astype(np.int64)
    xor_now = _U(0) - neg_now
    xor_flip = _U(0) - (neg_now ^ neg_next)
    base = np.zeros(q.shape + (8,), _U)
    base[:, 0], base[:, 1], base[:, 2], base[:, 3] = cp[1], cp[0], c_hi, kp[0]
    ones = np.full_like(q, 0xFFFFFFFF)
    for k in range(4 if wide else 2):
        w0 = s["ca"][c * CA_WORDS + wordpos + k]
        w1 = s["ca"][c * CA_WORDS + wordpos + k + 1]
        win = (w0 >> bitoff.astype(_U)) | shl_safe(w1, 32 - bitoff)
        wo = wrap_off - 32 * k
        mask = np.where(wo <= 0, ones, shl_safe(ones, wo))
        base[:, 4 + k] = win ^ xor_now ^ (mask & xor_flip)
    return base


def k1_emulated(args, rows, resident, wide):
    """K1 over ``rows`` rows of each block → raw rows (i, q), int16
    (B, rows, 128), and the number of table folds."""
    B, C = args["gain_a"].shape
    total = B * rows
    n_cta, per = grid(total, resident)
    out = np.zeros((2, B, rows, 128), np.int16)
    written = np.zeros((B, rows), int)
    lane = np.arange(32)
    half, chan = lane >> 4, lane & 15
    folds = 0
    for cta in range(n_cta):
        for b, seg, seg_end in segments(cta, per, total, rows):
            s = staged(args, b)  # once per (CTA, block), then a barrier
            folds += 1
            r = pass_rows(seg, seg_end)
            # stage A: lane 16h + c → channel c of row r + 16h
            rh = r[:, None] + half * WARPS
            p, l = np.nonzero((chan < C) & (rh < seg_end))
            slot = np.zeros((len(r), 2, MAX_C, 8), _U)
            slot[p, half[l], chan[l]] = stage_a(
                s, C, (rh[p, l] - b * rows).astype(_U), chan[l], wide)
            # stage B: the two rows of each pass in turn
            for h in range(2):
                keep = r + h * WARPS < seg_end
                q = r[keep] + h * WARPS - b * rows
                i, qq = stage_b_loop(slot[keep, h, :C][None], s["ls"][None],
                                     s["tab"][None], wide)
                out[0, b, q], out[1, b, q] = i[0], qq[0]
                written[b, q] += 1
    assert (written == 1).all()  # every row exactly once
    return out[0], out[1], folds


def finalized(i_rows, q_rows, num_samples, out_bits):
    """K1's stores in finalized mode: interleaved int16, or int8 from
    ``i16 >> 4``; samples past num_samples (the trailing partial row) are
    not written."""
    B = i_rows.shape[0]
    iq = np.stack([i_rows.reshape(B, -1)[:, :num_samples],
                   q_rows.reshape(B, -1)[:, :num_samples]], -1)
    iq = iq.reshape(B, 2 * num_samples)
    return (iq >> 4).astype(np.int8) if out_bits == 8 else iq


@pytest.mark.parametrize("B,rows,resident", [
    (25, 2344, RESIDENT),  # the main window, finalized (3 Msps)
    (25, 2368, RESIDENT),  # the same, raw: all R_pad rows
    (7, 2344, RESIDENT),   # B*rows does not divide by the CTA count
    (1, 3, RESIDENT),      # fewer rows than CTAs
    (3, 100, 7),           # ranges crossing block boundaries
], ids=["main", "main-raw", "7-blocks", "few-rows", "crossing"])
def test_k1_grid_partition(B, rows, resident):
    """Every row in exactly one (CTA, block segment, warp pass); equal
    contiguous ranges; one table fold per (CTA, block); warps of a
    segment within one row of each other."""
    total = B * rows
    n_cta, per = grid(total, resident)
    assert n_cta <= min(total, resident)
    seen = np.zeros(total, int)
    folds = 0
    for cta in range(n_cta):
        segs = segments(cta, per, total, rows)
        span = sum(e - s for _, s, e in segs)
        assert span == (per if cta < n_cta - 1 else total - cta * per) >= 1
        folds += len(segs)
        for b, seg, seg_end in segs:
            assert b * rows <= seg < seg_end <= (b + 1) * rows
            r = pass_rows(seg, seg_end)
            warp = (r - seg) % WARPS
            counts = np.zeros(WARPS, int)
            for h in range(2):
                row = r + h * WARPS
                row, w = row[row < seg_end], warp[row < seg_end]
                seen[row] += 1
                np.add.at(counts, w, 1)
            assert counts.max() - counts.min() <= 1
    assert (seen == 1).all()
    assert folds <= n_cta + B - 1  # a block boundary splits one range
    if total <= resident:
        assert n_cta == total and per == 1
    if (B, rows) == (25, 2344):
        assert total % resident and folds <= 290  # was 3,675 with 16-row CTAs
    if resident == 7:
        assert folds > n_cta  # some range crosses a block boundary


_NSPC = 12_750  # 100 rows, the last one partial; R_pad 128
_WINDOWS = {"3-blocks": (3, _NSPC, 7), "few-rows": (1, 300, RESIDENT)}
_CACHE: dict = {}


def _args(wide, C):
    """Three random blocks (the wrapping and edge gains of
    test_torch_stage_b) and the JAX package's fused raw rows for them."""
    key = (wide, C)
    if key not in _CACHE:
        delt = 1 / 1.2e6 if wide else 1 / 3.0e6
        blocks = [_random_args(s + C, C, _NSPC, delt) for s in (5, 6, 7)]
        args = {k: np.concatenate([a[k] for a in blocks]) for k in blocks[0]}
        want = jpallas.synth_batch_pallas_raw(
            *(args[k] for k in ("code_l", "carr_l", "nav", "lane_steps",
                                "ca_packed", "gain_a", "gain_b")),
            n_rows=-(-_NSPC // 128), interpret=True, wide=wide, fuse_a=True)
        _CACHE[key] = args, tuple(np.asarray(w) for w in want)
    return _CACHE[key]


def _window(wide, C, window):
    args, want = _args(wide, C)
    B, ns, resident = _WINDOWS[window]
    return {k: v[:B] for k, v in args.items()}, want, ns, resident


_SHAPES = pytest.mark.parametrize("wide,C", [
    (False, 12), (False, 16), (True, 12), (True, 16),
], ids=["narrow-12", "narrow-16", "wide-12", "wide-16"])


@pytest.mark.parametrize("window", list(_WINDOWS))
@_SHAPES
def test_emulated_k1_raw_rows_equal_jax_and_plain(wide, C, window):
    """Raw mode: all R_pad rows, the padded ones too, equal to the JAX
    package's fused Pallas kernel and to K1's plain version."""
    args, want, ns, resident = _window(wide, C, window)
    B = args["gain_a"].shape[0]
    n_rows = -(-ns // 128)
    R_pad = synth_torch.padded_rows(n_rows)
    i_rows, q_rows, folds = k1_emulated(args, R_pad, resident, wide)
    plain = synth_torch.synth_batch_torch_raw(
        to_device(args, "cpu"), n_rows=n_rows, wide=wide, fuse_a=True)
    for got, p, w in zip((i_rows, q_rows), plain, want):
        assert got.shape == (B, R_pad, 128) and got.dtype == np.int16
        assert np.array_equal(got, p.numpy())
        # rows depend only on their index: the few-row window's R_pad rows
        # are the first rows of the JAX run's first block
        assert np.array_equal(got, w[:B, :R_pad])
    assert got.any()
    assert folds == (R_pad if window == "few-rows" else 9)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("window", list(_WINDOWS))
@_SHAPES
def test_emulated_k1_finalized_equal_plain(wide, C, window, bits):
    """Finalized mode: only the rows that hold samples, the trailing
    partial row masked, interleaved int16 or int8 — the bytes of
    synth_blocks_batch_torch."""
    args, _, ns, resident = _window(wide, C, window)
    rows = -(-ns // 128)
    i_rows, q_rows, _ = k1_emulated(args, rows, resident, wide)
    got = finalized(i_rows, q_rows, ns, bits)
    want = synth_torch.synth_blocks_batch_torch(
        to_device(args, "cpu"), n_rows=rows, num_samples=ns, out_bits=bits,
        wide=wide).numpy()
    assert got.dtype == want.dtype == (np.int8 if bits == 8 else np.int16)
    assert got.shape == want.shape == (args["gain_a"].shape[0], 2 * ns)
    assert np.array_equal(got, want)
