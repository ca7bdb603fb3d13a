// The port's sequential-parity engine: the strict-parity corrections that
// turn the fused kernel's closed-form blocks into the reference C's bytes,
// and the block-boundary carrier chain of the planner.
//
// The reference C advances each channel's code and carrier phase by
// repeated float64 accumulation inside its sample loop (gps.c:2789
// `code_phase += f_code*delt`, gps.c:2820 carrier), while the kernels use
// a closed form of the block-start state so blocks parallelize.  The two
// differ by a random walk of rounding error, and a sample whose phase
// lands inside that band around a chip or carrier-table boundary can
// quantize differently.  This engine replays the sequential recurrences
// exactly (the same IEEE-754 operations, no FMA contraction: io/native.py
// builds it with -ffp-contract=off) where a rigorous screen says they can
// differ, and emits the sequential accumulators there.
//
// It starts from the shared host runtime's engine (native/gpssim_native.cc,
// gseq_*), with one change: the closed form a candidate is compared with.
// That engine compares with the float64 closed form of the NumPy backend
// (raw = fl(cp0 + fl(n*dc)) and so on).  The fused kernel K1 computes the
// closed form in fixed point instead (ops/args.args_from_arrays): the code
// phase in Q46 chips and the carrier phase in Q53 cycles, each rounded to
// nearest-even from the float64 plan and stepped as exact integers.  Where
// K1's fixed point lands on the other side of a boundary than both float64
// semantics, the float64 comparison sees no difference and the block came
// out wrong (about one block in a thousand at 3 Msps).  Here a candidate
// is compared with the closed form the caller's bytes hold: K1's fixed
// point (`fixed` != 0) or the NumPy float64 form (`fixed` == 0).
//
// Why the screen's margins still hold against K1 (margin(n) below is
// slope*n + constant, in the dimension's own units; the screen flags every
// n whose EXACT closed-form progression x(n) = pos + n*step lies within
// margin(n) of a boundary, and a sample can only quantize differently in
// two semantics if a boundary lies between them, so within the larger of
// their two errors from x(n)):
//   code, chips: the sequential error is at most n half-ulps of a value
//     below 1024 (n * 2^-44 = n * 5.684e-14); K1's is the rounding of
//     cp0 and of the step to 2^-46, at most (n + 1) * 2^-47
//     (= (n + 1) * 7.1e-15, about 2.1e-9 at n = 300,000).  The margin is
//     10 * (5.684e-14 * n + 1e-11): at every n at least 80 times K1's
//     error and 10 times the sequential one.
//   carrier (float mode), table-index units (x512): the sequential error
//     is at most n * 512 * 2^-53 (half an ulp below 1, or of the sum in
//     [1, 2) at a wrap); K1's start phase is exact (c0 < 1 is a multiple
//     of 2^-53) and its step rounds by at most 2^-54 cycle, so
//     n * 512 * 2^-54 = n * 2.84e-14 (about 8.5e-9 at n = 300,000).  The
//     margin is 10 * (512 * 5.552e-17 * n + 1e-10): 10 times K1's error
//     and 5 times the sequential one.
//   carrier (integer NCO): K1 embeds the 2^25-per-cycle NCO in Q53 (<< 28)
//     and steps it exactly, so its table index is (phi >> 16) & 511 as in
//     the reference: nothing to screen.
// tests/test_torch_strict_engine.py checks these bounds against the
// sample-major screen and a full evaluation of every sample.
//
// Built by io/native.py with g++ at first use, into build/native/ under a
// name that hashes this file and the flags.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kCaLen = 1023.0;
// Screening margins (chips / LUT-index units).  The sample-major reference
// screen (diff_block_ref) keeps a flat 1e-4, about 1000 times the
// worst case; the fast screen uses 10 times the rigorous bound below,
// linear in the sample index: slope * n + constant (the header above
// gives the bound for both closed forms).  The whole-block screens query
// with the value at n = N (the conservative envelope); the per-candidate
// refinement re-tests a flagged sample n against the value at THAT n, so
// a candidate outside margin(n) is proven identical in both semantics and
// not walked to.  Correctness never rests on the flag: every flagged
// sample is evaluated in both semantics.
constexpr double kCodeMargin = 1e-4;
constexpr double kCarrMargin = 1e-4;

// 10x: N half-ulp roundings of the running code phase (< 1024, half-ulp
// 2^-44 = 5.684e-14) plus the float64 closed form's fl(n*dc)
// (<= ulp(1.2e5)/2 = 7.3e-12) and final-add (<= 2^-44) roundings.
static inline double code_margin_slope() { return 10.0 * 5.684e-14; }
static inline double code_margin_const() { return 10.0 * 1.0e-11; }

// LUT-index units: 512 x (N half-ulp roundings of the phase in [0,1),
// half-ulp 2^-54 = 5.552e-17) plus 512 x the float64 closed form's
// fl(n*dp) / final-add roundings (<= 1e-10 in all for any block).
static inline double carr_margin_slope() { return 10.0 * 512.0 * 5.552e-17; }
static inline double carr_margin_const() { return 10.0 * 1.0e-10; }

constexpr uint64_t kMask53 = (uint64_t(1) << 53) - 1;

struct SeqChan {
  double cp;        // sequential code phase, chips in [0, 1023)
  double dc;        // f_code * delt (single rounding, like gps.c:2789)
  double ph;        // sequential carrier phase, cycles in [0, 1)
  double dp;        // f_carr * delt
  uint32_t phi;     // 9.16 integer-NCO phase (int_nco mode; exact, no drift)
  uint32_t dphi;    // NCO step
  double cp0, c0;   // closed-form block-start values
  // K1's fixed point (ops/args.args_from_arrays): Q46 code phase and step,
  // Q53 carrier phase (mod 2^53) and step, rounded to nearest-even.
  int64_t cq0, cs;
  uint64_t kq0, ks;
  double gain;
  long icode, ibit, iword;       // sequential data-bit cascade
  long iword0, ibit0, icode0;    // block-start counters for the closed form
  int data_bit;                  // sequential ±1 data bit
  const int8_t* ca;              // 1023 chips {0,1}
  const uint32_t* dwrd;          // 60 nav words
};

// The active channels of one block plan, densely packed: chs[0..A) with
// slot_of[k] the plan slot of chs[k].  Inactive slots pass their carrier
// phase through to end_carr/end_carr_i.  Returns A, or -1 on an invalid
// plan (C > 16, a word index out of range).
long init_chans(long C, double delt, const uint8_t* active,
                const double* code_phase, const double* f_code,
                const double* carr_phase, const double* f_carr,
                const uint32_t* carr_phase_i, const int32_t* carr_step_i,
                const double* gain, const int64_t* iword,
                const int64_t* ibit, const int64_t* icode, const int8_t* ca,
                const uint32_t* dwrd, SeqChan* chs, long* slot_of,
                double* end_carr, uint32_t* end_carr_i) {
  if (C > 16) return -1;
  long A = 0;
  for (long c = 0; c < C; ++c) {
    end_carr[c] = carr_phase[c];
    end_carr_i[c] = carr_phase_i[c];
    if (!active[c]) continue;
    SeqChan& ch = chs[A];
    ch.cp = ch.cp0 = code_phase[c];
    ch.dc = f_code[c] * delt;
    ch.ph = ch.c0 = carr_phase[c];
    ch.dp = f_carr[c] * delt;
    ch.phi = carr_phase_i[c];
    ch.dphi = static_cast<uint32_t>(carr_step_i[c]);
    // np.rint and nearbyint both round half to even; the scalings by
    // powers of two are exact.
    ch.cq0 = static_cast<int64_t>(std::nearbyint(ch.cp0 * 0x1p46));
    ch.cs = static_cast<int64_t>(std::nearbyint(ch.dc * 0x1p46));
    ch.kq0 = static_cast<uint64_t>(static_cast<int64_t>(
                 std::nearbyint(ch.c0 * 0x1p53))) & kMask53;
    ch.ks = static_cast<uint64_t>(
        static_cast<int64_t>(std::nearbyint(ch.dp * 0x1p53)));
    ch.gain = gain[c];
    ch.iword = ch.iword0 = iword[c];
    ch.ibit = ch.ibit0 = ibit[c];
    ch.icode = ch.icode0 = icode[c];
    if (ch.iword < 0 || ch.iword >= 60) return -1;
    ch.data_bit =
        static_cast<int>((dwrd[c * 60 + ch.iword] >> (29 - ch.ibit)) & 1u) *
            2 - 1;
    ch.ca = ca + c * 1023;
    ch.dwrd = dwrd + c * 60;
    slot_of[A] = c;
    ++A;
  }
  return A;
}

// The reference hot loop's per-sample update (gps.c:2789-2829), minus the
// mixing: advance code phase with the wrap cascade, then carrier phase.
// Returns false on data-word overflow (invalid plan; Python raises).
inline bool seq_advance(SeqChan& ch, bool int_nco) {
  ch.cp += ch.dc;
  if (ch.cp >= kCaLen) {
    ch.cp -= kCaLen;
    if (++ch.icode >= 20) {  // 20 C/A codes = 1 data bit
      ch.icode = 0;
      if (++ch.ibit >= 30) {  // 30 bits = 1 word
        ch.ibit = 0;
        if (++ch.iword >= 60) return false;
      }
      ch.data_bit =
          static_cast<int>((ch.dwrd[ch.iword] >> (29 - ch.ibit)) & 1u) * 2 - 1;
    }
  }
  if (int_nco) {
    ch.phi += ch.dphi;
  } else {
    ch.ph += ch.dp;
    if (ch.ph >= 1.0)
      ch.ph -= 1.0;
    else if (ch.ph < 0.0)
      ch.ph += 1.0;
  }
  return true;
}

// Closed-form per-sample indices at sample n, in the semantics of the
// caller's bytes.  fixed: K1's fixed point, chips = (cq0 + n*cs) >> 46 with
// wraps = chips / 1023, and itable = the top 9 of the 53 bits of
// (kq0 + n*ks) mod 2^53.  Otherwise the exact numpy elementwise op order
// (ops/synth_numpy.py): raw = fl(cp0 + fl(n*dc)), wraps = floor(raw/1023),
// chip = clip(trunc(raw - wraps*1023)), and itable =
// clip(floor(frac(fl(c0 + fl(n*dp)))*512)).  Both take the data bit at
// (counters + wraps)/20.
inline bool cf_indices(const SeqChan& ch, long n, bool int_nco, bool fixed,
                       uint32_t phi_n, long* chip, long* itable,
                       int* data_bit) {
  long wraps;
  if (fixed) {
    const __int128 q = static_cast<__int128>(ch.cq0) +
                       static_cast<__int128>(n) * ch.cs;
    const long chips = static_cast<long>(q >> 46);  // q >= 0: cp0, cs >= 0
    wraps = chips / 1023;
    *chip = chips - wraps * 1023;
  } else {
    double raw = ch.cp0 + static_cast<double>(n) * ch.dc;
    double wrapsf = std::floor(raw / kCaLen);
    long c = static_cast<long>(raw - wrapsf * kCaLen);
    if (c < 0) c = 0;
    if (c > 1022) c = 1022;
    *chip = c;
    wraps = static_cast<long>(wrapsf);
  }
  long total = ch.iword0 * 600 + ch.ibit0 * 20 + ch.icode0 + wraps;
  long bitpos = total / 20;
  long iw = bitpos / 30;
  long ib = bitpos - iw * 30;
  if (iw < 0 || iw >= 60) return false;
  *data_bit = static_cast<int>((ch.dwrd[iw] >> (29 - ib)) & 1u) * 2 - 1;
  if (int_nco) {
    // Integer NCO is exact: closed form == sequential by construction.
    *itable = static_cast<long>((phi_n >> 16) & 511u);
  } else if (fixed) {
    const uint64_t p =
        (ch.kq0 + static_cast<uint64_t>(n) * ch.ks) & kMask53;
    *itable = static_cast<long>(p >> 44);
  } else {
    double carr = ch.c0 + static_cast<double>(n) * ch.dp;
    double frac = carr - std::floor(carr);
    long it = static_cast<long>(std::floor(frac * 512.0));
    if (it < 0) it = 0;
    if (it > 511) it = 511;
    *itable = it;
  }
  return true;
}

// Mixing contribution of one channel at one sample: the reference computes
// dataBit*codeCA*LUT (exact small-int product) * gain, truncated to int
// (gps.c:2781-2782).
inline void mix_contrib(const SeqChan& ch, long chip, long itable,
                        int data_bit, const double* sin_lut,
                        const double* cos_lut, int* ip, int* qp) {
  double s = static_cast<double>(data_bit * (ch.ca[chip] * 2 - 1));
  *ip = static_cast<int>(s * cos_lut[itable] * ch.gain);
  *qp = static_cast<int>(s * sin_lut[itable] * ch.gain);
}

}  // namespace

// Block-boundary carrier-phase chaining with the reference's sequential
// float64 semantics (gps.c:2820-2826): carr_advance_n below, driven by
// gseq_carr_chain.
namespace {

// One reference step: p = fl(p + dp), then the single-subtract wrap
// (gps.c:2820-2826).
static inline double carr_step1(double p, double dp) {
  p = p + dp;
  p = (p >= 1.0) ? p - 1.0 : p;
  p = (p < 0.0) ? p + 1.0 : p;
  return p;
}

// Advance n sequential carrier steps, bit-exactly, in O(binade segments)
// instead of O(n): while consecutive results stay inside one binade, the
// IEEE round-to-nearest of (p + dp) is p's mantissa plus a CONSTANT
// integer step S = rint(dp/ulp) — an exact arithmetic progression — so
// whole segments fast-forward with integer math and only the
// binade/wrap-crossing steps run the scalar recurrence.  Falls back to
// scalar stepping for every irregular case (ties, subnormals, huge
// ratios), so exactness never depends on the fast path's coverage.
static double carr_advance_n(double p, double dp, long n) {
  if (dp == 0.0) {
    // fl(p + 0.0) == p for every p except -0.0 (then +0.0, stable after
    // one step).
    return (n > 0 && p == 0.0) ? 0.0 : p;
  }
  uint64_t dbits;
  std::memcpy(&dbits, &dp, 8);
  const int dsign = static_cast<int>(dbits >> 63);
  const int dexp = static_cast<int>((dbits >> 52) & 0x7FF);
  if (dexp == 0 || dexp == 0x7FF) {
    // Subnormal / inf / nan step: stay scalar.
    for (; n > 0; --n) p = carr_step1(p, dp);
    return p;
  }
  const int64_t dmant =
      static_cast<int64_t>((dbits & 0xFFFFFFFFFFFFFull) | (1ull << 52));
  const int64_t TOP = (int64_t(1) << 53) - 1;
  const int64_t BOT = int64_t(1) << 52;

  while (n > 0) {
    uint64_t pbits;
    std::memcpy(&pbits, &p, 8);
    const int pexp = static_cast<int>((pbits >> 52) & 0x7FF);
    if (!(p > 0.0) || p >= 1.0 || pexp == 0) {
      // p <= 0, out of range, or subnormal: scalar.
      p = carr_step1(p, dp);
      --n;
      continue;
    }
    // p = pmant * 2^(pexp-1075), pmant in [2^52, 2^53);
    // S = round-nearest-even(dp / ulp) with ulp = 2^(pexp-1075):
    //   S = rne(dmant * 2^(dexp-pexp)).
    const int k = dexp - pexp;
    int64_t S;
    if (k > 0) {
      // |dp| spans the whole binade in one add: scalar handles the jump.
      p = carr_step1(p, dp);
      --n;
      continue;
    } else if (k == 0) {
      S = dmant;  // dp is an exact whole number of ulps: no residual
    } else {
      const int sh = -k;
      if (sh >= 54) {
        // |t| < 0.5 ulp and no tie possible: p is a fixed point — EXCEPT
        // exactly at the binade bottom with a negative residual in
        // (0.25, 0.5) ulp, where the sum rounds on the finer grid below
        // (fl(1.0 - 0.4*2^-52) = 1 - 2^-53, not 1.0): scalar handles it.
        if (dsign &&
            static_cast<int64_t>((pbits & 0xFFFFFFFFFFFFFull) |
                                 (1ull << 52)) == BOT &&
            sh == 54 && dmant > (int64_t(1) << 52)) {
          p = carr_step1(p, dp);
          --n;
          continue;
        }
        return p;
      }
      const int64_t low = dmant & ((int64_t(1) << sh) - 1);
      const int64_t half = int64_t(1) << (sh - 1);
      S = dmant >> sh;
      if (low > half) {
        S += 1;
      } else if (low == half) {
        // Rounding tie: the exact sum sits half an ulp between the two
        // candidates, and round-half-to-EVEN makes the progression exact
        // again — from an even mantissa every step lands even with the
        // even step T = S + (S & 1) (for either sign of dp), so the
        // binade jumps like any other instead of going all-scalar (a tie
        // binade otherwise degrades every step in it; measured ~26% of
        // walk iterations on realistic Doppler).  An odd mantissa takes
        // one scalar step, which RNE lands on an even mantissa.
        const int64_t mm = static_cast<int64_t>(
            (pbits & 0xFFFFFFFFFFFFFull) | (1ull << 52));
        if (mm & 1) {
          p = carr_step1(p, dp);
          --n;
          continue;
        }
        S += S & 1;
        if (S == 0) return p;  // dmant exactly half an ulp: fixed point
      }
    }
    if (dsign) S = -S;
    if (S == 0) {
      // Unreachable for normal dmant (>= 2^52 forces |S| >= 1 or a tie
      // for sh <= 53); stay scalar rather than claim a fixed point.
      p = carr_step1(p, dp);
      --n;
      continue;
    }
    // Downward room stops at BOT+1, not BOT: an arrival exactly at the
    // binade bottom with residual < -0.25 ulp rounds into the finer
    // binade below, off the progression (same edge as above).
    int64_t room = (S > 0) ? (TOP - static_cast<int64_t>(
                                        (pbits & 0xFFFFFFFFFFFFFull) |
                                        (1ull << 52))) /
                                 S
                           : (static_cast<int64_t>(
                                  (pbits & 0xFFFFFFFFFFFFFull) |
                                  (1ull << 52)) -
                              BOT - 1) /
                                 (-S);
    if (room <= 0) {
      p = carr_step1(p, dp);  // boundary-crossing step
      --n;
      continue;
    }
    const long take = room < n ? static_cast<long>(room) : n;
    const int64_t pmant =
        static_cast<int64_t>((pbits & 0xFFFFFFFFFFFFFull) | (1ull << 52)) +
        static_cast<int64_t>(take) * S;
    pbits = (pbits & 0xFFF0000000000000ull) |
            (static_cast<uint64_t>(pmant) & 0xFFFFFFFFFFFFFull);
    std::memcpy(&p, &pbits, 8);
    n -= take;
    if (n > 0) {
      p = carr_step1(p, dp);  // the step that exits the binade / wraps
      --n;
    }
  }
  return p;
}

}  // namespace

namespace {

// Shared channel-fan-out policy: GPSSIM_CHAIN_THREADS overrides (0/1 =
// serial; tests use it to exercise the threaded schedule on single-core
// hosts), else thread when the host has >= 4 cores and there are at
// least `min_work` channels worth of real work.  Bit-exactness is
// schedule-independent in every caller: channels touch disjoint state.
static long chan_threads(long n_channels, long min_work) {
  long nthreads = 1;
  if (const char* env = std::getenv("GPSSIM_CHAIN_THREADS")) {
    nthreads = std::atol(env);
  } else {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw >= 4 && n_channels >= min_work)
      nthreads = (long)hw < n_channels ? (long)hw : n_channels;
  }
  return nthreads > n_channels ? n_channels : nthreads;
}

template <typename Fn>
static void fan_channels(long nthreads, long n_channels, Fn fn) {
  if (nthreads <= 1) {
    for (long c = 0; c < n_channels; ++c) fn(c);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(nthreads));
  for (long t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, t] {
      for (long c = t; c < n_channels; c += nthreads) fn(c);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

// ---------------------------------------------------------------------------
// Fast screening path (the production diff_block).
//
// Same output as diff_block_ref, in O(hits) instead of O(samples):
//
// 1. Per channel, the candidate screen runs on the EXACT closed-form
//    progression in 2^-62 fixed point: chip/LUT boundary proximity is
//    "(a0 + n*step) mod 2^62 lands in a width-w window", and the hits of
//    an arithmetic progression in a modular window are found directly by
//    the O(log) Euclidean first-hit solver (first_hit_mod) — one query
//    per hit per block, no per-sample or per-binade work.  The window is
//    widened so the screen stays a conservative SUPERSET of the true
//    difference set: sequential-vs-closed-form divergence (< 2e-8 of a
//    chip/LUT unit per block), the closed form's own double rounding, and
//    the fixed-point quantization (< N+2 counts) are all orders of
//    magnitude inside the 1e-4 margin.
// 2. The sequential f64 state is only materialized where it is needed:
//    between consecutive flagged samples it fast-forwards in O(binade
//    segments) via the exact mantissa-progression lemma (seg_room, same
//    machinery as carr_advance_n), with every irregular step (binade or
//    wrap crossing, rounding tie) taken scalar.
// 3. Every flagged sample is fully evaluated in both semantics, so
//    over-flagging never changes the output, only costs a candidate eval.

namespace {

constexpr long kRoomMax = 1L << 60;

// Binade-segment parameters for v <- fl(v + dv): *S = exact mantissa step
// in ulps; returns the number of steps that provably stay in-binade and
// strictly below vcap (vcap <= 0: no cap).  0 => take one scalar step
// (irregular case); *fixed = the value never changes under this step.
static long seg_room(double v, double dv, double vcap, int64_t* S_out,
                     int64_t* mant_out, uint64_t* bits_out, int* pexp_out,
                     bool* fixed_out) {
  *fixed_out = false;
  *S_out = 0;
  *mant_out = 0;
  *bits_out = 0;
  *pexp_out = 0;
  if (!(v > 0.0)) return 0;
  uint64_t pbits;
  std::memcpy(&pbits, &v, 8);
  const int pexp = static_cast<int>((pbits >> 52) & 0x7FF);
  if (pexp == 0 || pexp == 0x7FF) return 0;  // subnormal / inf / nan
  const int64_t mant =
      static_cast<int64_t>((pbits & 0xFFFFFFFFFFFFFull) | (1ull << 52));
  *mant_out = mant;
  *bits_out = pbits;
  *pexp_out = pexp;
  if (dv == 0.0) {  // fl(v + 0) == v for v > 0: fixed point
    *fixed_out = true;
    return kRoomMax;
  }
  uint64_t dbits;
  std::memcpy(&dbits, &dv, 8);
  const int dsign = static_cast<int>(dbits >> 63);
  const int dexp = static_cast<int>((dbits >> 52) & 0x7FF);
  if (dexp == 0 || dexp == 0x7FF) return 0;  // subnormal/inf/nan step
  const int64_t dmant =
      static_cast<int64_t>((dbits & 0xFFFFFFFFFFFFFull) | (1ull << 52));
  const int k = dexp - pexp;
  int64_t S;
  if (k > 0) return 0;  // |dv| spans the whole binade in one add
  if (k == 0) {
    S = dmant;
  } else {
    const int sh = -k;
    if (sh >= 54) {
      // |step| < 0.5 ulp and no tie possible: fixed point — except
      // exactly at the binade bottom with a negative residual in
      // (0.25, 0.5) ulp, which rounds into the finer binade below
      // (fl(1.0 - 0.4*2^-52) = 1 - 2^-53): defer to the scalar step.
      if (dsign && mant == (int64_t(1) << 52) && sh == 54 &&
          dmant > (int64_t(1) << 52))
        return 0;
      *fixed_out = true;
      return kRoomMax;
    }
    const int64_t low = dmant & ((int64_t(1) << sh) - 1);
    const int64_t half = int64_t(1) << (sh - 1);
    S = dmant >> sh;
    if (low > half) {
      S += 1;
    } else if (low == half) {
      // Rounding tie: round-half-to-even keeps the progression exact
      // from an EVEN mantissa with the even step S + (S & 1) — same
      // lemma as carr_advance_n.  An odd mantissa defers to one scalar
      // step (which RNE lands even); the segment caches in the callers
      // preserve evenness (even step from even start).
      if (mant & 1) return 0;
      S += S & 1;
      if (S == 0) {  // dmant exactly half an ulp: even mantissa is fixed
        *fixed_out = true;
        return kRoomMax;
      }
    }
  }
  if (dsign) S = -S;
  if (S == 0) return 0;  // unreachable for normal dmant: stay scalar
  const int64_t TOP = (int64_t(1) << 53) - 1;
  const int64_t BOT = int64_t(1) << 52;
  long room;
  if (S > 0) {
    int64_t top = TOP;
    if (vcap > 0.0) {
      uint64_t cbits;
      std::memcpy(&cbits, &vcap, 8);
      const int cexp = static_cast<int>((cbits >> 52) & 0x7FF);
      if (cexp == pexp)
        top = static_cast<int64_t>((cbits & 0xFFFFFFFFFFFFFull) |
                                   (1ull << 52)) -
              1;
      else if (cexp < pexp)
        return 0;  // at/above the cap's binade: defer to scalar
    }
    room = static_cast<long>((top - mant) / S);
  } else {
    // Stop at BOT+1, not BOT: an arrival exactly at the binade bottom
    // with residual < -0.25 ulp rounds into the finer binade below, off
    // the progression (same edge as the sh >= 54 guard above).
    room = static_cast<long>((mant - BOT - 1) / (-S));
  }
  *S_out = S;
  return room;
}

static inline double mant_to_double(uint64_t tmpl_bits, int64_t mant) {
  const uint64_t b = (tmpl_bits & 0xFFF0000000000000ull) |
                     (static_cast<uint64_t>(mant) & 0xFFFFFFFFFFFFFull);
  double v;
  std::memcpy(&v, &b, 8);
  return v;
}

// Minimal j in [0, budget) with (a + j*s) mod m < w, or -1 if none
// exists below the budget.  Preconditions: 0 <= a < m, 0 <= s < m,
// 0 <= w <= m, budget >= 0.  Euclidean descent on the modulus
// (m, s) -> (s, (-m) mod s): O(log m) like gcd.  This is what makes the
// segment screen O(hits) instead of O(samples): a hit needs (a + j*s)
// to land in a width-w window mod m, and the first such j is found
// directly instead of scanning.
//
// The budget is threaded DOWN the descent, not just checked at the top:
// j(k2) = ceil(((k2+1)m - a)/s) is increasing in k2, so "j < budget"
// bounds the child problem to k2 + 1 <= ((budget-1)s + a)/m allowed
// values.  Since s <= m/2 after the reflection, the child budget at
// least halves per level — a screen query over N samples descends
// ~log2(N) levels instead of the full ~log(m) Euclid ladder (the screen
// issues 2 such queries per channel-block and hits are ~never below N,
// so the early-out is the common case and was measured as most of the
// strict-parity corrections cost).
static long long first_hit_mod(long long a, long long s, long long m,
                               long long w, long long budget) {
  if (w <= 0 || budget <= 0) return -1;
  if (a < w) return 0;
  if (s == 0) return -1;
  if (s > m - s) {
    // Reflect: t_j = (a + j*s) mod m lands in [0, w) iff the mirrored
    // progression (w-1-a + j*(m-s)) mod m does (same j — the window maps
    // onto itself under x -> w-1-x).  Keeps s <= m/2 so the descent
    // below halves the modulus at least every other level (the raw
    // recursion is LINEAR depth for s near m, e.g. s = m-1).
    long long ar = (w - 1 - a) % m;
    if (ar < 0) ar += m;
    return first_hit_mod(ar, m - s, m, w, budget);
  }
  // Need k >= 1 wraps: k*m <= a + j*s < k*m + w with j = ceil((k*m-a)/s),
  // valid iff the ceil residue r_k = (a - k*m) mod s < w.  Substituting
  // k = 1 + k2 turns "minimal valid k" into the same problem one level
  // down: r_k = ((a - m) mod s + k2 * ((-m) mod s)) mod s.
  // j < budget  <=>  (k2+1)m - a <= (budget-1)s  <=>  k2+1 <= b2 below.
  const long long b2 = static_cast<long long>(
      ((static_cast<__int128>(budget) - 1) * s + a) / m);
  if (b2 <= 0) return -1;
  const long long w2 = w < s ? w : s;
  long long a2 = (a - m) % s;
  if (a2 < 0) a2 += s;
  long long s2 = (-m) % s;
  if (s2 < 0) s2 += s;
  const long long k2 = first_hit_mod(a2, s2, s, w2, b2);
  if (k2 < 0) return -1;
  const __int128 num = (static_cast<__int128>(k2) + 1) * m - a;
  return static_cast<long long>((num + s - 1) / s);
}

// Whole-block candidate screen over the EXACT closed-form progression
// pos + n*step, flagging n where frac(scale*(pos + n*step)) is within
// `margin` (plus quantization slop) of an integer.  2^-62 fixed point:
// hit at n iff ((a + n*s) mod 2^62) < w, with the two-sided proximity
// window rotated to start at 0.
constexpr int64_t kFixM = int64_t(1) << 62;

struct GlobalScreen {
  int64_t a, s, w;
  // n-dependent refinement terms, in 2^-62 counts: a flagged sample n
  // is walked only if its boundary distance is within
  // W(n) = slope*n + cons + n + 2 — make_global's window with N -> n.
  double slope;
  double cons;
};

// frac(x) in 2^-62 fixed point.  x - floor(x) is exact for |x| < 2^53
// (both operands on the grid of ulp(x), result < 1 fits 53 bits); the
// ldexp scale is a power of two; nearbyint adds <= 0.5 counts, absorbed
// by the caller's slop.
static inline int64_t to_fix(double x) {
  const double f = x - std::floor(x);
  int64_t v = static_cast<int64_t>(std::nearbyint(std::ldexp(f, 62)));
  if (v >= kFixM) v -= kFixM;  // f < 1 keeps v < 2^62; pure defense
  if (v < 0) v = 0;
  return v;
}

static GlobalScreen make_global(double pos, double step, double scale,
                                double m_slope, double m_const, long N) {
  // scale is 1.0 or 512.0: scale*pos / scale*step are exact (power-of-2
  // multiply), so the only inexactness is the fixed-point rounding of
  // a0 (<= 0.5 counts) and of s (<= 0.5 counts, linearly accumulated to
  // <= N/2 counts by sample N) — widen the window by N+2 counts.
  const double margin = m_slope * static_cast<double>(N) + m_const;
  const int64_t W =
      static_cast<int64_t>(margin * static_cast<double>(kFixM)) + N + 2;
  const int64_t a0 = to_fix(scale * pos);
  const int64_t s = to_fix(scale * step);
  // Proximity window [0, W] u [M-W, M-1], rotated by +W to [0, 2W].
  int64_t a = a0 + W;
  if (a >= kFixM) a -= kFixM;
  return {a, s, 2 * W + 1, m_slope * static_cast<double>(kFixM),
          m_const * static_cast<double>(kFixM)};
}

// Refined per-candidate test: could sample n actually diverge?  The
// query window used margin(N); the bound at the candidate itself is
// margin(n) (sequential divergence and fixed-point slop both accumulate
// linearly in n), so a candidate outside that tighter window is proven
// identical in both semantics and needs no sequential walk.
static inline bool gs_hit_refined(const GlobalScreen& g, long n) {
  const int64_t t = static_cast<int64_t>(
      (static_cast<__int128>(g.s) * n + g.a) % kFixM);
  const int64_t Wc = (g.w - 1) / 2;  // the query half-width, margin(N)
  const int64_t Wn =
      static_cast<int64_t>(g.slope * static_cast<double>(n) + g.cons) + n + 2;
  int64_t d = t - Wc;
  if (d < 0) d = -d;
  return d <= Wn;
}

// First flagged sample in [n0, N) for this screen, or N if none.
static inline long gs_next(const GlobalScreen& g, long n0, long N) {
  if (n0 >= N) return N;
  const int64_t an = static_cast<int64_t>(
      (static_cast<__int128>(g.s) * n0 + g.a) % kFixM);
  const long long h = first_hit_mod(an, g.s, kFixM, g.w, N - n0);
  if (h < 0 || h >= N - n0) return N;
  return n0 + static_cast<long>(h);
}

// Advance a channel's sequential f64 state by exactly `steps` samples,
// no screening: whole binade segments jump via the exact mantissa
// progression; irregular steps (binade/wrap crossings, ties) go scalar
// through seq_advance, which also runs the data-bit cascade at code
// wraps.  false on data-word overflow (invalid plan).
// This walks the CODE dimension only (code phase + cascade; the scalar
// step's phi side-advance is unused in float mode).  It serves both the
// integer-NCO mode (carrier exact closed-form) and — since the code and
// carrier recurrences are independent (gps.c:2789-2829) — the float
// mode's code-flagged candidates, whose carrier dimension is walked
// separately by carr_advance_n only when its own screen flags.  The
// former joint min-interleave walk (seq_ff_float) is gone with it.
static bool seq_ff_nco(SeqChan& ch, long steps) {
  while (steps > 0) {
    int64_t Sc, mc;
    uint64_t cb;
    int ce;
    bool cfix;
    long L = seg_room(ch.cp, ch.dc, kCaLen, &Sc, &mc, &cb, &ce, &cfix);
    if (L > steps) L = steps;
    if (L <= 0) {
      if (!seq_advance(ch, true)) return false;
      --steps;
      continue;
    }
    if (!cfix) ch.cp = mant_to_double(cb, mc + L * Sc);
    steps -= L;
  }
  return true;
}

struct Delta {
  long n;
  int di, dq;
};

// Evaluate one flagged sample in both semantics (the sequential one and
// the caller's closed form); append the per-channel contribution
// difference (usually none).  false on invalid plan.
//
// code_is_seq / carr_is_seq say which dimensions were actually walked
// sequentially to n: a dimension whose screen did NOT flag n (at its
// refined margin) is PROVEN index-identical in both semantics there, so
// its closed-form index substitutes exactly and the sequential walk of
// that dimension is skipped entirely by the caller.
static bool eval_candidate(const SeqChan& ch, long n, double cp_n,
                           double ph_n, bool int_nco, bool fixed,
                           uint32_t phi0, bool code_is_seq, bool carr_is_seq,
                           const double* sin_lut, const double* cos_lut,
                           std::vector<Delta>* deltas) {
  const uint32_t phi_n =
      phi0 + static_cast<uint32_t>(static_cast<uint64_t>(n) * ch.dphi);
  long chip_c, it_c;
  int db_c;
  if (!cf_indices(ch, n, int_nco, fixed, phi_n, &chip_c, &it_c, &db_c))
    return false;
  const long chip_s = code_is_seq ? static_cast<long>(cp_n) : chip_c;
  const int db_s = code_is_seq ? ch.data_bit : db_c;
  long it_s;
  if (int_nco) {
    it_s = static_cast<long>((phi_n >> 16) & 511u);
  } else if (carr_is_seq) {
    it_s = static_cast<long>(std::floor(ph_n * 512.0));
    if (it_s > 511) it_s = 511;  // ph*512 == 512.0 edge (see synth loop)
  } else {
    it_s = it_c;
  }
  int ip_s, qp_s, ip_c, qp_c;
  mix_contrib(ch, chip_s, it_s, db_s, sin_lut, cos_lut, &ip_s, &qp_s);
  mix_contrib(ch, chip_c, it_c, db_c, sin_lut, cos_lut, &ip_c, &qp_c);
  if (ip_s != ip_c || qp_s != qp_c)
    deltas->push_back({n, ip_s - ip_c, qp_s - qp_c});
  return true;
}

}  // namespace

namespace {

// The plan fields of one block, as the exports take them.
struct PlanPtrs {
  const uint8_t* active;
  const double *code_phase, *f_code, *carr_phase, *f_carr;
  const uint32_t* carr_phase_i;
  const int32_t* carr_step_i;
  const double* gain;
  const int64_t *iword, *ibit, *icode;
  const int8_t* ca;
  const uint32_t* dwrd;

  long init(long C, double delt, SeqChan* chs, long* slot_of,
            double* end_carr, uint32_t* end_carr_i) const {
    return init_chans(C, delt, active, code_phase, f_code, carr_phase,
                      f_carr, carr_phase_i, carr_step_i, gain, iword, ibit,
                      icode, ca, dwrd, chs, slot_of, end_carr, end_carr_i);
  }

  // Block b of a window whose fields are stacked on a leading axis.
  PlanPtrs block(long b, long C) const {
    return {active + b * C,       code_phase + b * C, f_code + b * C,
            carr_phase + b * C,   f_carr + b * C,     carr_phase_i + b * C,
            carr_step_i + b * C,  gain + b * C,       iword + b * C,
            ibit + b * C,         icode + b * C,      ca + b * C * 1023,
            dwrd + b * C * 60};
  }
};

// The sample-major float-domain replay: the cross-check reference for the
// fast screen below (diff_block); tests assert their outputs are
// identical.  It screens every sample of the sequential state with the
// flat 1e-4 margins and evaluates each flagged one in both semantics.
// *n_cand counts the flagged samples.
long diff_block_ref(long C, long N, double delt, bool nco, bool fixed,
                    const PlanPtrs& pl, const double* sin_lut,
                    const double* cos_lut, long max_out, int64_t* out_idx,
                    int16_t* out_i, int16_t* out_q, double* end_carr,
                    uint32_t* end_carr_i, long* n_cand) {
  *n_cand = 0;
  if (N < 0) return -1;
  SeqChan chs[16];
  long slot_of[16];
  const long A = pl.init(C, delt, chs, slot_of, end_carr, end_carr_i);
  if (A < 0) return -1;

  long n_out = 0;
  for (long n = 0; n < N; ++n) {
    // Cheap screen: can any channel's quantized index differ between the
    // sequential and closed-form phase at this sample?
    bool candidate = false;
    for (long k = 0; k < A; ++k) {
      const SeqChan& ch = chs[k];
      double f = ch.cp - static_cast<double>(static_cast<long>(ch.cp));
      candidate |= (f < kCodeMargin) | (f > 1.0 - kCodeMargin);
      if (!nco) {
        double x = ch.ph * 512.0;
        double fx = x - std::floor(x);
        candidate |= (fx < kCarrMargin) | (fx > 1.0 - kCarrMargin);
      }
    }
    if (candidate) {
      ++*n_cand;
      int ia_s = 0, qa_s = 0, ia_c = 0, qa_c = 0;
      for (long k = 0; k < A; ++k) {
        SeqChan& ch = chs[k];
        // Sequential values at this sample (state as of loop entry).
        long chip_s = static_cast<long>(ch.cp);
        long it_s = nco ? static_cast<long>((ch.phi >> 16) & 511u)
                        : static_cast<long>(std::floor(ch.ph * 512.0));
        if (it_s > 511) it_s = 511;  // ph*512 == 512.0 edge
        int ip, qp;
        mix_contrib(ch, chip_s, it_s, ch.data_bit, sin_lut, cos_lut, &ip,
                    &qp);
        ia_s += ip;
        qa_s += qp;
        long chip_c, it_c;
        int db_c;
        if (!cf_indices(ch, n, nco, fixed, ch.phi, &chip_c, &it_c, &db_c))
          return -1;
        mix_contrib(ch, chip_c, it_c, db_c, sin_lut, cos_lut, &ip, &qp);
        ia_c += ip;
        qa_c += qp;
      }
      if (ia_s != ia_c || qa_s != qa_c) {
        if (n_out >= max_out) return -2;
        out_idx[n_out] = n;
        out_i[n_out] = static_cast<int16_t>(ia_s);
        out_q[n_out] = static_cast<int16_t>(qa_s);
        ++n_out;
      }
    }
    for (long k = 0; k < A; ++k) {
      if (!seq_advance(chs[k], nco)) return -1;
    }
  }

  for (long k = 0; k < A; ++k) {
    end_carr[slot_of[k]] = chs[k].ph;
    end_carr_i[slot_of[k]] = chs[k].phi;
  }
  return n_out;
}

// The production screen: the same corrections as diff_block_ref in
// O(hits).  *n_cand counts the candidates evaluated (one per channel and
// flagged sample that survives the refined margin).
long diff_block(long C, long N, double delt, bool nco, bool fixed,
                const PlanPtrs& pl, const double* sin_lut,
                const double* cos_lut, long max_out, int64_t* out_idx,
                int16_t* out_i, int16_t* out_q, double* end_carr,
                uint32_t* end_carr_i, bool want_end, long* n_cand) {
  *n_cand = 0;
  if (N < 0) return -1;
  SeqChan chs[16];
  long slot_of[16];
  const long A = pl.init(C, delt, chs, slot_of, end_carr, end_carr_i);
  if (A < 0) return -1;
  uint32_t phi0s[16];
  for (long k = 0; k < A; ++k) phi0s[k] = chs[k].phi;

  // The channels are walked one after another on the caller's thread.
  // Threads do not pay here: a block has about one candidate, found in
  // microseconds, and a thread spawned per block or per channel costs
  // more than its walk (with threads the corrections ran 3 to 15 times
  // slower on the 8-core hosts measured).
  std::vector<Delta> deltas;
  auto walk_one = [&](long k) -> bool {
    SeqChan& ch = chs[k];
    const uint32_t phi0 = phi0s[k];
    // Candidate samples from the exact closed-form progressions (chip
    // edges; LUT edges unless the integer NCO makes the carrier exact).
    const GlobalScreen gc = make_global(ch.cp0, ch.dc, 1.0,
                                        code_margin_slope(),
                                        code_margin_const(), N);
    GlobalScreen gp{0, 0, 0, 0.0, 0.0};
    if (!nco)
      gp = make_global(ch.c0, ch.dp, 512.0, carr_margin_slope(),
                       carr_margin_const(), N);
    long cur_code = 0;  // code phase + cascade walked to here
    long cur_carr = 0;  // float carrier phase walked to here
    long hc = gs_next(gc, 0, N);
    long hp = nco ? N : gs_next(gp, 0, N);
    while (true) {
      const long nh = hc < hp ? hc : hp;
      if (nh >= N) break;
      // The query window is margin(N)-wide; re-test the candidate
      // against margin(nh) before paying the sequential walk to it — a
      // rejected candidate is PROVEN identical in both semantics.  The
      // verdicts are kept PER DIMENSION: the code and carrier recurrences
      // are independent (gps.c:2789-2829, no cross terms, the data-bit
      // cascade rides the code dimension alone), so only a flagged
      // dimension's sequential state is walked.
      const bool code_hit = hc == nh && gs_hit_refined(gc, nh);
      const bool carr_hit = !nco && hp == nh && gs_hit_refined(gp, nh);
      if (code_hit || carr_hit) {
        // seq_ff_nco walks code + cascade only (eval derives the NCO
        // phase from phi0 + n*dphi).
        if (code_hit) {
          if (!seq_ff_nco(ch, nh - cur_code)) return false;
          cur_code = nh;
        }
        if (carr_hit) {
          ch.ph = carr_advance_n(ch.ph, ch.dp, nh - cur_carr);
          cur_carr = nh;
        }
        ++*n_cand;
        if (!eval_candidate(ch, nh, ch.cp, ch.ph, nco, fixed, phi0,
                            code_hit, carr_hit, sin_lut, cos_lut, &deltas))
          return false;
      }
      if (hc == nh) hc = gs_next(gc, nh + 1, N);
      if (hp == nh) hp = gs_next(gp, nh + 1, N);
    }
    // The block-end walk exists only to report end_carr: the planner's
    // carrier chain already owns block-boundary state, so production
    // callers pass want_end=0 and the walk past the last candidate (the
    // entire block when there are no candidates, the common case) is
    // skipped.  end_carr/end_carr_i then keep their pass-through init.
    if (!want_end) {
      // Validate the data-word range via the closed form instead of the
      // skipped tail walk: the sequential wrap count differs from
      // floor((cp0 + N*dc)/1023) by at most 1, so a certain overflow
      // (one-wrap slack) is still rejected; only a plan whose end sits
      // exactly on the 36000-bitpos boundary can slip this lazy check
      // (want_end=1 and the reference screen still catch it exactly).
      const double raw = ch.cp0 + static_cast<double>(N) * ch.dc;
      const double wr = std::floor(raw / kCaLen);
      const double total =
          static_cast<double>(ch.iword0 * 600 + ch.ibit0 * 20 +
                              ch.icode0) + wr;
      return total - 1.0 < 36000.0;
    }
    // want_end: finish each dimension independently — the code walk for
    // its exact data-word-overflow validation, the carrier walk for the
    // end phase itself.
    if (!seq_ff_nco(ch, N - cur_code)) return false;
    if (!nco) ch.ph = carr_advance_n(ch.ph, ch.dp, N - cur_carr);
    end_carr[slot_of[k]] = ch.ph;
    // The integer NCO only advances in int_nco mode (seq_advance); in
    // float mode the reference leaves it untouched — match exactly.
    end_carr_i[slot_of[k]] =
        nco ? phi0 + static_cast<uint32_t>(static_cast<uint64_t>(N) *
                                           ch.dphi)
            : phi0;
    return true;
  };
  for (long k = 0; k < A; ++k)
    if (!walk_one(k)) return -1;

  if (deltas.empty()) return 0;
  std::sort(deltas.begin(), deltas.end(),
            [](const Delta& a, const Delta& b) { return a.n < b.n; });
  long n_out = 0;
  size_t i = 0;
  while (i < deltas.size()) {
    const long n = deltas[i].n;
    int di = 0, dq = 0;
    for (; i < deltas.size() && deltas[i].n == n; ++i) {
      di += deltas[i].di;
      dq += deltas[i].dq;
    }
    if (di == 0 && dq == 0) continue;
    // Closed-form totals at this sample: the sequential accumulators are
    // then totals + the flagged channels' deltas (unflagged channels
    // contribute identically in both semantics, per the screen bound).
    int ia_c = 0, qa_c = 0;
    for (long k = 0; k < A; ++k) {
      const SeqChan& ch = chs[k];
      const uint32_t phi_n =
          phi0s[k] +
          static_cast<uint32_t>(static_cast<uint64_t>(n) * ch.dphi);
      long chip_c, it_c;
      int db_c, ip, qp;
      if (!cf_indices(ch, n, nco, fixed, phi_n, &chip_c, &it_c, &db_c))
        return -1;
      mix_contrib(ch, chip_c, it_c, db_c, sin_lut, cos_lut, &ip, &qp);
      ia_c += ip;
      qa_c += qp;
    }
    if (n_out >= max_out) return -2;
    out_idx[n_out] = n;
    out_i[n_out] = static_cast<int16_t>(ia_c + di);
    out_q[n_out] = static_cast<int16_t>(qa_c + dq);
    ++n_out;
  }
  return n_out;
}

}  // namespace

extern "C" {

// Block-boundary carrier phases with the reference's sequential float64
// semantics (gps.c:2820-2826), for a window of K consecutive blocks with
// per-block Doppler.  Inactive channels pass f_carr = 0 (the add is then
// exact and the phase carries through unchanged).
//   carr0:  f64[C]   phase at the window start
//   f_carr: f64[K*C] per-block Doppler (row-major, block-major)
//   starts: f64[(K+1)*C] out; row j = phase at the start of block j,
//           row K = final end-of-window phase.
// Returns 0 on success, -1 if C exceeds the slot capacity (the caller
// must not treat the output as populated).
long gseq_carr_chain(long C, long K, long N, double delt,
                     const double* carr0, const double* f_carr,
                     double* starts) {
  if (C > 64) return -1;
  // Each channel's chain is independent (disjoint reads and strided
  // writes), so channels fan out over threads on multi-core hosts: this
  // chain is the planner's hot path.
  auto chain_one = [&](long c) {
    double p = carr0[c];
    for (long j = 0; j < K; ++j) {
      starts[j * C + c] = p;
      p = carr_advance_n(p, f_carr[j * C + c] * delt, N);
    }
    starts[K * C + c] = p;
  };
  fan_channels(chan_threads(C, 4), C, chain_one);
  return 0;
}

// Sparse corrections that turn a closed-form block into the sequential-
// exact stream: for each sample where the sequential semantics and the
// closed form (fixed: K1's fixed point; else the NumPy float64 form)
// give different I/Q accumulators, the sample index and the *sequential*
// int16 accumulator pair (absolute values, so the patch works after
// either the 16-bit store or the 8-bit >>4).  ref != 0 runs the
// sample-major reference screen instead of the fast one.  *n_cand: the
// candidates the screen evaluated.
//
// Returns the number of corrections (>= 0), -1 on data-word overflow
// (invalid plan) or C > 16, -2 if max_out was too small.
long gseq_diff_block(
    long C, long N, double delt, int int_nco, int fixed, int ref,
    const uint8_t* active, const double* code_phase, const double* f_code,
    const double* carr_phase, const double* f_carr,
    const uint32_t* carr_phase_i, const int32_t* carr_step_i,
    const double* gain, const int64_t* iword, const int64_t* ibit,
    const int64_t* icode, const int8_t* ca, const uint32_t* dwrd,
    const double* sin_lut, const double* cos_lut, long max_out,
    int64_t* out_idx, int16_t* out_i, int16_t* out_q, double* end_carr,
    uint32_t* end_carr_i, int want_end, long* n_cand) {
  const PlanPtrs pl{active, code_phase, f_code, carr_phase, f_carr,
                    carr_phase_i, carr_step_i, gain, iword, ibit, icode,
                    ca, dwrd};
  if (ref)
    return diff_block_ref(C, N, delt, int_nco != 0, fixed != 0, pl, sin_lut,
                          cos_lut, max_out, out_idx, out_i, out_q, end_carr,
                          end_carr_i, n_cand);
  return diff_block(C, N, delt, int_nco != 0, fixed != 0, pl, sin_lut,
                    cos_lut, max_out, out_idx, out_i, out_q, end_carr,
                    end_carr_i, want_end != 0, n_cand);
}

// The fast screen over B stacked plans in one call (the fields on a
// leading B axis: ca [B*C*1023], dwrd [B*C*60], everything else [B*C]),
// one block after another: a window costs tens of microseconds a block,
// less than threads would (see diff_block).  Block b writes up to
// max_out corrections at offset b*max_out of out_idx/i/q, their count in
// out_n[b] and its candidates in out_cand[b].  Returns 0, or the first
// failing block's error code (-1 invalid plan, -2 max_out exceeded).
long gseq_diff_window(
    long B, long C, long N, double delt, int int_nco, int fixed,
    const uint8_t* active, const double* code_phase, const double* f_code,
    const double* carr_phase, const double* f_carr,
    const uint32_t* carr_phase_i, const int32_t* carr_step_i,
    const double* gain, const int64_t* iword, const int64_t* ibit,
    const int64_t* icode, const int8_t* ca, const uint32_t* dwrd,
    const double* sin_lut, const double* cos_lut, long max_out,
    int64_t* out_idx, int16_t* out_i, int16_t* out_q, long* out_n,
    long* out_cand) {
  const PlanPtrs pl{active, code_phase, f_code, carr_phase, f_carr,
                    carr_phase_i, carr_step_i, gain, iword, ibit, icode,
                    ca, dwrd};
  for (long b = 0; b < B; ++b) {
    double end_carr[16];
    uint32_t end_carr_i[16];
    const long n = diff_block(
        C, N, delt, int_nco != 0, fixed != 0, pl.block(b, C), sin_lut,
        cos_lut, max_out, out_idx + b * max_out, out_i + b * max_out,
        out_q + b * max_out, end_carr, end_carr_i, /*want_end=*/false,
        out_cand + b);
    if (n < 0) return n;
    out_n[b] = n;
  }
  return 0;
}

}  // extern "C"
