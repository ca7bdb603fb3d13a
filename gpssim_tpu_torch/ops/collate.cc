// The port's collation engine: a window of block plans -> the packed int32
// window the synthesis kernels read, in one call.
//
// It computes exactly what ops/args.py's NumPy path gives,
// pack_args(args_from_arrays(...)) of the compacted window:
//   - compaction: per block, the active slots first and then the inactive
//     ones, each in slot order (a stable argsort of ~active), cut to k,
//     the window's largest active count (at least 1), rounded up to a
//     multiple of compact_multiple and capped at the channel count;
//   - per channel slot: the Q46 code phase and Q53 carrier phase with the
//     steps scaled by 128, 128*64 and 128*4096, as base-2^23 limbs; the
//     split per-lane steps; the 8-bit data-bit window; the split Q44 gain,
//     folded where the split is not trunc(T*g) for every carrier-table
//     magnitude T (args._fold_exact); the bit-packed C/A row;
//   - the same errors at the same inputs, in the same order of checks.
//
// Each value is formed the way NumPy forms it: np.rint is nearbyint in the
// default rounding mode, half to even (rint rounds the same, and is the
// fast one: glibc's nearbyint saves and restores the FP environment);
// float // is npy_floor_divide (fmod-based, not floor(a / b)); int64 //
// and % floor; >> on a negative int64 is an arithmetic shift; a float64
// -> int cast truncates and gives the x86 integer-indefinite value
// (INT_MIN) out of range; no FMA contraction (-ffp-contract=off).
//
// The packed row of a block holds, for k slots, the fields in pack_args'
// order (sorted by name): ca_packed (k, 36), carr_l (4, k, 3),
// code_l (4, k, 3), gain_a (k), gain_b (k), lane_steps (4, k), nav (3, k):
// 69 words a slot.
//
// Built by io/native.py with g++ at first use, into build/native/ under a
// name that hashes this file and the flags.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int64_t kM23 = (int64_t(1) << 23) - 1;
constexpr int64_t kMask53 = (int64_t(1) << 53) - 1;  // floor mod 2^53
constexpr double kTwo22 = 4194304.0;
constexpr double kTwo44 = 17592186044416.0;
constexpr double kTwo46 = 70368744177664.0;
constexpr double kTwo53 = 9007199254740992.0;
constexpr long kCaWords = 36;
constexpr long kNavWords = 60;
constexpr long kWordsPerSlot = 69;
constexpr double kCaSeqLen = 1023.0;
constexpr long kLanes = 128;

// Error codes, in the order the NumPy path checks (ops/args.py).
enum Error : long {
  kQ46 = -1,         // block too long for the Q46 code-phase range
  kRowWindow = -2,   // sample rate too low for the 128-chip row window
  kBitWindow = -3,   // data-bit window overflow
  kNavBuffer = -4,   // data-bit index past the 60-word nav buffer
  kNavIndex = -5,    // a negative data word index out of the buffer
  kNoGain = -6,      // no Q44 gain gives trunc(T*g) for every T
  kPrnIndex = -7,    // a PRN row out of the C/A table
};

int64_t to_i64(double x) {
  if (x >= -9223372036854775808.0 && x < 9223372036854775808.0)
    return static_cast<int64_t>(x);
  return std::numeric_limits<int64_t>::min();
}

int32_t to_i32(double x) {
  if (x > -2147483649.0 && x < 2147483648.0) return static_cast<int32_t>(x);
  return std::numeric_limits<int32_t>::min();
}

int32_t wrap32(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}

int64_t shl(int64_t v, int s) {
  return static_cast<int64_t>(static_cast<uint64_t>(v) << s);
}

int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

// NumPy's float64 floor division (npy_floor_divide -> npy_divmod).
double npy_floor_divide(double a, double b) {
  if (b == 0.0) return a / b;
  double mod = std::fmod(a, b);
  double div = (a - mod) / b;
  if (mod != 0.0 && (std::isless(b, 0.0) != std::isless(mod, 0.0)))
    div -= 1.0;
  if (div != 0.0) {
    double fl = std::floor(div);
    if (std::isgreater(div - fl, 0.5)) fl += 1.0;
    return fl;
  }
  return std::copysign(0.0, a / b);
}

struct Limbs {
  int32_t v[3];
};

// args._limbs3: a non-negative int64 as three base-2^23 limbs.
Limbs limbs3(int64_t v) {
  return {{wrap32(v & kM23), wrap32((v >> 23) & kM23), wrap32(v >> 46)}};
}

// args._limbs_shl: limbs shifted left by s (< 23) bits with carries;
// mod_bits > 0 drops the bits at and above 2^mod_bits.
Limbs limbs_shl(const Limbs& l, int s, int mod_bits) {
  const int64_t a0 = l.v[0], a1 = l.v[1], a2 = l.v[2];
  const int64_t l0 = shl(a0, s) & kM23;
  const int64_t c0 = a0 >> (23 - s);
  const int64_t l1 = (shl(a1, s) | c0) & kM23;
  const int64_t c1 = a1 >> (23 - s);
  int64_t l2 = shl(a2, s) | c1;
  if (mod_bits > 0) l2 &= (int64_t(1) << (mod_bits - 46)) - 1;
  return {{wrap32(l0), wrap32(l1), wrap32(l2)}};
}

// The gain screen of a g > 0: whether some product T*g lies less than 2^-20
// above an integer (NumPy: prod - floor(prod) < 2^-20). Below 2^51 the
// nearest integer r of prod comes from adding and subtracting 1.5 * 2^52,
// and prod - r, like NumPy's prod - floor(prod), is exact (Sterbenz): the
// fraction is below 2^-20 exactly where 0 <= prod - r < 2^-20. The
// products go two to a vector (SSE2), four at a time, and the least such
// prod - r is kept; every window screens its slots, so this loop is most
// of the engine's time.
bool screen(double g, const double* mags, long n_mags) {
  typedef double v2d __attribute__((vector_size(16)));
  constexpr double kMagic = 6755399441055744.0;  // 1.5 * 2^52
  constexpr double kFits = 2251799813685248.0;   // 2^51
  const v2d gg = {g, g}, magic = {kMagic, kMagic}, zero = {0.0, 0.0},
            one = {1.0, 1.0};
  v2d lo0 = one, lo1 = one, hi0 = zero, hi1 = zero;
  long i = 0;
  for (; i + 4 <= n_mags; i += 4) {
    v2d t0, t1;
    std::memcpy(&t0, mags + i, sizeof t0);
    std::memcpy(&t1, mags + i + 2, sizeof t1);
    const v2d p0 = t0 * gg, p1 = t1 * gg;
    const v2d d0 = p0 - ((p0 + magic) - magic);
    const v2d d1 = p1 - ((p1 + magic) - magic);
    const v2d e0 = d0 >= zero ? d0 : one, e1 = d1 >= zero ? d1 : one;
    lo0 = e0 < lo0 ? e0 : lo0;
    lo1 = e1 < lo1 ? e1 : lo1;
    hi0 = p0 > hi0 ? p0 : hi0;
    hi1 = p1 > hi1 ? p1 : hi1;
  }
  double lo = std::min(std::min(lo0[0], lo0[1]), std::min(lo1[0], lo1[1]));
  double hi = std::max(std::max(hi0[0], hi0[1]), std::max(hi1[0], hi1[1]));
  for (; i < n_mags; ++i) {
    const double prod = mags[i] * g;
    const double d = prod - ((prod + kMagic) - kMagic);
    if (d >= 0.0) lo = std::min(lo, d);
    hi = std::max(hi, prod);
  }
  if (hi < kFits) return lo < 0x1p-20;
  for (i = 0; i < n_mags; ++i) {  // a product at or above 2^51, or inf
    const double prod = mags[i] * g;
    if (prod - std::floor(prod) < 0x1p-20) return true;
  }
  return false;
}

// args._fold_exact: the Q44 gain nearest g * 2^44 whose device product
// floor(T * G / 2^44) is trunc(T * g) for every magnitude T.
bool fold_exact(double g, const double* mags, long n_mags, int64_t* G) {
  int64_t lo = 0, hi = int64_t(1) << 62;
  for (long i = 0; i < n_mags; ++i) {
    const double T = mags[i];
    if (T == 0.0) continue;
    const int64_t t = to_i64(std::trunc(T * g));
    const int64_t m = static_cast<int64_t>(T);
    lo = std::max(lo, -floordiv(shl(-t, 44), m));
    hi = std::min(hi, -floordiv(shl(-(t + 1), 44), m) - 1);
  }
  if (lo > hi) return false;
  *G = std::min(std::max(to_i64(std::floor(g * kTwo44)), lo), hi);
  return true;
}

}  // namespace

extern "C" {

// One window of B plans of C channel slots each.
//   active   uint8 (B, C)
//   f64      float64 (B, 5, C): code_phase, f_code, carr_phase, f_carr, gain
//   i64      int64 (B, 4, C): iword, ibit, icode, prn
//   nco      int64 (B, 2, C): carr_phase_i, carr_step_i (int_nco only)
//   dwrd     uint32 (B, C, 60)
//   ca_table uint32 (n_ca_rows, 36): row 0 zeros, row p PRN p's chips
//   mags     float64 (n_mags): the carrier-table magnitudes
//   out      int32, room for B * 69 * C words; (B, 69 * k) is written
//   folds    int32 (B): the slots whose gain was folded, per block
//   fault    float64 (1): the gain or index an error names
// Returns k >= 1, or an Error.
long gcollate_window(long B, long C, long num_samples, double delt,
                     double row_limit, int int_nco, int compact,
                     long compact_multiple, const uint8_t* active,
                     const double* f64, const int64_t* i64,
                     const int64_t* nco, const uint32_t* dwrd,
                     const uint32_t* ca_table, long n_ca_rows,
                     const double* mags, long n_mags, int32_t* out,
                     int32_t* folds, double* fault) {
  // --- compaction: the slot order of each block, cut to k ---
  long k = C;
  if (compact) {
    long most = 0;
    for (long b = 0; b < B; ++b) {
      long n = 0;
      for (long c = 0; c < C; ++c) n += active[b * C + c] != 0;
      most = std::max(most, n);
    }
    k = std::max(1L, most);
    if (compact_multiple > 1)
      k = std::min((k + compact_multiple - 1) / compact_multiple *
                       compact_multiple,
                   C);
  }
  std::vector<long> order(static_cast<size_t>(B * k));
  for (long b = 0; b < B; ++b) {
    long s = 0;
    if (!compact) {
      for (; s < k; ++s) order[b * k + s] = s;
      continue;
    }
    for (int on = 1; on >= 0 && s < k; --on)
      for (long c = 0; c < C && s < k; ++c)
        if ((active[b * C + c] != 0) == (on == 1)) order[b * k + s++] = c;
  }

  // --- the window-wide checks and the largest code wrap ---
  const double n_f = static_cast<double>(num_samples);
  const double reach = static_cast<double>(num_samples + 32768);
  bool q46 = false, row = false, any_off = false;
  double wraps = -std::numeric_limits<double>::infinity();
  for (long b = 0; b < B; ++b) {
    for (long s = 0; s < k; ++s) {
      const long c = order[b * k + s];
      const bool on = active[b * C + c] != 0;
      const double* f = f64 + b * 5 * C;
      const double step = f[C + c] * delt;
      const double masked = on ? step : 0.0;
      if (!(masked * n_f < 131072.0)) q46 = true;
      if (!(masked * static_cast<double>(kLanes - 1) < row_limit))
        row = true;
      if (on)
        wraps = std::max(wraps,
                         npy_floor_divide(f[c] + reach * step, kCaSeqLen));
      else
        any_off = true;
    }
  }
  if (q46) return kQ46;
  if (row) return kRowWindow;
  if (any_off) wraps = std::max(wraps, 0.0);
  const int64_t wraps_max = to_i64(wraps);

  // --- every slot's words; flags for the later checks ---
  const long K = kWordsPerSlot * k;
  bool bit_window = false, nav_buffer = false, nav_index = false;
  bool flagged = false, prn_index = false;
  double nav_fault = 0.0, prn_fault = 0.0;
  for (long b = 0; b < B; ++b) {
    folds[b] = 0;
    const double* f = f64 + b * 5 * C;
    const int64_t* w = i64 + b * 4 * C;
    int32_t* r = out + b * K;
    int32_t* carr_l = r + kCaWords * k;
    int32_t* code_l = carr_l + 12 * k;
    int32_t* gain_a = code_l + 12 * k;
    int32_t* gain_b = gain_a + k;
    int32_t* lane = gain_b + k;
    int32_t* nav = lane + 4 * k;
    for (long s = 0; s < k; ++s) {
      const long c = order[b * k + s];
      const bool on = active[b * C + c] != 0;
      const double step = f[C + c] * delt;

      const int64_t code0_q = to_i64(std::rint(f[c] * kTwo46));
      const int64_t cstep_q = to_i64(std::rint(step * kTwo46));
      int64_t carr0_q, kstep_q;
      if (int_nco) {
        // the reference's 2^25-per-cycle NCO embedded in Q53 (<< 28)
        const int64_t* n = nco + b * 2 * C;
        carr0_q = (n[c] & ((int64_t(1) << 25) - 1)) << 28;
        kstep_q = shl(n[C + c], 28);
      } else {
        carr0_q = to_i64(std::rint(f[2 * C + c] * kTwo53));
        kstep_q = to_i64(std::rint((f[3 * C + c] * delt) * kTwo53));
      }
      const Limbs c1 = limbs_shl(limbs3(cstep_q), 7, 0);
      const Limbs k1 = limbs3(shl(kstep_q, 7) & kMask53);
      const Limbs c64 = limbs_shl(c1, 6, 0);
      const Limbs k64 = limbs_shl(k1, 6, 53);
      const Limbs code_rows[4] = {limbs3(code0_q), c1, c64,
                                  limbs_shl(c64, 6, 0)};
      const Limbs carr_rows[4] = {limbs3(carr0_q & kMask53), k1, k64,
                                  limbs_shl(k64, 6, 53)};
      for (int i = 0; i < 4; ++i) {
        std::memcpy(code_l + (i * k + s) * 3, code_rows[i].v, 12);
        std::memcpy(carr_l + (i * k + s) * 3, carr_rows[i].v, 12);
      }
      lane[s] = wrap32(cstep_q >> 23);
      lane[k + s] = wrap32(cstep_q & kM23);
      lane[2 * k + s] = wrap32(kstep_q >> 23);
      lane[3 * k + s] = wrap32(kstep_q & kM23);

      // data-bit window: every bit a row of the block can touch
      const int64_t tcu0 = static_cast<int64_t>(
          static_cast<uint64_t>(w[c]) * 600u +
          static_cast<uint64_t>(w[C + c]) * 20u +
          static_cast<uint64_t>(w[2 * C + c]));
      const int64_t bidx0 = floordiv(tcu0, 20);
      if (floordiv(tcu0 + wraps_max + 1, 20) - bidx0 > 7) bit_window = true;
      const uint32_t* words = dwrd + (b * C + c) * kNavWords;
      int64_t bits8 = 0;
      for (int j = 0; j < 8; ++j) {
        const int64_t bidx = bidx0 + j;
        const int64_t iw0 = floordiv(bidx, 30);
        if (on && iw0 > kNavWords - 1) nav_buffer = true;
        int64_t iw = std::min<int64_t>(iw0, kNavWords - 1);
        const int64_t ib = bidx - iw0 * 30;
        if (iw < 0) iw += kNavWords;  // NumPy's negative index
        if (iw < 0) {
          if (!nav_index) nav_fault = static_cast<double>(iw - kNavWords);
          nav_index = true;
          continue;
        }
        bits8 |= ((static_cast<int64_t>(words[iw]) >> (29 - ib)) & 1) << j;
      }
      nav[s] = wrap32(tcu0);
      nav[k + s] = wrap32(bidx0);
      nav[2 * k + s] = wrap32(bits8);

      // the Q44 gain, split into two 22-bit halves
      const double g = on ? f[4 * C + c] : 0.0;
      const double g44 = std::floor(g * kTwo44);
      const int32_t ga = to_i32(std::floor(g * kTwo22));
      gain_a[s] = ga;
      gain_b[s] = to_i32(g44 - static_cast<double>(ga) * kTwo22);
      if (g > 0.0 && !flagged) flagged = screen(g, mags, n_mags);

      int64_t prn = on ? w[3 * C + c] : 0;
      if (prn < 0) prn += n_ca_rows;
      if (prn < 0 || prn >= n_ca_rows) {
        if (!prn_index)
          prn_fault = static_cast<double>(on ? w[3 * C + c] : 0);
        prn_index = true;
        prn = 0;
      }
      std::memcpy(r + s * kCaWords, ca_table + prn * kCaWords,
                  kCaWords * sizeof(uint32_t));
    }
  }
  if (bit_window) return kBitWindow;
  if (nav_buffer) return kNavBuffer;
  if (nav_index) {
    *fault = nav_fault;
    return kNavIndex;
  }

  // --- some product sits within 2^-20 above an integer: compare the
  // split's product with trunc(T*g) for every slot and fold where it
  // differs ---
  if (flagged) {
    for (long b = 0; b < B; ++b) {
      const double* f = f64 + b * 5 * C;
      int32_t* gain_a = out + b * K + (kCaWords + 24) * k;
      int32_t* gain_b = gain_a + k;
      for (long s = 0; s < k; ++s) {
        const long c = order[b * k + s];
        const double g = active[b * C + c] != 0 ? f[4 * C + c] : 0.0;
        const int64_t ga = gain_a[s], gb = gain_b[s];
        bool bad = false;
        for (long i = 0; i < n_mags && !bad; ++i) {
          const int64_t m = static_cast<int64_t>(mags[i]);
          const int64_t q44 = (ga * m + ((gb * m) >> 22)) >> 22;
          bad = to_i64(std::trunc(mags[i] * g)) != q44;
        }
        if (!bad) continue;
        int64_t G;
        if (!fold_exact(g, mags, n_mags, &G)) {
          *fault = g;
          return kNoGain;
        }
        gain_a[s] = wrap32(G >> 22);
        gain_b[s] = wrap32(G & ((int64_t(1) << 22) - 1));
        ++folds[b];
      }
    }
  }
  if (prn_index) {
    *fault = prn_fault;
    return kPrnIndex;
  }
  return k;
}

}  // extern "C"
