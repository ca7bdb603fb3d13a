// Stage B of GPS L1 C/A block synthesis, shared by K1 (synth_k1.cu) and K2
// (synth_k2.cu), so that the two kernels cannot drift apart.
//
// The counterpart of the JAX package's _accumulate_channels
// (gpssim_tpu/ops/synth_pallas.py:288): for each sample of a 128-sample
// row, the loop over channels of the code chip sign, the carrier-table
// value, the exact split-Q44 gain fold and the int32 sums of i and q. The
// per-(row, channel) bases it reads are the stage-A outputs, channel-major
// in the order of the enum below (the JAX package's base_names: f_hi,
// f_lo, c_hi, c_lo, sA, sB, then sC, sD for the 128-chip window).
//
// The design for Hopper:
//
// * One warp computes one row. Thread t computes the SAMPLES = 4 samples at
//   lanes t, t+32, t+64, t+96, so every per-(row, channel) value is the
//   same across the warp and is read once per four samples, as broadcast
//   vector loads (two 16-byte loads of the bases, one of the lane steps).
// * The carrier-table magnitude, the exact split-Q44 gain fold and the
//   carrier sign depend only on (block, channel, table index). They are
//   folded once per block into one signed int32 pair per index and channel
//   (build_gain_tables: C x 512 x 8 bytes of dynamic shared memory), so the
//   loop body does one 64-bit table gather where it did two table reads,
//   two |.|, four multiplies and two sign selects. The chip sign is then a
//   multiply by +1 or -1 (an IMAD, which issues to the FMA pipe and leaves
//   the integer ALU pipe to the shifts, masks and selects).
// * The phases are base + lane*step in uint32, as before; the window word
//   is picked by explicit selects on the code phase (no register array is
//   indexed at run time, so nothing goes to local memory).
//
// Per channel-sample the loop body is 16 integer operations and one 64-bit
// shared gather, against 36 operations and 13 shared loads in the
// one-sample-per-thread loop it replaces. The int32 pairs are kept as
// int32: nothing bounds trunc(gain*250) below 2^15, so they cannot be
// packed into two int16 halves.
//
// All bit manipulation is done on uint32_t, where wraparound and shifts are
// defined; every shift amount is kept below 32.

#pragma once

#include <cstddef>
#include <cstdint>

namespace gpssim {

constexpr int LANES = 128;
constexpr int WARP = 32;
constexpr int SAMPLES = LANES / WARP;  // samples per thread of a row's warp
constexpr int MAX_C = 16;              // channels the kernels' arrays hold
constexpr int TABLE = 512;             // carrier-table entries

// Per-(row, channel) bases: code phase hi/lo limbs, carrier phase hi/lo
// limbs, then the sign-folded chip-window words (2 narrow, 4 wide). A
// row's bases are held channel-major, uint32_t[C][N_BASE], 16-byte aligned.
enum { F_HI = 0, F_LO = 1, C_HI = 2, C_LO = 3, S0 = 4, N_BASE = 8 };

// Dynamic shared memory of the folded tables for C channels.
constexpr size_t gain_table_bytes(int C) {
  return static_cast<size_t>(C) * TABLE * sizeof(int2);
}

// (ga*ta + ((gb*ta) >> 22)) >> 22 with int32 wraparound, as the JAX
// program computes it (products < 2^31 for gain < 2); the arithmetic right
// shifts act on the int32 values.
__device__ __forceinline__ int32_t gain_trunc_mag(int32_t ta, int32_t ga,
                                                  int32_t gb) {
  const int32_t hi = static_cast<int32_t>(static_cast<uint32_t>(ga) *
                                          static_cast<uint32_t>(ta));
  const int32_t lo = static_cast<int32_t>(static_cast<uint32_t>(gb) *
                                          static_cast<uint32_t>(ta));
  return static_cast<int32_t>(static_cast<uint32_t>(hi) +
                              static_cast<uint32_t>(lo >> 22)) >> 22;
}

// Fold one block's gains into the carrier tables: tab[c*512 + e] =
// (sgn(cos[e]) * trunc(gain_c*|cos[e]|), sgn(sin[e]) * trunc(gain_c*|sin[e]|)),
// the magnitudes by gain_trunc_mag (so with its int32 wraparound), the sign
// applied by uint32 negation. An entry whose magnitude is 0 is 0 whatever
// its sign. Also stages the block's lane steps, one int4 per channel (code
// hi, code lo, carrier hi, carrier lo). `lut` is int16[1024]: SIN_TABLE_512
// then COS_TABLE_512. Every thread of the block calls it; the caller
// synchronises afterwards.
__device__ __forceinline__ void build_gain_tables(
    int2* tab, int4* ls, const int16_t* __restrict__ lut,
    const int32_t* lane_steps, const int32_t* gain_a, const int32_t* gain_b,
    int C, int tid, int n_threads) {
  for (int e = tid; e < TABLE; e += n_threads) {
    const int32_t ts = lut[e];
    const int32_t tc = lut[TABLE + e];
    const int32_t as = ts < 0 ? -ts : ts;
    const int32_t ac = tc < 0 ? -tc : tc;
    for (int c = 0; c < C; ++c) {
      const uint32_t mi = static_cast<uint32_t>(
          gain_trunc_mag(ac, gain_a[c], gain_b[c]));
      const uint32_t mq = static_cast<uint32_t>(
          gain_trunc_mag(as, gain_a[c], gain_b[c]));
      tab[c * TABLE + e] =
          make_int2(static_cast<int32_t>(tc < 0 ? 0u - mi : mi),
                    static_cast<int32_t>(ts < 0 ? 0u - mq : mq));
    }
  }
  if (tid < C) {
    ls[tid] = make_int4(lane_steps[tid], lane_steps[C + tid],
                        lane_steps[2 * C + tid], lane_steps[3 * C + tid]);
  }
}

// The channel sums of the SAMPLES samples lane + 32*j (j = 0..3) of one
// row, whose bases are `base` (channel-major, in shared memory; the same
// address across the warp). `tab` and `ls` are build_gain_tables' output.
// The sums are int32 with wraparound, held as uint32_t.
template <bool WIDE>
__device__ __forceinline__ void stage_b_row(const int2* __restrict__ tab,
                                            const int4* __restrict__ ls,
                                            const uint32_t (*base)[N_BASE],
                                            uint32_t lane, int C,
                                            uint32_t (&i_acc)[SAMPLES],
                                            uint32_t (&q_acc)[SAMPLES]) {
#pragma unroll
  for (int j = 0; j < SAMPLES; ++j) {
    i_acc[j] = 0u;
    q_acc[j] = 0u;
  }
  for (int c = 0; c < C; ++c) {
    const uint4 ph = *reinterpret_cast<const uint4*>(&base[c][F_HI]);
    uint4 win;
    if (WIDE) {
      win = *reinterpret_cast<const uint4*>(&base[c][S0]);
    } else {
      const uint2 w2 = *reinterpret_cast<const uint2*>(&base[c][S0]);
      win = make_uint4(w2.x, w2.y, 0u, 0u);
    }
    const int4 st = ls[c];
    // The code phase's high word one chip back, mod 32: hb's chip field is
    // f_hi's plus 31, so the chip field of H below is chip_off + 31 and
    // H >> 23 is chip_off - 1 (mod 32). Rotating the window word right by
    // it brings bit chip_off to bit 1. chip_off < 128 for every sample
    // rate the simulator takes (~1.03 Msps and up), so H < 2^31 never
    // wraps and the window compares are chip_off's, moved by 31 chips.
    const uint32_t hb = ph.x + (31u << 23);
    // the channel's table, addressed in bytes (a uniform base)
    const char* tab_c = reinterpret_cast<const char*>(tab + c * TABLE);
#pragma unroll
    for (int j = 0; j < SAMPLES; ++j) {
      const uint32_t n = lane + static_cast<uint32_t>(WARP * j);
      // code: chips advanced within the row; the sign-folded window bit
      // is the full dataBit*codeCA sign
      const uint32_t lo = ph.y + n * static_cast<uint32_t>(st.y);
      const uint32_t H = hb + n * static_cast<uint32_t>(st.x) + (lo >> 23);
      // window word min(chip_off >> 5, n_win - 1): chip_off < 32 is
      // H < 63 << 23, chip_off < 64 is H < 95 << 23, and so on
      uint32_t w;
      if (WIDE) {
        const uint32_t w01 = H < (63u << 23) ? win.x : win.y;
        const uint32_t w23 = H < (127u << 23) ? win.z : win.w;
        w = H < (95u << 23) ? w01 : w23;
      } else {
        w = H < (63u << 23) ? win.x : win.y;
      }
      // +1, or -1 where the chip is negative (window bit chip_off & 31 is
      // 0; the funnel shift takes its amount mod 32)
      const uint32_t sgn = (__funnelshift_r(w, w, H >> 23) & 2u) - 1u;
      // carrier table entry: bits 21..29 of the Q53 phase's high word,
      // times 8 bytes
      const uint32_t klo = ph.w + n * static_cast<uint32_t>(st.w);
      const uint32_t kH = ph.z + n * static_cast<uint32_t>(st.z) + (klo >> 23);
      const int2 t = *reinterpret_cast<const int2*>(
          tab_c + ((kH >> 18) & ((TABLE - 1u) << 3)));
      i_acc[j] += sgn * static_cast<uint32_t>(t.x);
      q_acc[j] += sgn * static_cast<uint32_t>(t.y);
    }
  }
}

}  // namespace gpssim
