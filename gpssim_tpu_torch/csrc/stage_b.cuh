// Stage B of GPS L1 C/A block synthesis, shared by K1 (synth_k1.cu) and K2
// (synth_k2.cu), so that the two kernels cannot drift apart.
//
// The counterpart of the JAX package's _accumulate_channels
// (gpssim_tpu/ops/synth_pallas.py:288): for one sample (one lane of a
// 128-sample row), the loop over channels of the code chip sign, the
// carrier-table magnitudes, the exact split-Q44 gain fold and the int32
// sums of i and q. The per-(row, channel) bases it reads are the stage-A
// outputs, in the order of the enum below (the JAX package's base_names:
// f_hi, f_lo, c_hi, c_lo, sA, sB, then sC, sD for the 128-chip window).
//
// All bit manipulation is done on uint32_t, where wraparound and shifts are
// defined; every shift amount is kept below 32.

#pragma once

#include <cstdint>

namespace gpssim {

constexpr int LANES = 128;
constexpr int MAX_C = 16;  // channels the kernels' shared arrays hold

// Per-(row, channel) bases: code phase hi/lo limbs, carrier phase hi/lo
// limbs, then the sign-folded chip-window words (2 narrow, 4 wide).
enum { F_HI = 0, F_LO = 1, C_HI = 2, C_LO = 3, S0 = 4, N_BASE = 8 };

// The per-channel stage-B inputs and the carrier tables, staged in shared
// memory by the kernel before the loop.
struct StageBShared {
  int16_t sin_t[512];
  int16_t cos_t[512];
  int32_t ls[4][MAX_C];  // lane steps: code hi/lo, carrier hi/lo
  int32_t ga[MAX_C];     // split Q44 gain, high and low parts
  int32_t gb[MAX_C];
};

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

// Copy the carrier tables (int16[1024]: SIN_TABLE_512 then COS_TABLE_512)
// and channel b's lane steps and gains into shared memory. Every thread of
// the block calls it; the caller synchronises afterwards.
__device__ __forceinline__ void stage_b_load(
    StageBShared& s, const int16_t* __restrict__ lut,
    const int32_t* lane_steps, const int32_t* gain_a, const int32_t* gain_b,
    int C, int tid, int n_threads) {
  for (int i = tid; i < 512; i += n_threads) {
    s.sin_t[i] = lut[i];
    s.cos_t[i] = lut[512 + i];
  }
  if (tid < C) {
    for (int k = 0; k < 4; ++k) s.ls[k][tid] = lane_steps[k * C + tid];
    s.ga[tid] = gain_a[tid];
    s.gb[tid] = gain_b[tid];
  }
}

// The channel sums of one sample at `lane` of a row. `base(c, k)` returns
// base k (the enum above) of channel c for the row.
template <typename Bases>
__device__ __forceinline__ void stage_b_sample(const StageBShared& s,
                                               const Bases& base,
                                               uint32_t lane, int C, int n_win,
                                               int32_t& i_acc,
                                               int32_t& q_acc) {
  i_acc = 0;
  q_acc = 0;
  for (int c = 0; c < C; ++c) {
    // code: chips advanced within the row; the sign-folded window bit is
    // the full dataBit*codeCA sign
    const uint32_t lo = base(c, F_LO) + lane * static_cast<uint32_t>(s.ls[1][c]);
    const uint32_t H =
        base(c, F_HI) + lane * static_cast<uint32_t>(s.ls[0][c]) + (lo >> 23);
    const uint32_t chip_off = H >> 23;
    const uint32_t k = min(chip_off >> 5, static_cast<uint32_t>(n_win - 1));
    const uint32_t spos = (base(c, S0 + static_cast<int>(k)) >>
                           (chip_off & 31u)) & 1u;
    // carrier LUT index: bits 21..29 of the Q53 phase's high word (the
    // same bits under a logical or an arithmetic shift)
    const uint32_t klo = base(c, C_LO) + lane * static_cast<uint32_t>(s.ls[3][c]);
    const uint32_t kH =
        base(c, C_HI) + lane * static_cast<uint32_t>(s.ls[2][c]) + (klo >> 23);
    const uint32_t idx = (kH >> 21) & 511u;
    const int32_t ts = s.sin_t[idx];
    const int32_t tc = s.cos_t[idx];
    // exact trunc(gain * |LUT|) in split Q44, sign by select
    const int32_t mag_i = gain_trunc_mag(abs(tc), s.ga[c], s.gb[c]);
    const int32_t mag_q = gain_trunc_mag(abs(ts), s.ga[c], s.gb[c]);
    const bool chip_neg = spos == 0u;
    i_acc += (chip_neg != (tc < 0)) ? -mag_i : mag_i;
    q_acc += (chip_neg != (ts < 0)) ? -mag_q : mag_q;
  }
}

}  // namespace gpssim
