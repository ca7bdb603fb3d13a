// K1: fused GPS L1 C/A block synthesis for Hopper (sm_90a).
//
// Replaces the fused Pallas TPU kernel _synth_tile_fused_kernel
// (gpssim_tpu/ops/synth_pallas.py:371) together with finalize_iq
// (gpssim_tpu/ops/synth_jax.py:586). It ports the arithmetic, not the TPU
// layout: the (82, 128) plane stack and its select tree exist only for
// 128-lane TPU SIMD. The plain PyTorch version of the same function is
// gpssim_tpu_torch/ops/synth_torch.py:synth_blocks_batch_torch; the two
// agree byte for byte.
//
// What bounds it on this card: integer ALU throughput. Each channel-sample
// costs 36 int32 ALU operations in the stage-B loop below (phase
// multiply-adds, shifts and masks, the window-word select, two gain folds
// of two multiplies each, two sign selects) plus two shared-memory table
// reads — at 12 channels and 7.5 M samples per 25-block window that is
// ~3.2 G operations, while the output written is only 15 MB (8-bit) or
// 30 MB (16-bit), a few microseconds of HBM bandwidth. So the design spends
// nothing on memory traffic and as few ALU operations as it can: every
// intermediate stays on chip (the per-(row, channel) stage-A bases, the
// C/A words and the two 512-entry carrier tables in shared memory, the
// channel sum in registers); the carrier magnitudes are two table reads
// instead of the TPU kernel's two polynomials; stage A runs once per
// (row, channel), 1/128 of the per-sample work; and the interleaved int16
// or int8 output is written directly (one 32- or 16-bit store per
// sample), with no separate finalize pass.
//
// Grid: (row tiles, blocks). A CTA owns ROWS_PER_CTA rows of 128 samples
// of one block. It first computes its rows' per-channel bases (stage A, one
// thread per (row, channel)), then each thread runs the channel loop for one
// sample at a time (stage B).
//
// All bit manipulation is done on uint32_t, where wraparound and shifts are
// defined; every shift amount is kept below 32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int ROWS_PER_CTA = 16;
constexpr int THREADS = 256;  // two rows of 128 lanes per pass
constexpr int MAX_C = 16;
constexpr int CA_WORDS = 36;
constexpr uint32_t CA_SEQ_LEN = 1023;
constexpr uint32_t M23 = (1u << 23) - 1;

// Per-(row, channel) bases: code phase hi/lo limbs, carrier phase hi/lo
// limbs, then the sign-folded chip-window words (2 narrow, 4 wide).
enum { F_HI = 0, F_LO = 1, C_HI = 2, C_LO = 3, S0 = 4, N_BASE = 8 };

struct K1Args {
  const int32_t* code_l;      // [B][4][C][3], block stride code_bs
  const int32_t* carr_l;      // [B][4][C][3]
  const int32_t* nav;         // [B][3][C]
  const int32_t* lane_steps;  // [B][4][C]
  const int32_t* ca_packed;   // [B][C][36], uint32 bit pattern
  const int32_t* gain_a;      // [B][C]
  const int32_t* gain_b;      // [B][C]
  long long code_bs, carr_bs, nav_bs, ls_bs, ca_bs, ga_bs, gb_bs;
};

__device__ __forceinline__ uint32_t shl_safe(uint32_t x, int k) {
  return k >= 32 ? 0u : (x << k);
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

__global__ void __launch_bounds__(THREADS)
synth_k1_kernel(K1Args a, const int16_t* __restrict__ lut, void* out, int C,
                int n_rows, int num_samples, int out_bits, int wide) {
  __shared__ int16_t s_sin[512];
  __shared__ int16_t s_cos[512];
  __shared__ uint32_t s_ca[MAX_C][CA_WORDS];
  __shared__ int32_t s_ls[4][MAX_C];
  __shared__ int32_t s_ga[MAX_C];
  __shared__ int32_t s_gb[MAX_C];
  __shared__ uint32_t s_base[ROWS_PER_CTA][MAX_C][N_BASE];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * ROWS_PER_CTA;
  const int tid = threadIdx.x;
  const int n_win = wide ? 4 : 2;

  for (int i = tid; i < 512; i += THREADS) {
    s_sin[i] = lut[i];
    s_cos[i] = lut[512 + i];
  }
  const int32_t* ca = a.ca_packed + b * a.ca_bs;
  for (int i = tid; i < C * CA_WORDS; i += THREADS) {
    s_ca[i / CA_WORDS][i % CA_WORDS] = static_cast<uint32_t>(ca[i]);
  }
  if (tid < C) {
    const int32_t* ls = a.lane_steps + b * a.ls_bs;
    for (int k = 0; k < 4; ++k) s_ls[k][tid] = ls[k * C + tid];
    s_ga[tid] = a.gain_a[b * a.ga_bs + tid];
    s_gb[tid] = a.gain_b[b * a.gb_bs + tid];
  }
  __syncthreads();

  // ---------------- stage A: per-(row, channel) bases ----------------
  const int rows_here = min(ROWS_PER_CTA, n_rows - row0);
  const int32_t* code_l = a.code_l + b * a.code_bs;
  const int32_t* carr_l = a.carr_l + b * a.carr_bs;
  const int32_t* nav = a.nav + b * a.nav_bs;
  for (int i = tid; i < rows_here * C; i += THREADS) {
    const int rr = i / C;
    const int c = i - rr * C;
    const uint32_t q = static_cast<uint32_t>(row0 + rr);
    // row = q2*4096 + q1*64 + q0, digits < 64: digit x limb < 2^29 and
    // every limb sum stays below 2^31.
    const uint32_t dig[4] = {1u, q & 63u, (q >> 6) & 63u, q >> 12};
    uint32_t cp[3], kp[3];
    for (int l = 0; l < 3; ++l) {
      uint32_t tc = 0, tk = 0;
      for (int d = 0; d < 4; ++d) {
        tc += dig[d] * static_cast<uint32_t>(code_l[(d * C + c) * 3 + l]);
        tk += dig[d] * static_cast<uint32_t>(carr_l[(d * C + c) * 3 + l]);
      }
      cp[l] = tc;
      kp[l] = tk;
    }
    // base-2^23 carries
    cp[1] += cp[0] >> 23; cp[0] &= M23; cp[2] += cp[1] >> 23; cp[1] &= M23;
    kp[1] += kp[0] >> 23; kp[0] &= M23; kp[2] += kp[1] >> 23; kp[1] &= M23;

    // code phase: integer chips → code periods (wraps) and chip in period
    const uint32_t chips_total = cp[2];
    const uint32_t wraps = chips_total / CA_SEQ_LEN;
    const uint32_t chip_base = chips_total - wraps * CA_SEQ_LEN;  // 0..1022
    // carrier phase mod 2^53: (M >> 23) < 2^30
    const uint32_t c_hi = ((kp[2] & 127u) << 23) + kp[1];

    // data bits at this code period and the next (8-bit host window)
    const uint32_t tcu = static_cast<uint32_t>(nav[c]) + wraps;
    const uint32_t bidx0 = static_cast<uint32_t>(nav[C + c]);
    const uint32_t bits = static_cast<uint32_t>(nav[2 * C + c]);
    const uint32_t neg_now = ((bits >> ((tcu / 20u - bidx0) & 31u)) & 1u) ^ 1u;
    const uint32_t neg_next =
        ((bits >> (((tcu + 1u) / 20u - bidx0) & 31u)) & 1u) ^ 1u;

    // chip window [chip_base, chip_base + 32*n_win), sign-folded: the data
    // bit flips exactly at the code wrap, window offset 1023 - chip_base
    const uint32_t wordpos = chip_base >> 5;
    const int bitoff = static_cast<int>(chip_base & 31u);
    const int wrap_off = static_cast<int>(CA_SEQ_LEN - chip_base);  // 1..1023
    const uint32_t xor_now = 0u - neg_now;
    const uint32_t xor_flip = 0u - (neg_now ^ neg_next);
    uint32_t* base = s_base[rr][c];
    for (int k = 0; k < n_win; ++k) {
      const uint32_t w0 = s_ca[c][wordpos + k];
      const uint32_t w1 = s_ca[c][wordpos + k + 1];
      const uint32_t win = (w0 >> bitoff) | shl_safe(w1, 32 - bitoff);
      const int wo = wrap_off - 32 * k;
      const uint32_t mask = wo <= 0 ? 0xFFFFFFFFu : shl_safe(0xFFFFFFFFu, wo);
      base[S0 + k] = win ^ xor_now ^ (mask & xor_flip);
    }
    base[F_HI] = cp[1];
    base[F_LO] = cp[0];
    base[C_HI] = c_hi;
    base[C_LO] = kp[0];
  }
  __syncthreads();

  // ---------------- stage B: one sample per thread ----------------
  const uint32_t lane = static_cast<uint32_t>(tid & (LANES - 1));
  for (int rr = tid / LANES; rr < rows_here; rr += THREADS / LANES) {
    const int n = (row0 + rr) * LANES + static_cast<int>(lane);
    if (n >= num_samples) continue;
    int32_t i_acc = 0, q_acc = 0;
    for (int c = 0; c < C; ++c) {
      const uint32_t* base = s_base[rr][c];
      // code: chips advanced within the row; the sign-folded window bit
      // is the full dataBit*codeCA sign
      const uint32_t lo = base[F_LO] + lane * static_cast<uint32_t>(s_ls[1][c]);
      const uint32_t H =
          base[F_HI] + lane * static_cast<uint32_t>(s_ls[0][c]) + (lo >> 23);
      const uint32_t chip_off = H >> 23;
      const uint32_t k = min(chip_off >> 5, static_cast<uint32_t>(n_win - 1));
      const uint32_t spos = (base[S0 + k] >> (chip_off & 31u)) & 1u;
      // carrier LUT index: bits 21..29 of the Q53 phase's high word (the
      // same bits under a logical or an arithmetic shift)
      const uint32_t klo = base[C_LO] + lane * static_cast<uint32_t>(s_ls[3][c]);
      const uint32_t kH =
          base[C_HI] + lane * static_cast<uint32_t>(s_ls[2][c]) + (klo >> 23);
      const uint32_t idx = (kH >> 21) & 511u;
      const int32_t ts = s_sin[idx];
      const int32_t tc = s_cos[idx];
      // exact trunc(gain * |LUT|) in split Q44, sign by select
      const int32_t mag_i = gain_trunc_mag(abs(tc), s_ga[c], s_gb[c]);
      const int32_t mag_q = gain_trunc_mag(abs(ts), s_ga[c], s_gb[c]);
      const bool chip_neg = spos == 0u;
      i_acc += (chip_neg != (tc < 0)) ? -mag_i : mag_i;
      q_acc += (chip_neg != (ts < 0)) ? -mag_q : mag_q;
    }
    // (short) cast of the accumulator; 8-bit output is the arithmetic
    // >> 4 of the int16 value (gps.c:2841-2845)
    const int16_t i16 = static_cast<int16_t>(i_acc);
    const int16_t q16 = static_cast<int16_t>(q_acc);
    const long long o = static_cast<long long>(b) * num_samples + n;
    if (out_bits == 16) {
      const uint32_t pair = static_cast<uint32_t>(static_cast<uint16_t>(i16)) |
                            (static_cast<uint32_t>(static_cast<uint16_t>(q16)) << 16);
      static_cast<uint32_t*>(out)[o] = pair;
    } else {
      const uint8_t i8 = static_cast<uint8_t>(static_cast<int8_t>(i16 >> 4));
      const uint8_t q8 = static_cast<uint8_t>(static_cast<int8_t>(q16 >> 4));
      static_cast<uint16_t*>(out)[o] =
          static_cast<uint16_t>(i8 | (static_cast<uint16_t>(q8) << 8));
    }
  }
}

}  // namespace

// Launch K1 on `stream` for B blocks. Every pointer is device memory; `lut`
// is int16[1024] (SIN_TABLE_512 then COS_TABLE_512); `out` is
// int16[B][2*num_samples] (out_bits 16) or int8[B][2*num_samples] (8).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gpssim_k1_launch(
    const void* code_l, long long code_bs, const void* carr_l, long long carr_bs,
    const void* nav, long long nav_bs, const void* lane_steps, long long ls_bs,
    const void* ca_packed, long long ca_bs, const void* gain_a, long long ga_bs,
    const void* gain_b, long long gb_bs, const void* lut, void* out, int B,
    int C, int n_rows, int num_samples, int out_bits, int wide, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > MAX_C || num_samples < 1 ||
      static_cast<long long>(n_rows) * LANES < num_samples ||
      (out_bits != 8 && out_bits != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K1Args a;
  a.code_l = static_cast<const int32_t*>(code_l);
  a.carr_l = static_cast<const int32_t*>(carr_l);
  a.nav = static_cast<const int32_t*>(nav);
  a.lane_steps = static_cast<const int32_t*>(lane_steps);
  a.ca_packed = static_cast<const int32_t*>(ca_packed);
  a.gain_a = static_cast<const int32_t*>(gain_a);
  a.gain_b = static_cast<const int32_t*>(gain_b);
  a.code_bs = code_bs;
  a.carr_bs = carr_bs;
  a.nav_bs = nav_bs;
  a.ls_bs = ls_bs;
  a.ca_bs = ca_bs;
  a.ga_bs = ga_bs;
  a.gb_bs = gb_bs;
  // only the rows that hold samples: the trailing partial row is masked
  const int rows = (num_samples + LANES - 1) / LANES;
  dim3 grid((rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA, B);
  synth_k1_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int16_t*>(lut), out, C, rows, num_samples, out_bits,
      wide);
  return static_cast<int>(cudaGetLastError());
}
