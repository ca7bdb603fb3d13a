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
// What bounds it on this card: the integer pipes of the stage-B loop
// (csrc/stage_b.cuh, shared with K2): 16 integer operations and one
// 64-bit shared gather per channel-sample, ~1.4 G operations per 25-block
// window at 12 channels, against an output of only 15 MB (8-bit) or 30 MB
// (16-bit), a few microseconds of HBM bandwidth. So every intermediate
// stays on chip and the kernel's time should go to that loop, not to
// set-up: stage A runs once per (row, channel), 1/128 of the per-sample
// work, in the warp that then runs the row; the gain-folded carrier tables
// are built once per (CTA, block); the channel sums stay in registers and
// the interleaved int16 or int8 output is written directly, with no
// separate finalize pass.
//
// Grid: persistent, K2's (csrc/persistent_grid.cuh). As many 512-thread
// CTAs as fit on the card at once (the SM count times the occupancy,
// queried once per kernel, device and channel count), each owning one
// contiguous range of the B x rows rows; a range may cross block
// boundaries. gpssim_k1_grid reports the grid a launch takes. For each
// block its range touches, a CTA stages once, in shared memory, the block's
// gain-folded C x 512 carrier-table pairs (build_gain_tables), lane steps,
// C/A words and stage-A inputs, then synchronises; that is the only
// CTA-wide barrier. Warp w then takes the rows w, w + 16, ... of that
// range two at a time: lane 16h + c computes stage A for channel c of row
// r + 16h (the digit polynomial in base-2^23 limbs, the wrap by 1023, the
// data-bit window and the wrap mask) into a warp-private channel-major
// double slot, and after a __syncwarp the warp runs the stage-B loop over
// each of the two rows, four samples per thread. At the main shape (25
// blocks of 2,344 rows) on 264 CTAs that is 222 rows per CTA and, by the
// partition's arithmetic, 288 table folds per window, where 16-row CTAs
// took 3,675. Against three CTAs per
// SM (40 registers, forced by the launch bounds) and against stage B
// unrolled over the two rows, this form measured fastest (PERF.md).
// ptxas (sm_90a): 55 registers, 20,672 bytes of static shared memory plus
// the C x 4 KB tables, no stack, no spills: two CTAs (32 warps) per SM at
// 12 channels and at 16, so 264 CTAs on the card's 132 SMs.
//
// Raw mode (raw != 0) stops before the finalize, as the JAX package's
// Pallas kernels do: it computes all n_rows rows (the tile-padded R_pad
// rows of the raw outputs) and stores the int16 i and q planes, each
// [B][n_rows][128], so that a channel-sharded mesh can sum the partial
// rows before the interleave and the 8-bit shift (parallel/shard.py).
//
// All bit manipulation is done on uint32_t, where wraparound and shifts are
// defined; every shift amount is kept below 32.

#include <cstdint>
#include <cuda_runtime.h>

#include "persistent_grid.cuh"
#include "stage_b.cuh"

namespace {

using namespace gpssim;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / WARP;  // each warp takes two rows per pass
constexpr int CA_WORDS = 36;
constexpr uint32_t CA_SEQ_LEN = 1023;
constexpr uint32_t M23 = (1u << 23) - 1;

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

// One block's stage-A inputs as a CTA stages them: the flat layouts of the
// arguments, code[(d*C + c)*3 + l], nav[k*C + c], ca[c*36 + word].
struct StageA {
  uint32_t code[4 * MAX_C * 3];
  uint32_t carr[4 * MAX_C * 3];
  uint32_t nav[3 * MAX_C];
  uint32_t ca[MAX_C * CA_WORDS];
};

__device__ __forceinline__ uint32_t shl_safe(uint32_t x, int k) {
  return k >= 32 ? 0u : (x << k);
}

// Stage A for channel c of row q (the row's index within its block): the
// row-start code phase (Q46) and carrier phase (Q53) limbs and the
// sign-folded chip-window words, written to `base` (channel-major, 16-byte
// aligned, the layout stage_b_row reads).
template <bool WIDE>
__device__ __forceinline__ void stage_a(const StageA& s, int C, int c,
                                        uint32_t q, uint32_t* base) {
  constexpr int n_win = WIDE ? 4 : 2;
  // row = q2*4096 + q1*64 + q0, digits < 64: digit x limb < 2^29 and every
  // limb sum stays below 2^31.
  const uint32_t dig[4] = {1u, q & 63u, (q >> 6) & 63u, q >> 12};
  uint32_t cp[3], kp[3];
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    uint32_t tc = 0, tk = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      tc += dig[d] * s.code[(d * C + c) * 3 + l];
      tk += dig[d] * s.carr[(d * C + c) * 3 + l];
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
  const uint32_t tcu = s.nav[c] + wraps;
  const uint32_t bidx0 = s.nav[C + c];
  const uint32_t bits = s.nav[2 * C + c];
  const uint32_t neg_now = ((bits >> ((tcu / 20u - bidx0) & 31u)) & 1u) ^ 1u;
  const uint32_t neg_next =
      ((bits >> (((tcu + 1u) / 20u - bidx0) & 31u)) & 1u) ^ 1u;

  // chip window [chip_base, chip_base + 32*n_win), sign-folded: the data
  // bit flips exactly at the code wrap, window offset 1023 - chip_base
  const uint32_t* ca = s.ca + c * CA_WORDS + (chip_base >> 5);
  const int bitoff = static_cast<int>(chip_base & 31u);
  const int wrap_off = static_cast<int>(CA_SEQ_LEN - chip_base);  // 1..1023
  const uint32_t xor_now = 0u - neg_now;
  const uint32_t xor_flip = 0u - (neg_now ^ neg_next);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < n_win; ++k) {
    const uint32_t win = (ca[k] >> bitoff) | shl_safe(ca[k + 1], 32 - bitoff);
    const int wo = wrap_off - 32 * k;
    const uint32_t mask = wo <= 0 ? 0xFFFFFFFFu : shl_safe(0xFFFFFFFFu, wo);
    w[k] = win ^ xor_now ^ (mask & xor_flip);
  }
  *reinterpret_cast<uint4*>(base + F_HI) = make_uint4(cp[1], cp[0], c_hi,
                                                      kp[0]);
  if (WIDE) {
    *reinterpret_cast<uint4*>(base + S0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(base + S0) = make_uint2(w[0], w[1]);
  }
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
synth_k1_kernel(K1Args a, const int16_t* __restrict__ lut, void* out, int C,
                int n_rows, int num_samples, int out_bits, int raw,
                long long total_rows, long long rows_per_cta) {
  extern __shared__ int2 s_tab[];  // [C][512], gain_table_bytes(C)
  __shared__ int4 s_ls[MAX_C];
  __shared__ StageA s_in;
  __shared__ __align__(16) uint32_t s_slot[WARPS][2][MAX_C][N_BASE];

  const int tid = threadIdx.x;
  const int warp = tid / WARP;
  const uint32_t lane = static_cast<uint32_t>(tid % WARP);
  const int half = static_cast<int>(lane >> 4);  // stage A: row r + 16*half
  const int chan = static_cast<int>(lane & 15u);  // stage A: channel

  const long long first = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long last = min(first + rows_per_cta, total_rows);
  for (long long seg = first; seg < last;) {
    // the rows of one block: [seg, seg_end)
    const int b = static_cast<int>(seg / n_rows);
    const long long row0 = static_cast<long long>(b) * n_rows;
    const long long seg_end = min(last, row0 + n_rows);
    __syncthreads();  // every warp is done with the previous block's data
    build_gain_tables(s_tab, s_ls, lut, a.lane_steps + b * a.ls_bs,
                      a.gain_a + b * a.ga_bs, a.gain_b + b * a.gb_bs, C, tid,
                      THREADS);
    {
      const int n_l = 12 * C, n_nav = 3 * C, n_ca = CA_WORDS * C;
      const int32_t* code_l = a.code_l + b * a.code_bs;
      const int32_t* carr_l = a.carr_l + b * a.carr_bs;
      const int32_t* nav = a.nav + b * a.nav_bs;
      const int32_t* ca = a.ca_packed + b * a.ca_bs;
      for (int i = tid; i < n_l; i += THREADS) {
        s_in.code[i] = static_cast<uint32_t>(code_l[i]);
        s_in.carr[i] = static_cast<uint32_t>(carr_l[i]);
      }
      for (int i = tid; i < n_nav; i += THREADS) {
        s_in.nav[i] = static_cast<uint32_t>(nav[i]);
      }
      for (int i = tid; i < n_ca; i += THREADS) {
        s_in.ca[i] = static_cast<uint32_t>(ca[i]);
      }
    }
    __syncthreads();

    for (long long r = seg + warp; r < seg_end; r += 2 * WARPS) {
      // ---------------- stage A: two rows, one lane per channel ----------
      const long long rh = r + half * WARPS;
      __syncwarp();  // the warp is done reading its slot's previous rows
      if (chan < C && rh < seg_end) {
        stage_a<WIDE>(s_in, C, chan, static_cast<uint32_t>(rh - row0),
                      s_slot[warp][half][chan]);
      }
      __syncwarp();

      // ---------------- stage B: the two rows in turn ----------------
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const long long row = r + h * WARPS;
        if (row >= seg_end) break;
        uint32_t i_acc[SAMPLES], q_acc[SAMPLES];
        stage_b_row<WIDE>(s_tab, s_ls, s_slot[warp][h], lane, C, i_acc,
                          q_acc);
        const int n0 = static_cast<int>(row - row0) * LANES +
                       static_cast<int>(lane);
#pragma unroll
        for (int j = 0; j < SAMPLES; ++j) {
          // (short) cast of the accumulator; 8-bit output is the arithmetic
          // >> 4 of the int16 value (gps.c:2841-2845)
          const int16_t i16 = static_cast<int16_t>(i_acc[j]);
          const int16_t q16 = static_cast<int16_t>(q_acc[j]);
          if (raw) {
            // the i plane, then the q plane: [2][B][n_rows][128]
            const long long o = row * LANES + lane + WARP * j;
            static_cast<int16_t*>(out)[o] = i16;
            static_cast<int16_t*>(out)[total_rows * LANES + o] = q16;
            continue;
          }
          const int n = n0 + WARP * j;
          if (n >= num_samples) continue;  // the trailing partial row
          const long long o = static_cast<long long>(b) * num_samples + n;
          if (out_bits == 16) {
            const uint32_t pair =
                static_cast<uint32_t>(static_cast<uint16_t>(i16)) |
                (static_cast<uint32_t>(static_cast<uint16_t>(q16)) << 16);
            static_cast<uint32_t*>(out)[o] = pair;
          } else {
            const uint8_t i8 =
                static_cast<uint8_t>(static_cast<int8_t>(i16 >> 4));
            const uint8_t q8 =
                static_cast<uint8_t>(static_cast<int8_t>(q16 >> 4));
            static_cast<uint16_t*>(out)[o] =
                static_cast<uint16_t>(i8 | (static_cast<uint16_t>(q8) << 8));
          }
        }
      }
    }
    seg = seg_end;
  }
}

const void* k1_kernel(int wide) {
  auto kernel = wide ? synth_k1_kernel<true> : synth_k1_kernel<false>;
  return reinterpret_cast<const void*>(kernel);
}

// The rows per block that a launch computes and the grid it takes, after
// the launch's argument checks: with raw, all n_rows rows; else only the
// rows that hold samples (the trailing partial row is masked).
cudaError_t k1_grid(int B, int C, int n_rows, int num_samples, int out_bits,
                    int wide, int raw, int* rows, PersistentGrid* g) {
  if (raw) {
    num_samples = n_rows * LANES;
    out_bits = 16;
  }
  if (B < 1 || B > 65535 || C < 1 || C > MAX_C || n_rows < 1 ||
      num_samples < 1 ||
      static_cast<long long>(n_rows) * LANES < num_samples ||
      (out_bits != 8 && out_bits != 16)) {
    return cudaErrorInvalidValue;
  }
  *rows = raw ? n_rows : (num_samples + LANES - 1) / LANES;
  return persistent_grid(k1_kernel(wide), THREADS, C,
                         static_cast<long long>(B) * *rows, g);
}

}  // namespace

// The grid gpssim_k1_launch takes for these arguments (the same checks):
// the CTAs resident on the current device, the rows it computes over the
// B blocks, the CTAs it launches and the rows per CTA. Returns 0 on
// success, else the CUDA error (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" int gpssim_k1_grid(int B, int C, int n_rows, int num_samples,
                              int out_bits, int wide, int raw, int* resident,
                              long long* total_rows, int* ctas,
                              long long* rows_per_cta) {
  int rows = 0;
  PersistentGrid g;
  const cudaError_t err =
      k1_grid(B, C, n_rows, num_samples, out_bits, wide, raw, &rows, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = g.resident;
  *total_rows = static_cast<long long>(B) * rows;
  *ctas = g.ctas;
  *rows_per_cta = g.per_cta;
  return 0;
}

// Launch K1 on `stream` for B blocks. Every pointer is device memory; `lut`
// is int16[1024] (SIN_TABLE_512 then COS_TABLE_512). With raw == 0, `out`
// is int16[B][2*num_samples] (out_bits 16) or int8[B][2*num_samples] (8)
// and only the rows that hold samples are computed. With raw != 0, `out`
// is int16[2][B][n_rows][128] (the i plane, then the q plane), every one
// of the n_rows rows is computed, and num_samples and out_bits are not
// read. Returns cudaGetLastError() after the launch (0 on success), the
// error of a failed attribute or occupancy query, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int gpssim_k1_launch(
    const void* code_l, long long code_bs, const void* carr_l, long long carr_bs,
    const void* nav, long long nav_bs, const void* lane_steps, long long ls_bs,
    const void* ca_packed, long long ca_bs, const void* gain_a, long long ga_bs,
    const void* gain_b, long long gb_bs, const void* lut, void* out, int B,
    int C, int n_rows, int num_samples, int out_bits, int wide, int raw,
    void* stream) {
  int rows = 0;
  PersistentGrid g;
  const cudaError_t err =
      k1_grid(B, C, n_rows, num_samples, out_bits, wide, raw, &rows, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
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

  auto kernel = wide ? synth_k1_kernel<true> : synth_k1_kernel<false>;
  kernel<<<g.ctas, THREADS, gain_table_bytes(C),
           static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int16_t*>(lut), out, C, rows, num_samples,
      out_bits, raw, static_cast<long long>(B) * rows, g.per_cta);
  return static_cast<int>(cudaGetLastError());
}
