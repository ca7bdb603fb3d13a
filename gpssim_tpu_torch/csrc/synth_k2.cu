// K2: stage B of GPS L1 C/A block synthesis over packed bases, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _synth_tile_kernel
// (gpssim_tpu/ops/synth_pallas.py:356), launched by _stage_b_pallas_packed
// (:396) on the two-stage path (GPSSIM_FUSE_A=0). Its input is the
// lane-packed bases array that the producer computes
// (gpssim_tpu_torch/ops/synth_torch.py:row_bases_packed, the counterpart of
// the JAX package's row_bases_packed): int32 [B][R_pad][128], name-major on
// the lane axis (lane = name_idx*C + c; names f_hi, f_lo, c_hi, c_lo, sA,
// sB, then sC, sD for the 128-chip window). Its outputs are the raw rows
// before the finalize: the int32 channel sum of each sample cast to int16,
// an i plane and a q plane, each [B][R_pad][128]. The plain PyTorch version
// is synth_torch.py:stage_b_packed_torch; the two agree byte for byte.
//
// What bounds it on this card: the integer pipes of the stage-B loop
// (csrc/stage_b.cuh, shared with K1): 16 integer operations and one 64-bit
// shared gather per channel-sample, ~1.5 G operations at 12 channels, 25
// blocks and 2368 rows of 128 samples. The compiled loop issues ~20
// instructions per channel-sample, ~12 of them on the integer ALU pipe,
// which takes 16 lanes per clock per SM partition and sets the pace. The
// bytes moved (30.3 MB of packed bases in, 30.3 MB of raw rows out) take
// ~0.02 ms at 3.35 TB/s.
// The loop reads each per-(row, channel) value once per four samples and
// one folded table entry per sample (see stage_b.cuh).
//
// Grid: persistent (csrc/persistent_grid.cuh, shared with K1). As many CTAs
// as fit on the card at once (the SM count times the occupancy at this
// launch's shared memory, queried once per kernel, device and channel
// count), each owning one
// contiguous range of the B*R_pad rows, so every CTA gets the same number
// of rows and no wave runs part-empty. A CTA builds the gain-folded tables
// of each block its range touches (one or two), then each warp takes one
// row at a time: it reads the row's 512 bytes coalesced (prefetching the
// next row into registers while it computes), scatters the name-major
// lanes into a channel-major slot of its own in shared memory (the layout
// K1's stage A writes, so one loop serves both), and runs the loop over
// that slot. Every row is computed, the padded rows too, as the TPU kernel
// computes them. Measured against 16-, 32- and 64-row tiles (one CTA,
// and one table build, per tile) and against 256 threads per CTA, the
// persistent grid of 512-thread CTAs was the fastest (PERF.md).
// ptxas (sm_90a): 51 registers (55 for the 128-chip window), 8,448 bytes
// of static shared memory plus the C x 4 KB tables, no stack, no spills:
// two CTAs (32 warps) per SM at 12 channels and at 16, so 264 CTAs on
// the card's 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "persistent_grid.cuh"
#include "stage_b.cuh"

namespace {

using namespace gpssim;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / WARP;  // one row per warp at a time

struct K2Args {
  const int32_t* packed;      // [B][n_rows][128], contiguous
  const int32_t* lane_steps;  // [B][4][C], block stride ls_bs
  const int32_t* gain_a;      // [B][C]
  const int32_t* gain_b;      // [B][C]
  long long ls_bs, ga_bs, gb_bs;
};

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
synth_k2_kernel(K2Args a, const int16_t* __restrict__ lut,
                int16_t* __restrict__ i_rows, int16_t* __restrict__ q_rows,
                int C, int n_rows, long long total_rows,
                long long rows_per_cta) {
  extern __shared__ int2 s_tab[];  // [C][512], gain_table_bytes(C)
  __shared__ int4 s_ls[MAX_C];
  __shared__ __align__(16) uint32_t s_row[WARPS][MAX_C][N_BASE];

  const int tid = threadIdx.x;
  const int warp = tid / WARP;
  const uint32_t lane = static_cast<uint32_t>(tid % WARP);
  constexpr int n_names = WIDE ? 8 : 6;

  // where this thread's four words of a packed row go in its warp's slot:
  // lane L = name*C + c → s_row[warp][c][name]; -1 past the last name
  int dst[SAMPLES];
#pragma unroll
  for (int j = 0; j < SAMPLES; ++j) {
    const int L = static_cast<int>(lane) + WARP * j;
    const int name = L / C;
    dst[j] = name < n_names ? (L - name * C) * N_BASE + name : -1;
  }
  uint32_t* slot = &s_row[warp][0][0];

  const long long first = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long last = min(first + rows_per_cta, total_rows);
  for (long long seg = first; seg < last;) {
    // the rows of one block: [seg, seg_end)
    const int b = static_cast<int>(seg / n_rows);
    const long long seg_end =
        min(last, static_cast<long long>(b + 1) * n_rows);
    __syncthreads();  // every warp is done with the previous block's tables
    build_gain_tables(s_tab, s_ls, lut, a.lane_steps + b * a.ls_bs,
                      a.gain_a + b * a.ga_bs, a.gain_b + b * a.gb_bs, C, tid,
                      THREADS);
    __syncthreads();

    long long r = seg + warp;
    uint32_t w[SAMPLES];
    if (r < seg_end) {
#pragma unroll
      for (int j = 0; j < SAMPLES; ++j) {
        w[j] = static_cast<uint32_t>(a.packed[r * LANES + lane + WARP * j]);
      }
    }
    for (; r < seg_end; r += WARPS) {
      __syncwarp();  // the warp is done reading its slot's previous row
#pragma unroll
      for (int j = 0; j < SAMPLES; ++j) {
        if (dst[j] >= 0) slot[dst[j]] = w[j];
      }
      __syncwarp();
      const long long next = r + WARPS;
      if (next < seg_end) {
#pragma unroll
        for (int j = 0; j < SAMPLES; ++j) {
          w[j] = static_cast<uint32_t>(
              a.packed[next * LANES + lane + WARP * j]);
        }
      }
      uint32_t i_acc[SAMPLES], q_acc[SAMPLES];
      stage_b_row<WIDE>(s_tab, s_ls, s_row[warp], lane, C, i_acc, q_acc);
#pragma unroll
      for (int j = 0; j < SAMPLES; ++j) {
        const long long o = r * LANES + lane + WARP * j;
        i_rows[o] = static_cast<int16_t>(i_acc[j]);
        q_rows[o] = static_cast<int16_t>(q_acc[j]);
      }
    }
    seg = seg_end;
  }
}

}  // namespace

// Launch K2 on `stream` for B blocks of n_rows rows. Every pointer is
// device memory: `packed` int32[B][n_rows][128] (contiguous), lane_steps
// int32[B][4][C], gain_a and gain_b int32[B][C] (contiguous within a
// block, block strides as given), `lut` int16[1024] (SIN_TABLE_512 then
// COS_TABLE_512), `i_rows` and `q_rows` int16[B][n_rows][128]. Returns
// cudaGetLastError() after the launch (0 on success), the error of a
// failed attribute or occupancy query, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int gpssim_k2_launch(const void* packed, const void* lane_steps,
                                long long ls_bs, const void* gain_a,
                                long long ga_bs, const void* gain_b,
                                long long gb_bs, const void* lut, void* i_rows,
                                void* q_rows, int B, int C, int n_rows,
                                int wide, void* stream) {
  const int n_names = wide ? 8 : 6;
  if (B < 1 || B > 65535 || C < 1 || C > MAX_C || n_names * C > LANES ||
      n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K2Args a;
  a.packed = static_cast<const int32_t*>(packed);
  a.lane_steps = static_cast<const int32_t*>(lane_steps);
  a.gain_a = static_cast<const int32_t*>(gain_a);
  a.gain_b = static_cast<const int32_t*>(gain_b);
  a.ls_bs = ls_bs;
  a.ga_bs = ga_bs;
  a.gb_bs = gb_bs;

  auto kernel = wide ? synth_k2_kernel<true> : synth_k2_kernel<false>;
  const long long total = static_cast<long long>(B) * n_rows;
  PersistentGrid g;
  const cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(kernel), THREADS, C, total, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g.ctas, THREADS, gain_table_bytes(C),
           static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int16_t*>(lut), static_cast<int16_t*>(i_rows),
      static_cast<int16_t*>(q_rows), C, n_rows, total, g.per_cta);
  return static_cast<int>(cudaGetLastError());
}
