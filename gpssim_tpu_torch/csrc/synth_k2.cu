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
// What bounds it on this card: integer ALU throughput, as for K1. The
// stage-B loop costs 36 int32 operations per channel-sample
// (csrc/stage_b.cuh, shared with K1): at 12 channels, 25 blocks and 2368
// rows of 128 samples that is ~3.3 G operations, ~0.1 ms at the card's
// int32 issue rate, while the bytes moved (30.3 MB of packed bases in,
// 30.3 MB of raw rows out) take ~0.02 ms at 3.35 TB/s. So it reads each
// packed row once, coalesced (a row is 512 contiguous bytes), into shared
// memory, keeps the per-channel inputs and the two carrier tables there,
// sums the channels in registers, and stores one int16 i and one int16 q
// per sample.
//
// Grid: (row tiles, blocks). A CTA owns ROWS_PER_CTA rows of one block and
// computes all of them (the padded rows too, as the TPU kernel does).

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_b.cuh"

namespace {

using namespace gpssim;

constexpr int ROWS_PER_CTA = 16;
constexpr int THREADS = 256;  // two rows of 128 lanes per pass

struct K2Args {
  const int32_t* packed;      // [B][n_rows][128], contiguous
  const int32_t* lane_steps;  // [B][4][C], block stride ls_bs
  const int32_t* gain_a;      // [B][C]
  const int32_t* gain_b;      // [B][C]
  long long ls_bs, ga_bs, gb_bs;
};

// Stage-B view of one packed row in shared memory.
struct PackedRow {
  const uint32_t* row;
  int C;
  __device__ __forceinline__ uint32_t operator()(int c, int k) const {
    return row[k * C + c];
  }
};

__global__ void __launch_bounds__(THREADS)
synth_k2_kernel(K2Args a, const int16_t* __restrict__ lut,
                int16_t* __restrict__ i_rows, int16_t* __restrict__ q_rows,
                int C, int n_rows, int wide) {
  __shared__ StageBShared s;
  __shared__ uint32_t s_rows[ROWS_PER_CTA][LANES];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * ROWS_PER_CTA;
  const int tid = threadIdx.x;
  const int n_win = wide ? 4 : 2;
  const int rows_here = min(ROWS_PER_CTA, n_rows - row0);

  stage_b_load(s, lut, a.lane_steps + b * a.ls_bs, a.gain_a + b * a.ga_bs,
               a.gain_b + b * a.gb_bs, C, tid, THREADS);
  // the CTA's rows of packed bases: consecutive threads, consecutive words
  const long long tile = (static_cast<long long>(b) * n_rows + row0) * LANES;
  const int32_t* src = a.packed + tile;
  for (int i = tid; i < rows_here * LANES; i += THREADS) {
    s_rows[i / LANES][i % LANES] = static_cast<uint32_t>(src[i]);
  }
  __syncthreads();

  const uint32_t lane = static_cast<uint32_t>(tid & (LANES - 1));
  for (int rr = tid / LANES; rr < rows_here; rr += THREADS / LANES) {
    int32_t i_acc, q_acc;
    stage_b_sample(s, PackedRow{s_rows[rr], C}, lane, C, n_win, i_acc, q_acc);
    const long long o = tile + static_cast<long long>(rr) * LANES + lane;
    i_rows[o] = static_cast<int16_t>(i_acc);
    q_rows[o] = static_cast<int16_t>(q_acc);
  }
}

}  // namespace

// Launch K2 on `stream` for B blocks of n_rows rows. Every pointer is
// device memory: `packed` int32[B][n_rows][128] (contiguous), lane_steps
// int32[B][4][C], gain_a and gain_b int32[B][C] (contiguous within a
// block, block strides as given), `lut` int16[1024] (SIN_TABLE_512 then
// COS_TABLE_512), `i_rows` and `q_rows` int16[B][n_rows][128]. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
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
  dim3 grid((n_rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA, B);
  synth_k2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int16_t*>(lut), static_cast<int16_t*>(i_rows),
      static_cast<int16_t*>(q_rows), C, n_rows, wide);
  return static_cast<int>(cudaGetLastError());
}
