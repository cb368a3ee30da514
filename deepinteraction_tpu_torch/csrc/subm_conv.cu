// K1: gather-GEMM sparse convolution over a COO active set, and the weight
// gradient of its backward.
//
//   subm_conv_gemm:   out[i] = sum_d feat[nbr[i, d]] @ w[d]
//                     (nbr[i, d] outside [0, kin) = miss; out[i] = 0 where
//                     valid[i] == 0)
//   subm_conv_wgrad:  dw[d] = sum_i feat[nbr[i, d]]^T @ dy[i]
//
// The backward's input gradient is subm_conv_gemm itself, run over the
// inverse table (inv[j, d] = i where nbr[i, d] = j) with w[d]^T.
//
// subm_conv_gemm replaces the Pallas kernel deepinteraction_tpu/ops/
// sparse_conv_banded.py::_banded_kernel_call (:98-161, pallas_call :152): a
// one-hot MXU scatter into a VMEM window, planned by make_banded_plan because
// row gathers are slow on a TPU. On Hopper a row gather is a plain load, so
// this is TorchSparse's gather-matmul dataflow with no band plan, no tap
// mirror and no overflow path.
//
// Bound on the H100 at the encoder's 21 convs, counting each input byte
// once and the useful products (2 Cin Cout per hit) at the TF32 tensor-core
// rate of 495 TFLOP/s: the 16- and 32-channel convs (1-6 hits per row on
// the synthetic cloud) are bound by bytes, of which the [Ko, taps] table is
// the largest part (17.3 MB of 37 MB at eval stage 0, 0.011 ms); stage 3
// (30 000 rows, 128 -> 128, 11.4 hits per row) by operations, 0.023 ms. The
// fp32 CUDA-core kernel this replaced re-read one column of the table per
// tap (4 useful bytes a 32-byte sector), gathered with scalar loads, never
// overlapped a tap's gather with the previous tap's math, and multiplied at
// the 67 TFLOP/s fp32 rate.
//
// Design:
// - the block reads its [TM x taps] slab of the table once, contiguously
//   and with 16-byte loads, into shared memory, and lists the taps with a
//   hit in the tile (one warp vote per tap); a tap with none is skipped
//   without touching feat or w, and a warp skips the products of a tap that
//   misses all of its rows. Rows are sorted by site, so the rows of a tile
//   hit nearly the same taps and the skipped work is small;
// - the work is a sequence of stages (listed tap, KC-channel chunk of Cin);
//   each stage gathers TM feat rows by 16-byte cp.async (a miss zero-fills)
//   and copies the [KC x TN] slab of w[d], 2-3 stages in flight ahead of
//   the math, one barrier per stage; the 32- and 64-wide convs take 32
//   channels a stage, which halves their stages;
// - the output tile is accumulated over all taps in registers on the tensor
//   cores (mma.sync m16n8k8) in split TF32 (tf32_mma.cuh), at fp32 accuracy;
//   valid is applied when the tile is written;
// - Cin = 5 (conv_input) is zero-padded to the MMA depth of 8 in shared
//   memory; an odd width or a misaligned pointer takes 4-byte copies;
// - tiles are 64 rows by 16, 32 or 64 output columns (4 warps), or 128 rows
//   by 128 columns (8 warps), the output width rounded up; at most 128
//   registers a thread let 4 blocks of 4 warps or 2 of 8 share an SM, so
//   stage 3's 235 blocks run in one wave on the 132 SMs, and a block copies
//   w once for 128 rows.
//
// What bounds it instead (PERF.md): the three mma.sync products per fp32
// product, which issue at about 320 TFLOP/s of TF32 on an H100 SXM
// (kernel_ab.py --mma-peak), the fragment loads and splits around them, and
// the gathers, which one barrier per stage keeps from overlapping the math
// fully.
//
// The tap count is a runtime argument, so the same kernel runs the 27-tap
// submanifold convs, the 27-tap strided downsample convs and the 3-tap
// conv_out, given the matching neighbor table.

#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// TM rows x TN output columns, WARPS_M x WARPS_N warps, KC input channels a
// stage, STAGES stage buffers (STAGES - 1 in flight ahead of the math)
template <int TM_, int TN_, int WARPS_M_, int WARPS_N_, int KC_, int STAGES_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int KC = KC_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // at most 128 registers a thread
  static constexpr int WM = TM / WARPS_M;  // rows per warp
  static constexpr int WN = TN / WARPS_N;  // columns per warp
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr int AP = KC + 4;        // conflict-free A fragment reads
  static constexpr int BP = TN + 8;        // conflict-free B fragment reads
  static constexpr int STAGE = TM * AP + KC * BP;  // floats
  static_assert(MT * 16 == WM && NT * 8 == WN && WM <= 32, "warp tile");
};

// floats before the first stage buffer: the table, the tap mask and the
// tap walk, 16-byte aligned
__host__ __device__ inline int head_floats(int tm, int taps) {
  return (tm * taps + (taps + 31) / 32 + taps + 1 + 3) / 4 * 4;
}

enum : int { kFeatVec = 1, kWVec = 2, kNbrVec = 4 };

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    subm_conv_gemm_kernel(const float* __restrict__ feat,
                          const int32_t* __restrict__ nbr,
                          const float* __restrict__ w,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ out, int kin, int ko, int taps,
                          int cin, int cout, int flags) {
  constexpr int TM = T::TM, TN = T::TN, KC = T::KC, STAGES = T::STAGES, THREADS = T::THREADS;
  extern __shared__ float4 smem4[];
  int32_t* table = reinterpret_cast<int32_t*>(smem4);  // [TM][taps], -1 = miss
  uint32_t* mask = reinterpret_cast<uint32_t*>(table + TM * taps);  // taps that hit the tile
  // [taps + 1]: the taps that hit the tile, in order, then their count
  int32_t* walk = reinterpret_cast<int32_t*>(mask + (taps + 31) / 32);
  float* stages = reinterpret_cast<float*>(smem4) + head_floats(TM, taps);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / T::WARPS_N;
  const int wn = warp % T::WARPS_N;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;

  // 1. the table slab, read once
  {
    const int n = max(0, min(TM, ko - row0)) * taps;
    const int32_t* src = nbr + (int64_t)row0 * taps;
    auto fix = [&](int v) { return v >= 0 && v < kin ? v : -1; };
    int e0 = 0;
    if (flags & kNbrVec) {  // row0 * taps is a multiple of 4
      e0 = n / 4 * 4;
      for (int e = tid; e < n / 4; e += THREADS) {
        const int4 v = reinterpret_cast<const int4*>(src)[e];
        table[4 * e] = fix(v.x);
        table[4 * e + 1] = fix(v.y);
        table[4 * e + 2] = fix(v.z);
        table[4 * e + 3] = fix(v.w);
      }
    }
    for (int e = e0 + tid; e < TM * taps; e += THREADS) table[e] = e < n ? fix(src[e]) : -1;
    for (int e = tid; e < (taps + 31) / 32; e += THREADS) mask[e] = 0u;
  }
  __syncthreads();
  for (int d = warp; d < taps; d += THREADS / 32) {
    bool hit = false;
    for (int m = lane; m < TM; m += 32) hit |= table[m * taps + d] >= 0;
    if (__any_sync(0xffffffffu, hit) && lane == 0) atomicOr(&mask[d / 32], 1u << (d % 32));
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int d = 0; d < taps; ++d)
      if ((mask[d / 32] >> (d % 32)) & 1u) walk[n++] = d;
    walk[taps] = n;
  }
  __syncthreads();

  // 2. stages s = (hit tap s / nk, chunk s % nk): the loader runs STAGES - 1 ahead
  const int nk = (cin + KC - 1) / KC;
  const int nstage = walk[taps] * nk;
  auto load = [&](int s) {
    const int d = walk[s / nk];
    const int k0 = (s % nk) * KC;
    float* as = stages + (s % STAGES) * T::STAGE;
    float* bs = as + TM * T::AP;
    if (flags & kFeatVec) {
      constexpr int PER = KC / 4;
      for (int e = tid; e < TM * PER; e += THREADS) {
        const int m = e / PER;
        const int cc = (e % PER) * 4;
        const int src = table[m * taps + d];
        const bool ok = src >= 0 && k0 + cc < cin;
        di::cp_async16(as + m * T::AP + cc, ok ? feat + (int64_t)src * cin + k0 + cc : feat, ok);
      }
    } else {
      for (int e = tid; e < TM * KC; e += THREADS) {
        const int m = e / KC;
        const int cc = e % KC;
        const int src = table[m * taps + d];
        const bool ok = src >= 0 && k0 + cc < cin;
        di::cp_async4(as + m * T::AP + cc, ok ? feat + (int64_t)src * cin + k0 + cc : feat, ok);
      }
    }
    const float* wd = w + (int64_t)d * cin * cout;
    if (flags & kWVec) {
      constexpr int PER = TN / 4;
      for (int e = tid; e < KC * PER; e += THREADS) {
        const int kk = e / PER;
        const int nn = (e % PER) * 4;
        const bool ok = k0 + kk < cin && col0 + nn < cout;
        di::cp_async16(bs + kk * T::BP + nn, ok ? wd + (int64_t)(k0 + kk) * cout + col0 + nn : w, ok);
      }
    } else {
      for (int e = tid; e < KC * TN; e += THREADS) {
        const int kk = e / TN;
        const int nn = e % TN;
        const bool ok = k0 + kk < cin && col0 + nn < cout;
        di::cp_async4(bs + kk * T::BP + nn, ok ? wd + (int64_t)(k0 + kk) * cout + col0 + nn : w, ok);
      }
    }
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstage) load(s);
    di::cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    di::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; the previous stage's buffer is free
    if (s + STAGES - 1 < nstage) load(s + STAGES - 1);
    di::cp_async_commit();

    const int d = walk[s / nk];
    bool mine = false;  // does tap d hit any row of this warp?
    for (int m = lane; m < T::WM; m += 32) mine |= table[(wm * T::WM + m) * taps + d] >= 0;
    if (__any_sync(0xffffffffu, mine)) {
      const float* as = stages + (s % STAGES) * T::STAGE + wm * T::WM * T::AP;
      const float* bs = stages + (s % STAGES) * T::STAGE + TM * T::AP + wn * T::WN;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        uint32_t ah[T::MT][4], al[T::MT][4];
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          const float* a = as + (i * 16 + g) * T::AP + kk + t;
          di::split_tf32(a[0], ah[i][0], al[i][0]);
          di::split_tf32(a[8 * T::AP], ah[i][1], al[i][1]);
          di::split_tf32(a[4], ah[i][2], al[i][2]);
          di::split_tf32(a[8 * T::AP + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          const float* b = bs + (kk + t) * T::BP + j * 8 + g;
          uint32_t bh[2], bl[2];
          di::split_tf32(b[0], bh[0], bl[0]);
          di::split_tf32(b[4 * T::BP], bh[1], bl[1]);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) di::mma_split(acc[i][j], ah[i], al[i], bh, bl);
        }
      }
    }
  }
  di::cp_async_wait<0>();

  // 3. epilogue: rows g, g+8 and columns 2t, 2t+1 of each 16 x 8 tile
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm * T::WM + i * 16 + g + 8 * half;
      if (r >= ko) continue;
      const bool keep = valid[r] != 0;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int c = col0 + wn * T::WN + j * 8 + 2 * t;
        const float v0 = keep ? acc[i][j][2 * half] : 0.f;
        const float v1 = keep ? acc[i][j][2 * half + 1] : 0.f;
        float* o = out + (int64_t)r * cout + c;
        if (c + 1 < cout && (cout % 2) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (c < cout) o[0] = v0;
          if (c + 1 < cout) o[1] = v1;
        }
      }
    }
}

template <int TM, int TN, int WARPS_M, int WARPS_N, int KC, int STAGES>
int launch(const float* feat, const int32_t* nbr, const float* w, const uint8_t* valid,
           float* out, int kin, int ko, int taps, int cin, int cout, int flags,
           cudaStream_t stream) {
  using T = Tile<TM, TN, WARPS_M, WARPS_N, KC, STAGES>;
  auto kernel = subm_conv_gemm_kernel<T>;
  const int smem = (head_floats(TM, taps) + STAGES * T::STAGE) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((ko + TM - 1) / TM, (cout + TN - 1) / TN);
  kernel<<<grid, T::THREADS, smem, stream>>>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int launch_kc(const float* feat, const int32_t* nbr, const float* w, const uint8_t* valid,
              float* out, int kin, int ko, int taps, int cin, int cout, int flags,
              cudaStream_t stream) {
  if (cout <= 16) return launch<64, 16, 4, 1, KC, 4>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags, stream);
  if (cout <= 32) return launch<64, 32, 4, 1, KC, 4>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags, stream);
  // 32-channel stages of the 128-wide tile would leave room for only 2
  // blocks an SM: the caller takes KC = 32 only up to 64 output columns
  if constexpr (KC <= 16) {
    if (cout > 64) return launch<128, 128, 4, 2, KC, 3>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags, stream);
  }
  return launch<64, 64, 2, 2, KC, 3>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags, stream);
}

constexpr int kWgThreads = 256;

// subm_conv_wgrad replaces d/dW of the JAX backward,
// deepinteraction_tpu/ops/sparse_conv_banded.py::_banded_bwd (a tap loop of
// XLA row gathers and contractions beside the Pallas kernel's d/dfeat).
//
// Bound on the H100: each (tap, row) pair reads one gathered feat row and one
// dy row and does cin * cout multiply-adds with them; at 16 -> 16 that is 16
// flops per byte read, so the narrow stages are bound by the gathered bytes and
// the 128-wide stage by fp32 arithmetic on CUDA cores. Design: the grid is
// (chunk of row tiles, tap, output tile). A block walks its chunk's tiles of
// kWgRows rows; for each it stages the gathered feat rows (zero for a miss) and
// the dy rows in shared memory and accumulates its [BI, BJ] slice of dw[d] in
// registers (an RI x RJ micro-tile per thread). A tile whose rows all miss at
// tap d is skipped without touching feat or dy: the synthetic stage-0 table
// hits about 1.1 of 27 taps per row. Each block writes one partial; a second
// pass sums the partials in chunk order, so the result is deterministic (fp32
// atomics would not be).
constexpr int kWgRows = 64;

template <int BI, int BJ>
__global__ void __launch_bounds__(kWgThreads)
    subm_conv_wgrad_kernel(const float* __restrict__ feat,
                           const int32_t* __restrict__ nbr,
                           const float* __restrict__ dy,
                           float* __restrict__ partial, int kin, int ko,
                           int taps, int cin, int cout, int tiles_per_block) {
  constexpr int TJ = 16;  // threads across dw columns (cout)
  constexpr int TI = kWgThreads / TJ;  // threads across dw rows (cin)
  constexpr int RI = BI / TI;
  constexpr int RJ = BJ / TJ;
  static_assert(RI * TI == BI && RJ * TJ == BJ, "tile must cover the threads");
  __shared__ int32_t src[kWgRows];
  __shared__ float as[kWgRows][BI];
  __shared__ float bs[kWgRows][BJ];

  const int chunk = blockIdx.x;
  const int d = blockIdx.y;
  const int n_jt = (cout + BJ - 1) / BJ;
  const int i0 = (blockIdx.z / n_jt) * BI;
  const int j0 = (blockIdx.z % n_jt) * BJ;
  const int tid = threadIdx.x;
  const int tx = tid % TJ;
  const int ty = tid / TJ;
  float acc[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = (ko + kWgRows - 1) / kWgRows;
  const int t_end = min(n_tiles, (chunk + 1) * tiles_per_block);
  for (int t = chunk * tiles_per_block; t < t_end; ++t) {
    const int row0 = t * kWgRows;
    int hit = 0;
    for (int m = tid; m < kWgRows; m += kWgThreads) {
      const int r = row0 + m;
      const int idx = r < ko ? nbr[(int64_t)r * taps + d] : -1;
      const bool ok = idx >= 0 && idx < kin;
      src[m] = ok ? idx : -1;
      hit |= ok;
    }
    // doubles as the barrier that publishes src[]
    if (!__syncthreads_or(hit)) continue;

    for (int e = tid; e < kWgRows * BI; e += kWgThreads) {
      const int m = e / BI;
      const int ii = e % BI;
      const int s = src[m];
      as[m][ii] = (s >= 0 && i0 + ii < cin) ? feat[(int64_t)s * cin + i0 + ii] : 0.f;
    }
    for (int e = tid; e < kWgRows * BJ; e += kWgThreads) {
      const int m = e / BJ;
      const int jj = e % BJ;
      bs[m][jj] = (src[m] >= 0 && j0 + jj < cout)
                      ? dy[(int64_t)(row0 + m) * cout + j0 + jj]
                      : 0.f;
    }
    __syncthreads();
    for (int m = 0; m < kWgRows; ++m) {
      float a[RI], b[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = as[m][ty + i * TI];
#pragma unroll
      for (int j = 0; j < RJ; ++j) b[j] = bs[m][tx + j * TJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* p = partial + ((int64_t)chunk * taps + d) * cin * cout;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int ci = i0 + ty + i * TI;
    if (ci >= cin) continue;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int cj = j0 + tx + j * TJ;
      if (cj < cout) p[(int64_t)ci * cout + cj] = acc[i][j];
    }
  }
}

// out[e] = sum_c partial[c, e], in chunk order
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int chunks,
                                    int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(int64_t)c * n + e];
  out[e] = s;
}

template <int BI, int BJ>
void launch_wgrad(const float* feat, const int32_t* nbr, const float* dy,
                  float* partial, int kin, int ko, int taps, int cin, int cout,
                  int chunks, cudaStream_t stream) {
  const int n_tiles = (ko + kWgRows - 1) / kWgRows;
  const int per_block = (n_tiles + chunks - 1) / chunks;
  const int out_tiles = ((cin + BI - 1) / BI) * ((cout + BJ - 1) / BJ);
  dim3 grid(chunks, taps, out_tiles);
  subm_conv_wgrad_kernel<BI, BJ><<<grid, kWgThreads, 0, stream>>>(
      feat, nbr, dy, partial, kin, ko, taps, cin, cout, per_block);
}

}  // namespace

extern "C" int di_subm_conv_gemm(const void* feat, const void* nbr,
                                 const void* w, const void* valid, void* out,
                                 int kin, int ko, int taps, int cin, int cout,
                                 void* stream) {
  if (ko <= 0 || cout <= 0) return 0;
  if (cin <= 0) taps = 0;  // nothing to sum: the output is zero
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int flags = (cin % 4 == 0 && aligned(feat) ? kFeatVec : 0) |
                    (cout % 4 == 0 && aligned(w) ? kWVec : 0) | (aligned(nbr) ? kNbrVec : 0);
  const float* f = static_cast<const float*>(feat);
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const float* wt = static_cast<const float*>(w);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin <= 8) return launch_kc<8>(f, n, wt, v, o, kin, ko, taps, cin, cout, flags, s);
  if (cin <= 16 || cout > 64) return launch_kc<16>(f, n, wt, v, o, kin, ko, taps, cin, cout, flags, s);
  return launch_kc<32>(f, n, wt, v, o, kin, ko, taps, cin, cout, flags, s);
}

extern "C" int di_subm_conv_wgrad(const void* feat, const void* nbr,
                                  const void* dy, void* partial, void* out,
                                  int kin, int ko, int taps, int cin, int cout,
                                  int chunks, void* stream) {
  const int64_t n = (int64_t)taps * cin * cout;
  if (n <= 0) return 0;
  const float* f = static_cast<const float*>(feat);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const float* g = static_cast<const float*>(dy);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ko > 0 && chunks > 0) {
    const int width = cin > cout ? cin : cout;
    if (width <= 16) {
      launch_wgrad<16, 16>(f, nb, g, part, kin, ko, taps, cin, cout, chunks, s);
    } else if (width <= 32) {
      launch_wgrad<32, 32>(f, nb, g, part, kin, ko, taps, cin, cout, chunks, s);
    } else {
      launch_wgrad<64, 64>(f, nb, g, part, kin, ko, taps, cin, cout, chunks, s);
    }
  } else {
    chunks = 0;
  }
  const int threads = 256;
  sum_partials_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      part, static_cast<float*>(out), chunks, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* di_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
