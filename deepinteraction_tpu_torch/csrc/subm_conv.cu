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
//
// Gated launches (entry di_subm_conv_gemm_gated): the kernel runs only where
// the device byte *gate is set and adds one to *taken when it does, so a
// caller can launch it beside K1's bf16 variant (subm_conv_bf16.cu, which
// runs where *gate is clear) and let a flag on the card pick the conv's
// numerics without a host sync: the banded plan's overflow fallback to fp32
// (deepinteraction_tpu/ops/sparse_conv_banded.py:189-194).

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
                          int cin, int cout, int flags,
                          const uint8_t* __restrict__ gate, int* __restrict__ taken) {
  if (gate != nullptr && *gate == 0) return;  // K1's bf16 variant computes this conv
  constexpr int TM = T::TM, TN = T::TN, KC = T::KC, STAGES = T::STAGES, THREADS = T::THREADS;
  if (taken != nullptr && threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) *taken += 1;
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

// the gate of a gated launch, null otherwise
struct Gate {
  const uint8_t* gate;
  int* taken;
};

template <int TM, int TN, int WARPS_M, int WARPS_N, int KC, int STAGES>
int launch(const float* feat, const int32_t* nbr, const float* w, const uint8_t* valid,
           float* out, int kin, int ko, int taps, int cin, int cout, int flags,
           Gate gate, cudaStream_t stream) {
  using T = Tile<TM, TN, WARPS_M, WARPS_N, KC, STAGES>;
  auto kernel = subm_conv_gemm_kernel<T>;
  const int smem = (head_floats(TM, taps) + STAGES * T::STAGE) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((ko + TM - 1) / TM, (cout + TN - 1) / TN);
  kernel<<<grid, T::THREADS, smem, stream>>>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags,
                                             gate.gate, gate.taken);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int launch_kc(const float* feat, const int32_t* nbr, const float* w, const uint8_t* valid,
              float* out, int kin, int ko, int taps, int cin, int cout, int flags,
              Gate gate, cudaStream_t stream) {
  if (cout <= 16) return launch<64, 16, 4, 1, KC, 4>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags, gate, stream);
  if (cout <= 32) return launch<64, 32, 4, 1, KC, 4>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags, gate, stream);
  // 32-channel stages of the 128-wide tile would leave room for only 2
  // blocks an SM: the caller takes KC = 32 only up to 64 output columns
  if constexpr (KC <= 16) {
    if (cout > 64) return launch<128, 128, 4, 2, KC, 3>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags, gate, stream);
  }
  return launch<64, 64, 2, 2, KC, 3>(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, flags, gate, stream);
}

// subm_conv_wgrad replaces d/dW of the JAX backward,
// deepinteraction_tpu/ops/sparse_conv_banded.py::_banded_bwd (:234-249, a tap
// loop of XLA row gathers and contractions beside the Pallas kernel's
// d/dfeat): dw[d] = sum_i feat[nbr[i, d]]^T @ dy[i], per tap a GEMM with
// M = Cin, N = Cout and the table's rows as its depth.
//
// Bound on the H100: each (tap, row) pair with a hit reads one gathered feat
// row and one dy row and does 2 cin cout operations with them. At the TF32
// tensor-core rate only train stage 3 (29 500 rows, 128 -> 128, 11.4 hits per
// row) is bound by operations, 0.022 ms; the other convs by bytes, most of
// them the table's.
//
// Design:
// - grid (chunk of rows, tap, output tile); a block writes one partial
//   [cin, cout] slice and sum_partials_kernel adds the partials in chunk
//   order: no atomics, so two calls give the same bits;
// - a block reads its chunk's column of the table once (up to 32 tiles of
//   32 rows), lists the tiles with a hit at its tap and walks only those; a
//   warp skips the 8-row k-steps in which no row hits;
// - each listed tile is staged by cp.async, the feat rows gathered (a miss
//   zero-fills its feat row and its dy row, neither is read), STAGES - 1
//   tiles in flight ahead of the math, one barrier a tile;
// - the products run on the tensor cores, mma.sync m16n8k8 in split TF32
//   (tf32_mma.cuh) at fp32 accuracy: A[m][k] = feat tile[row k][ci m], the
//   staged tile read transposed, and B[k][n] = dy tile[row k][co n]; a pitch
//   of width + 8 floats makes both fragment reads conflict-free;
// - the output tile is square, by the larger width: 128 x 128 with 8 warps of
//   32 x 64 above 64 channels (each row of stage 3, conv_out and down2's dy is
//   staged once per tap), 64 x 64 and 32 x 32 with 4 warps, and 16 x 16 with
//   4 warps that each take their own k-steps of a tile and are summed in warp
//   order at the end. A warp whose part of the tile lies past cin or cout
//   (down0-2, conv_input) skips its products.
//
// What bounds it instead (PERF.md): the three mma.sync products per fp32
// product, taken over every row of an 8-row step with a hit, missed rows
// included (58 % of the row-tap pairs miss at stage 3); at 16 and 32
// columns, the latency of the strided table reads and the row gathers.
constexpr int kWgRows = 32;    // rows a tile: one lane of a warp per row
constexpr int kWgMaxTiles = 32;  // tiles a block walks at most (1024 rows)

// B x B output tile; WARPS_M x WARPS_N warps across it, WARPS_K warps across
// each tile's k-steps; STAGES tile buffers
template <int B_, int WARPS_M_, int WARPS_N_, int WARPS_K_, int STAGES_>
struct WgTile {
  static constexpr int B = B_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, WARPS_K = WARPS_K_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N * WARPS_K;
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // at most 128 registers a thread
  static constexpr int WM = B / WARPS_M;  // cin per warp
  static constexpr int WN = B / WARPS_N;  // cout per warp
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr int P = B + 8;  // 8 or 24 mod 32: conflict-free fragment reads
  static constexpr int STAGE = 2 * kWgRows * P;  // floats: the feat tile, then the dy tile
  // the loader's loops: unrolled at 16 columns, where the loads bound the
  // kernel; rolled above, where the unrolled address arithmetic beside the
  // accumulators spilled at 128 registers
  static constexpr int LOAD_UNROLL = B == 16 ? 4 : 1;
  // floats before the first stage buffer: the column of the table, the hit
  // flags, the list of hit tiles and its length, 16-byte aligned
  static constexpr int HEAD = (kWgMaxTiles * kWgRows + 2 * kWgMaxTiles + 1 + 3) / 4 * 4;
  static_assert(MT * 16 == WM && NT * 8 == WN, "warp tile");
  static_assert((kWgRows / 8) % WARPS_K == 0, "k-steps per warp");
  static_assert(kWgRows == 32 && kWgMaxTiles == 32, "one lane per row and per tile");
};

enum : int { kWgFeatVec = 1, kWgDyVec = 2 };

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    subm_conv_wgrad_kernel(const float* __restrict__ feat,
                           const int32_t* __restrict__ nbr,
                           const float* __restrict__ dy,
                           float* __restrict__ partial, int kin, int ko,
                           int taps, int cin, int cout, int tiles_per_block,
                           int flags) {
  constexpr int B = T::B, P = T::P, RT = kWgRows, STAGES = T::STAGES, THREADS = T::THREADS;
  extern __shared__ float4 smem4[];
  int32_t* src = reinterpret_cast<int32_t*>(smem4);  // [block rows]: feat row, -1 = miss
  int32_t* hit = src + kWgMaxTiles * RT;             // [tiles]: the tile has a hit
  int32_t* list = hit + kWgMaxTiles;                 // [tiles + 1]: hit tiles in order, then their count
  float* stages = reinterpret_cast<float*>(smem4) + T::HEAD;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wk = T::WARPS_K == 1 ? 0 : warp / (T::WARPS_M * T::WARPS_N);
  const int wm = (warp / T::WARPS_N) % T::WARPS_M;
  const int wn = warp % T::WARPS_N;
  const int chunk = blockIdx.x;
  const int d = blockIdx.y;
  const int n_jt = (cout + B - 1) / B;
  const int i0 = (blockIdx.z / n_jt) * B;
  const int j0 = (blockIdx.z % n_jt) * B;
  const bool active = i0 + wm * T::WM < cin && j0 + wn * T::WN < cout;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // 1. the block's column of the table (its chunk's tiles, at most
  // kWgMaxTiles), and the tiles with a hit
  const int n_tiles = (ko + RT - 1) / RT;
  const int w0 = chunk * tiles_per_block;
  const int nt = min(n_tiles, w0 + tiles_per_block) - w0;
  if (tid < kWgMaxTiles) hit[tid] = 0;
  __syncthreads();
  for (int e = tid; e < nt * RT; e += THREADS) {
    const int r = w0 * RT + e;
    const int idx = r < ko ? nbr[(int64_t)r * taps + d] : -1;
    const bool ok = idx >= 0 && idx < kin;
    src[e] = ok ? idx : -1;
    if (ok) hit[e / RT] = 1;  // every writer stores the same value
  }
  __syncthreads();
  if (warp == 0) {
    const bool h = lane < nt && hit[lane] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, h);
    if (h) list[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) list[kWgMaxTiles] = __popc(mask);
  }
  __syncthreads();
  const int n = list[kWgMaxTiles];

  // 2. the listed tiles: the loader runs STAGES - 1 ahead of the math
  auto load = [&](int s) {
    const int lt = list[s];
    const int32_t* rows = src + lt * RT;
    const int64_t row0 = (int64_t)(w0 + lt) * RT;
    float* as = stages + (s % STAGES) * T::STAGE;
    float* bs = as + RT * P;
    if (flags & kWgFeatVec) {
#pragma unroll(T::LOAD_UNROLL)
      for (int e = tid; e < RT * B / 4; e += THREADS) {
        const int m = e / (B / 4);
        const int c = (e % (B / 4)) * 4;
        const int sr = rows[m];
        const bool ok = sr >= 0 && i0 + c < cin;
        di::cp_async16(as + m * P + c, ok ? feat + (int64_t)sr * cin + i0 + c : feat, ok);
      }
    } else {
#pragma unroll(T::LOAD_UNROLL)
      for (int e = tid; e < RT * B; e += THREADS) {
        const int m = e / B;
        const int c = e % B;
        const int sr = rows[m];
        const bool ok = sr >= 0 && i0 + c < cin;
        di::cp_async4(as + m * P + c, ok ? feat + (int64_t)sr * cin + i0 + c : feat, ok);
      }
    }
    if (flags & kWgDyVec) {
#pragma unroll(T::LOAD_UNROLL)
      for (int e = tid; e < RT * B / 4; e += THREADS) {
        const int m = e / (B / 4);
        const int c = (e % (B / 4)) * 4;
        const bool ok = rows[m] >= 0 && j0 + c < cout;
        di::cp_async16(bs + m * P + c, ok ? dy + (row0 + m) * cout + j0 + c : dy, ok);
      }
    } else {
#pragma unroll(T::LOAD_UNROLL)
      for (int e = tid; e < RT * B; e += THREADS) {
        const int m = e / B;
        const int c = e % B;
        const bool ok = rows[m] >= 0 && j0 + c < cout;
        di::cp_async4(bs + m * P + c, ok ? dy + (row0 + m) * cout + j0 + c : dy, ok);
      }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s);
    di::cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    di::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile s landed; the buffer of tile s - 1 is free
    if (s + STAGES - 1 < n) load(s + STAGES - 1);
    di::cp_async_commit();

    // the rows of tile s that hit tap d, one bit each
    const unsigned rows_hit = __ballot_sync(0xffffffffu, src[list[s] * RT + lane] >= 0);
    if (active) {
      const float* as = stages + (s % STAGES) * T::STAGE + wm * T::WM;
      const float* bs = stages + (s % STAGES) * T::STAGE + RT * P + wn * T::WN;
#pragma unroll
      for (int ks = wk; ks < RT / 8; ks += T::WARPS_K) {
        if (((rows_hit >> (8 * ks)) & 0xffu) == 0u) continue;
        const float* a = as + (8 * ks + t) * P + g;
        uint32_t ah[T::MT][4], al[T::MT][4];
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          di::split_tf32(a[i * 16], ah[i][0], al[i][0]);
          di::split_tf32(a[i * 16 + 8], ah[i][1], al[i][1]);
          di::split_tf32(a[4 * P + i * 16], ah[i][2], al[i][2]);
          di::split_tf32(a[4 * P + i * 16 + 8], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          const float* b = bs + (8 * ks + t) * P + j * 8 + g;
          uint32_t bh[2], bl[2];
          di::split_tf32(b[0], bh[0], bl[0]);
          di::split_tf32(b[4 * P], bh[1], bl[1]);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) di::mma_split(acc[i][j], ah[i], al[i], bh, bl);
        }
      }
    }
  }
  di::cp_async_wait<0>();

  // 3. warps that took other k-steps of the same part of the tile: summed in
  // warp order through shared memory
  if constexpr (T::WARPS_K > 1) {
    constexpr int ACC = T::MT * T::NT * 4;
    constexpr int PARTS = T::WARPS_M * T::WARPS_N;
    const int part = warp % PARTS;
    float* red = stages;
    __syncthreads();  // every warp is done with the stages
    if (wk > 0) {
      float* r = red + ((wk - 1) * PARTS + part) * ACC * 32 + lane;
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[((i * T::NT + j) * 4 + e) * 32] = acc[i][j][e];
    }
    __syncthreads();
    if (wk > 0) return;
    for (int k = 1; k < T::WARPS_K; ++k) {
      const float* r = red + ((k - 1) * PARTS + part) * ACC * 32 + lane;
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += r[((i * T::NT + j) * 4 + e) * 32];
    }
  }

  // 4. the block's partial: rows g, g+8 (cin) and columns 2t, 2t+1 (cout) of
  // each 16 x 8 tile
  float* p = partial + ((int64_t)chunk * taps + d) * cin * cout;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = i0 + wm * T::WM + i * 16 + g + 8 * half;
      if (ci >= cin) continue;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int co = j0 + wn * T::WN + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * half];
        const float v1 = acc[i][j][2 * half + 1];
        float* o = p + (int64_t)ci * cout + co;
        if (co + 1 < cout && (cout % 2) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (co < cout) o[0] = v0;
          if (co + 1 < cout) o[1] = v1;
        }
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

template <class T>
int launch_wgrad(const float* feat, const int32_t* nbr, const float* dy,
                 float* partial, int kin, int ko, int taps, int cin, int cout,
                 int chunks, int flags, cudaStream_t stream) {
  auto kernel = subm_conv_wgrad_kernel<T>;
  const int smem = (T::HEAD + T::STAGES * T::STAGE) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (ko + kWgRows - 1) / kWgRows;
  const int per_block = (n_tiles + chunks - 1) / chunks;
  // a block walks at most kWgMaxTiles tiles: chunks of up to kWgMaxTiles *
  // kWgRows rows, as the caller's partial buffer is sized
  if (per_block > kWgMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  const int out_tiles = ((cin + T::B - 1) / T::B) * ((cout + T::B - 1) / T::B);
  dim3 grid(chunks, taps, out_tiles);
  kernel<<<grid, T::THREADS, smem, stream>>>(feat, nbr, dy, partial, kin, ko, taps, cin, cout, per_block, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

int subm_conv_gemm_entry(const void* feat, const void* nbr, const void* w, const void* valid,
                         void* out, int kin, int ko, int taps, int cin, int cout, Gate gate,
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
  if (cin <= 8) return launch_kc<8>(f, n, wt, v, o, kin, ko, taps, cin, cout, flags, gate, s);
  if (cin <= 16 || cout > 64) return launch_kc<16>(f, n, wt, v, o, kin, ko, taps, cin, cout, flags, gate, s);
  return launch_kc<32>(f, n, wt, v, o, kin, ko, taps, cin, cout, flags, gate, s);
}

}  // namespace

extern "C" int di_subm_conv_gemm(const void* feat, const void* nbr,
                                 const void* w, const void* valid, void* out,
                                 int kin, int ko, int taps, int cin, int cout,
                                 void* stream) {
  return subm_conv_gemm_entry(feat, nbr, w, valid, out, kin, ko, taps, cin, cout, Gate{nullptr, nullptr},
                              stream);
}

// the same, run only where the device byte *gate is set; *taken (a device
// int) counts the launches that ran
extern "C" int di_subm_conv_gemm_gated(const void* feat, const void* nbr,
                                       const void* w, const void* valid, void* out,
                                       int kin, int ko, int taps, int cin, int cout,
                                       const void* gate, void* taken, void* stream) {
  return subm_conv_gemm_entry(feat, nbr, w, valid, out, kin, ko, taps, cin, cout,
                              Gate{static_cast<const uint8_t*>(gate), static_cast<int*>(taken)}, stream);
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
    auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    const int flags = (cin % 4 == 0 && aligned(feat) ? kWgFeatVec : 0) | (cout % 4 == 0 && aligned(dy) ? kWgDyVec : 0);
    const int width = cin > cout ? cin : cout;
    int err;
    if (width <= 16) {
      err = launch_wgrad<WgTile<16, 1, 1, 4, 4>>(f, nb, g, part, kin, ko, taps, cin, cout, chunks, flags, s);
    } else if (width <= 32) {
      err = launch_wgrad<WgTile<32, 2, 2, 1, 3>>(f, nb, g, part, kin, ko, taps, cin, cout, chunks, flags, s);
    } else if (width <= 64) {
      err = launch_wgrad<WgTile<64, 2, 2, 1, 3>>(f, nb, g, part, kin, ko, taps, cin, cout, chunks, flags, s);
    } else {
      err = launch_wgrad<WgTile<128, 4, 2, 1, 3>>(f, nb, g, part, kin, ko, taps, cin, cout, chunks, flags, s);
    }
    if (err != 0) return err;
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
