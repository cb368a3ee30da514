// K1's bf16 variant: the gather-GEMM sparse convolution on bf16 operands
// (subm_conv.cu has the fp32 kernel and the layout of the table).
//
//   out[i] = sum_d R( sum_c feat[nbr[i, d], c] * wt[d, :, c] )
//
// with feat and wt already bf16, every inner sum in fp32, R the rounding of
// a tap's product to bf16 (nearest, ties to even) when per_tap is set and
// nothing otherwise, the outer sum in fp32, and out[i] = 0 where valid[i] is
// 0. With per_tap it computes what the Pallas kernel deepinteraction_tpu/
// ops/sparse_conv_banded.py::_banded_kernel_call (:98-161) computes at its
// default numerics: operands rounded to bf16 (_banded_apply, :174-180), each
// tap's product rounded to bf16 (:112-117) before the fp32 sum over taps.
// Without it, the one fp32 sum over taps and channels of DI_SPARSE_IMPL=s2d
// (deepinteraction_tpu/ops/sparse_conv.py::subm_conv_s2d, :648-668). The
// wrapper (ops/subm_conv.py::subm_conv_gemm with bf16=True) rounds feat and
// w to bf16 once a call, outside the kernel, feat zero-padded to a multiple
// of 16 channels and w transposed to [taps][cout][cin].
//
// Bound on the H100 at the realistic frame's stage 3 (30 000 rows, 128 ->
// 128, 16 taps hit a row): 2 * 128 * 128 operations a hit at the bf16
// tensor-core rate; at 16 channels (stage 0, 160 000 rows, 5.6 hits a row)
// the [rows, 27] table, read once. The kernel it replaces read fp32 feat
// and w, rounding in registers (twice the gathered bytes), kept two register
// tiles of 64 x 128 and so copied each w[d] for 64 rows only, and took one
// barrier per (tap, 16- or 32-channel chunk).
//
// Design:
// - tiles of 64 or 128 rows; the block reads its [rows x taps] slab of the
//   table once with 16-byte loads and lists the taps that hit the tile (one
//   warp vote a tap, one ballot to list them); a warp skips the products of
//   a tap that misses its rows;
// - a stage is 64 channels of a row: one tap's 64-channel chunk (64 and 128
//   input channels), or 2 taps of 32, or 4 taps of 16 (stage 0's 27 taps in
//   7 stages), each row gathered by 16-byte cp.async (a miss reads nothing
//   and zero-fills), w[d]'s [TN x chunk] slab beside it, STAGES - 1 stages
//   in flight ahead of the math, one barrier a stage;
// - the staged rows are padded to 8 more bf16 (16 bytes), so ldmatrix reads
//   the A fragments (rows) and the B fragments (w's [cout][cin] rows) free of
//   bank conflicts; products on mma.sync m16n8k16 bf16 with fp32 sums;
// - each warp keeps the current tap's product and the output in registers
//   (16 rows of the tile's columns each); after a tap's last chunk it rounds
//   the product (or not) and adds it to the output;
// - tiles, chosen by timing variants at the realistic frame's shapes on an
//   H100 (PERF.md): 16 and 32 output columns, 128 rows of 8 warps
//   and 2 stages, 3 blocks an SM (more blocks in flight beat deeper
//   pipelines: the gathers' latency binds); 64, 128 x 64 of 8 warps and 3
//   stages, 2 blocks an SM; 128, 64 x 128 of 8 warps and 3 stages, 2 blocks
//   an SM, which beat one 128 x 128 block of 16 warps an SM (w copied once
//   for 128 rows, but one block an SM and 1.8 waves); at most 128
//   registers a thread, no spills in any tile the main path runs.
//
// mma.sync and not wgmma: the products are not what binds this kernel (at
// stage 3 the tile-level work, every row of a tile for every tap that hits
// one of its rows, is ~27 GFLOP, ~0.04 ms at mma.sync's rate, against
// ~0.1 ms of row gathers and barriers), the per-tap rounding needs each
// tap's product in registers before the next, and wgmma's shared-memory
// layouts (core matrices, swizzle) would have to be met by a cp.async gather
// that TMA cannot do.
//
// Gated launches: with a device byte gate, the kernel runs only where *gate
// is 0 (the fp32 kernel, launched beside it, where it is set) and adds one
// to *taken when it runs.

#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kSlab = 64;  // channels of a row a stage, over its taps

// TM rows x TN output columns, WARPS_M x WARPS_N warps, KC input channels a
// tap a stage (kSlab / KC taps a stage where a tap's channels are one
// chunk), STAGES stage buffers, MIN_BLOCKS blocks an SM for the register cap
template <int TM_, int TN_, int WARPS_M_, int WARPS_N_, int KC_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int KC = KC_, STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int TAPS = kSlab / KC;  // tap slots a stage
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = TM / WARPS_M;  // rows per warp
  static constexpr int WN = TN / WARPS_N;  // columns per warp
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr int P = KC + 8;  // bf16 pitch of a staged row
  static constexpr int A_TAP = TM * P;  // bf16 a tap slot: the gathered rows
  static constexpr int B_TAP = TN * P;  // and w[d]'s [TN][KC] slab
  static constexpr int STAGE = TAPS * (A_TAP + B_TAP);
  static_assert(MT * 16 == WM && NT * 8 == WN && NT % 2 == 0, "warp tile");
  static_assert(KC % 16 == 0 && kSlab % KC == 0, "chunk");
};

// bytes before the first stage buffer: the table, the tap mask and the tap
// walk, 16-byte aligned
__host__ __device__ inline int head_bytes(int tm, int taps) {
  return (tm * taps + (taps + 31) / 32 + taps + 1 + 3) / 4 * 16;
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    subm_conv_bf16_kernel(const __nv_bfloat16* __restrict__ feat,
                          const int32_t* __restrict__ nbr,
                          const __nv_bfloat16* __restrict__ wt,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ out, int kin, int ko, int taps,
                          int cin, int cout, int per_tap, int nbr_vec,
                          const uint8_t* __restrict__ gate, int* __restrict__ taken) {
  if (gate != nullptr && *gate != 0) return;  // the fp32 kernel computes this conv
  constexpr int TM = T::TM, TN = T::TN, KC = T::KC, P = T::P, STAGES = T::STAGES, THREADS = T::THREADS;
  if (taken != nullptr && threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) *taken += 1;
  extern __shared__ float4 smem4[];
  int32_t* table = reinterpret_cast<int32_t*>(smem4);  // [TM][taps], -1 = miss
  uint32_t* mask = reinterpret_cast<uint32_t*>(table + TM * taps);  // taps that hit the tile
  // [taps + 1]: the taps that hit the tile, in order, then their count
  int32_t* walk = reinterpret_cast<int32_t*>(mask + (taps + 31) / 32);
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem4) + head_bytes(TM, taps));

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
    if (nbr_vec) {  // row0 * taps is a multiple of 4
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
  if (warp == 0) {  // the listed taps in order: a ballot a 32 taps
    int n = 0;
    for (int d0 = 0; d0 < taps; d0 += 32) {
      const int d = d0 + lane;
      const bool hit = d < taps && ((mask[d / 32] >> (d % 32)) & 1u);
      const unsigned listed = __ballot_sync(0xffffffffu, hit);
      if (hit) walk[n + __popc(listed & ((1u << lane) - 1u))] = d;
      n += __popc(listed);
    }
    if (lane == 0) walk[taps] = n;
  }
  __syncthreads();

  // 2. stages s = (group of tps listed taps s / nk, chunk s % nk): the
  // loader runs STAGES - 1 ahead of the math
  const int nk = cin / KC;
  const int tps = nk == 1 ? T::TAPS : 1;
  const int ntap = walk[taps];
  const int nstage = (ntap + tps - 1) / tps * nk;
  auto load = [&](int s) {
    const int first = s / nk * tps;
    const int slots = min(tps, ntap - first);
    const int k0 = s % nk * KC;
    __nv_bfloat16* as = stages + (s % STAGES) * T::STAGE;
    __nv_bfloat16* bs = as + T::TAPS * T::A_TAP;
    constexpr int PER = KC / 8;  // 16-byte pieces of a staged row
    for (int e = tid; e < slots * TM * PER; e += THREADS) {
      const int j = e / (TM * PER);
      const int m = e / PER % TM;
      const int c = e % PER * 8;
      const int src = table[m * taps + walk[first + j]];
      di::cp_async16(as + j * T::A_TAP + m * P + c, src >= 0 ? feat + (int64_t)src * cin + k0 + c : feat,
                     src >= 0);
    }
    for (int e = tid; e < slots * TN * PER; e += THREADS) {
      const int j = e / (TN * PER);
      const int n = e / PER % TN;
      const int c = e % PER * 8;
      const bool ok = col0 + n < cout;
      const int64_t row = (int64_t)walk[first + j] * cout + col0 + n;
      di::cp_async16(bs + j * T::B_TAP + n * P + c, ok ? wt + row * cin + k0 + c : wt, ok);
    }
  };

  float acc[T::MT][T::NT][4], part[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  // each lane's ldmatrix row: A rows lane % 16 at column (lane / 16) * 8;
  // B (w's [cout][cin]) rows (lane / 16) * 8 + lane % 8 at (lane / 8 % 2) * 8
  const int a_off = (wm * T::WM + lane % 16) * P + lane / 16 * 8;
  const int b_off = (wn * T::WN + lane / 16 * 8 + lane % 8) * P + lane / 8 % 2 * 8;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstage) load(s);
    di::cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    di::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; the previous stage's buffer is free
    if (s + STAGES - 1 < nstage) load(s + STAGES - 1);
    di::cp_async_commit();

    const int first = s / nk * tps;
    const int slots = min(tps, ntap - first);
    const bool last_chunk = s % nk == nk - 1;
    const __nv_bfloat16* as = stages + (s % STAGES) * T::STAGE;
    const __nv_bfloat16* bs = as + T::TAPS * T::A_TAP;
    for (int j = 0; j < slots; ++j) {
      const int d = walk[first + j];
      bool mine = false;  // does tap d hit any row of this warp?
      for (int m = lane; m < T::WM; m += 32) mine |= table[(wm * T::WM + m) * taps + d] >= 0;
      if (!__any_sync(0xffffffffu, mine)) continue;
      const __nv_bfloat16* a = as + j * T::A_TAP + a_off;
      const __nv_bfloat16* b = bs + j * T::B_TAP + b_off;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t af[T::MT][4];
#pragma unroll
        for (int i = 0; i < T::MT; ++i) di::ldmatrix_x4(af[i], a + i * 16 * P + kk);
#pragma unroll
        for (int q = 0; q < T::NT / 2; ++q) {  // two 8-column tiles of B a load
          uint32_t bf[4];
          di::ldmatrix_x4(bf, b + q * 16 * P + kk);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) {
            di::mma_bf16(part[i][2 * q], af[i], bf);
            di::mma_bf16(part[i][2 * q + 1], af[i], bf + 2);
          }
        }
      }
      if (last_chunk) {  // the tap's product is whole: round it (or not) and add it
#pragma unroll
        for (int i = 0; i < T::MT; ++i)
#pragma unroll
          for (int n = 0; n < T::NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][n][e] += per_tap ? di::round_bf16(part[i][n][e]) : part[i][n][e];
              part[i][n][e] = 0.f;
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
      for (int n = 0; n < T::NT; ++n) {
        const int c = col0 + wn * T::WN + n * 8 + 2 * t;
        const float v0 = keep ? acc[i][n][2 * half] : 0.f;
        const float v1 = keep ? acc[i][n][2 * half + 1] : 0.f;
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

struct Args {
  const __nv_bfloat16* feat;
  const int32_t* nbr;
  const __nv_bfloat16* wt;
  const uint8_t* valid;
  float* out;
  int kin, ko, taps, cin, cout, per_tap, nbr_vec;
  const uint8_t* gate;
  int* taken;
};

template <class T>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = subm_conv_bf16_kernel<T>;
  const int smem = head_bytes(T::TM, a.taps) + T::STAGES * T::STAGE * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.ko + T::TM - 1) / T::TM, (a.cout + T::TN - 1) / T::TN);
  kernel<<<grid, T::THREADS, smem, stream>>>(a.feat, a.nbr, a.wt, a.valid, a.out, a.kin, a.ko, a.taps, a.cin,
                                             a.cout, a.per_tap, a.nbr_vec, a.gate, a.taken);
  return static_cast<int>(cudaGetLastError());
}

// the chunk: the largest of 64, 32 (with KC32), 16 channels that divides cin
template <int TM, int TN, int WARPS_M, int WARPS_N, int STAGES, int MIN_BLOCKS, bool KC32 = true>
int launch_kc(const Args& a, cudaStream_t stream) {
  if (a.cin % 64 == 0) return launch<Tile<TM, TN, WARPS_M, WARPS_N, 64, STAGES, MIN_BLOCKS>>(a, stream);
  if constexpr (KC32) {
    if (a.cin % 32 == 0) return launch<Tile<TM, TN, WARPS_M, WARPS_N, 32, STAGES, MIN_BLOCKS>>(a, stream);
  }
  return launch<Tile<TM, TN, WARPS_M, WARPS_N, 16, STAGES, MIN_BLOCKS>>(a, stream);
}

}  // namespace

// feat [kin][cin] bf16 and wt [taps][cout][cin] bf16 (cin a multiple of 16,
// both 16-byte aligned), nbr [ko][taps] int32, valid [ko] uint8, out
// [ko][cout] fp32; per_tap: round each tap's product to bf16; gate (a device
// byte) and taken (a device int): null, or run only where *gate is 0 and
// count the launches that ran
extern "C" int di_subm_conv_bf16(const void* feat, const void* nbr, const void* wt, const void* valid,
                                 void* out, int kin, int ko, int taps, int cin, int cout, int per_tap,
                                 const void* gate, void* taken, void* stream) {
  if (ko <= 0 || cout <= 0) return 0;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (cin % 16 != 0 || !aligned(feat) || !aligned(wt)) return static_cast<int>(cudaErrorInvalidValue);
  if (cin <= 0) taps = 0;  // nothing to sum: the output is zero
  const Args a{static_cast<const __nv_bfloat16*>(feat), static_cast<const int32_t*>(nbr),
               static_cast<const __nv_bfloat16*>(wt), static_cast<const uint8_t*>(valid),
               static_cast<float*>(out), kin, ko, taps, cin, cout, per_tap != 0, aligned(nbr) ? 1 : 0,
               static_cast<const uint8_t*>(gate), static_cast<int*>(taken)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 16) return launch_kc<128, 16, 8, 1, 2, 3>(a, s);
  if (cout <= 32) return launch_kc<128, 32, 8, 1, 2, 3>(a, s);
  if (cout <= 64) return launch_kc<128, 64, 8, 1, 3, 2>(a, s);
  return launch_kc<64, 128, 4, 2, 3, 2, false>(a, s);  // 32-channel chunks spilled a register here
}
