// K1: gather-GEMM sparse convolution over a COO active set (forward).
//
//   out[i] = sum_d feat[nbr[i, d]] @ w[d]     (nbr[i, d] outside [0, kin) = miss)
//   out[i] = 0 where valid[i] == 0
//
// Replaces the Pallas kernel deepinteraction_tpu/ops/sparse_conv_banded.py::
// _banded_kernel_call (one-hot MXU scatter into a VMEM window). That band plan
// exists because row gathers are slow on a TPU; on Hopper a row gather is a
// plain coalesced load, so this is TorchSparse's gather-matmul dataflow with
// no band plan, no tap mirror and no overflow path.
//
// Bound on the H100: at the encoder's widths (Cin, Cout <= 128) each gathered
// row is used for at most 128 multiply-adds, so the kernel is bound by the
// gathered bytes (27 rows per output row), not by arithmetic. Design against
// that: one block owns a tile of output rows for all 27 taps, so the output
// tile is accumulated in registers and written once; the gather of each
// 32-channel slab is coalesced (a warp reads one 128-byte row slab); a tap
// whose rows all miss in the tile is skipped without touching memory.
// Arithmetic is fp32 on CUDA cores (a simple first kernel; wgmma/TMA later).
//
// The tap count is a runtime argument, so the same kernel runs the 27-tap
// submanifold convs, the 27-tap strided downsample convs and the 3-tap
// conv_out, given the matching neighbor table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // input channels staged per step

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    subm_conv_gemm_kernel(const float* __restrict__ feat,
                          const int32_t* __restrict__ nbr,
                          const float* __restrict__ w,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ out, int kin, int ko, int taps,
                          int cin, int cout) {
  static_assert(TM * TN == kThreads * 16, "one 4x4 micro-tile per thread");
  constexpr int TX = TN / 4;  // threads across output columns
  constexpr int TY = TM / 4;  // threads across output rows
  __shared__ int32_t rows[TM];
  __shared__ float as[TM][kChunk + 1];
  __shared__ float bs[kChunk][TN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d = 0; d < taps; ++d) {
    int hit = 0;
    for (int m = tid; m < TM; m += kThreads) {
      const int r = row0 + m;
      const int idx = r < ko ? nbr[(int64_t)r * taps + d] : -1;
      const bool ok = idx >= 0 && idx < kin;
      rows[m] = ok ? idx : -1;
      hit |= ok;
    }
    // doubles as the barrier that publishes rows[]
    if (!__syncthreads_or(hit)) continue;

    for (int k0 = 0; k0 < cin; k0 += kChunk) {
      for (int e = tid; e < TM * kChunk; e += kThreads) {
        const int m = e / kChunk;
        const int kk = e % kChunk;
        const int src = rows[m];
        as[m][kk] = (src >= 0 && k0 + kk < cin)
                        ? feat[(int64_t)src * cin + k0 + kk]
                        : 0.f;
      }
      for (int e = tid; e < kChunk * TN; e += kThreads) {
        const int kk = e / TN;
        const int n = e % TN;
        bs[kk][n] = (k0 + kk < cin && col0 + n < cout)
                        ? w[((int64_t)d * cin + k0 + kk) * cout + col0 + n]
                        : 0.f;
      }
      __syncthreads();
      const int kmax = min(kChunk, cin - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[ty + i * TY][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= ko) continue;
    const bool keep = valid[r] != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < cout) out[(int64_t)r * cout + c] = keep ? acc[i][j] : 0.f;
    }
  }
}

template <int TM, int TN>
void launch(const float* feat, const int32_t* nbr, const float* w,
            const uint8_t* valid, float* out, int kin, int ko, int taps,
            int cin, int cout, cudaStream_t stream) {
  dim3 grid((ko + TM - 1) / TM, (cout + TN - 1) / TN);
  subm_conv_gemm_kernel<TM, TN><<<grid, kThreads, 0, stream>>>(
      feat, nbr, w, valid, out, kin, ko, taps, cin, cout);
}

}  // namespace

extern "C" int di_subm_conv_gemm(const void* feat, const void* nbr,
                                 const void* w, const void* valid, void* out,
                                 int kin, int ko, int taps, int cin, int cout,
                                 void* stream) {
  if (ko <= 0 || cout <= 0) return 0;
  const float* f = static_cast<const float*>(feat);
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const float* wt = static_cast<const float*>(w);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // tile shapes keep 256 threads busy at every output width of the encoder
  if (cout <= 16) {
    launch<256, 16>(f, n, wt, v, o, kin, ko, taps, cin, cout, s);
  } else if (cout <= 32) {
    launch<128, 32>(f, n, wt, v, o, kin, ko, taps, cin, cout, s);
  } else {
    launch<64, 64>(f, n, wt, v, o, kin, ko, taps, cin, cout, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* di_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
