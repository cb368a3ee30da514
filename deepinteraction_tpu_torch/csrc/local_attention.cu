// K2: fused k x k local (sliding-window) attention on NHWC maps (forward).
//
//   out[p] = sum_t softmax_t(q[p] . k[p + t] / sqrt(C)) * v[p + t]
//
// over the k*k window taps t around pixel p. A tap outside the map reads a
// zero key (logit 0, which still counts in the softmax) and a zero value,
// as the reference CUDA extension and both JAX forms do.
//
// Replaces the Pallas kernel deepinteraction_tpu/ops/local_attention_pallas.py::
// _kernel (block-dense MXU attention over an 8-row halo with a window mask).
// The plain formulation writes the [B, H, W, k*k] logit map to memory and
// makes 2*k*k passes over the feature maps.
//
// Bound on the H100: compulsory traffic is four [B, H, W, C] fp32 maps; at
// C = 128 and k = 9 that is about 20 flops per byte, which is at the fp32
// CUDA-core ridge of the card, so the job of the design is to keep traffic
// at that compulsory minimum. One block owns a TH x TW tile of query pixels.
// It stages the tile's queries and the (TH + 2r) x (TW + 2r) halo of keys in
// shared memory in 32-channel slabs, accumulates all k*k logits of the tile
// in shared memory, takes the softmax there (one online max/sum pass, then
// normalisation), and stages the value halo through the same buffer for the
// weighted sum. The logits never leave the chip, and each key and value is
// read from memory once per tile. Arithmetic is fp32 on CUDA cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;      // tile rows
constexpr int kTW = 16;     // tile columns
constexpr int kChunk = 32;  // channels staged per slab
constexpr int kPitch = kChunk + 1;  // padded row pitch: no bank conflicts

__device__ __forceinline__ void stage_halo(const float* __restrict__ src,
                                           float* __restrict__ halo,
                                           int64_t img, int h, int w, int c,
                                           int c0, int y0, int x0, int r,
                                           int hw, int npix) {
  for (int e = threadIdx.x; e < npix * kChunk; e += kThreads) {
    const int hp = e / kChunk;
    const int cc = e % kChunk;
    const int y = y0 - r + hp / hw;
    const int x = x0 - r + hp % hw;
    const bool in = y >= 0 && y < h && x >= 0 && x < w && c0 + cc < c;
    halo[hp * kPitch + cc] =
        in ? src[(img + (int64_t)y * w + x) * c + c0 + cc] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    local_attn_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          int h, int w, int c, int ks, float scale) {
  extern __shared__ float smem[];
  const int r = ks / 2;
  const int kk = ks * ks;
  const int hw = kTW + 2 * r;
  const int nhalo = (kTH + 2 * r) * hw;
  constexpr int np = kTH * kTW;
  float* halo = smem;                 // [nhalo][kPitch]
  float* qs = halo + nhalo * kPitch;  // [np][kPitch]
  float* lg = qs + np * kPitch;       // [np][kk]

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int64_t img = (int64_t)blockIdx.z * h * w;

  for (int e = tid; e < np * kk; e += kThreads) lg[e] = 0.f;

  // logits, one 32-channel slab at a time
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    for (int e = tid; e < np * kChunk; e += kThreads) {
      const int p = e / kChunk;
      const int cc = e % kChunk;
      const int y = y0 + p / kTW;
      const int x = x0 + p % kTW;
      qs[p * kPitch + cc] = (y < h && x < w && c0 + cc < c)
                                ? q[(img + (int64_t)y * w + x) * c + c0 + cc]
                                : 0.f;
    }
    stage_halo(k, halo, img, h, w, c, c0, y0, x0, r, hw, nhalo);
    __syncthreads();
    for (int e = tid; e < np * kk; e += kThreads) {
      const int p = e / kk;
      const int t = e % kk;
      const int hp = (p / kTW + t / ks) * hw + (p % kTW + t % ks);
      const float* qa = qs + p * kPitch;
      const float* ka = halo + hp * kPitch;
      float s = 0.f;
#pragma unroll
      for (int cc = 0; cc < kChunk; ++cc) s = fmaf(qa[cc], ka[cc], s);
      lg[e] += s;
    }
    __syncthreads();
  }

  // softmax over the k*k taps of each pixel, in place
  for (int p = tid; p < np; p += kThreads) {
    float* l = lg + p * kk;
    float m = -INFINITY;
    float s = 0.f;
    for (int t = 0; t < kk; ++t) {
      const float x = l[t] * scale;
      if (x > m) {
        s = s * expf(m - x) + 1.f;
        m = x;
      } else {
        s += expf(x - m);
      }
    }
    const float inv = 1.f / s;
    for (int t = 0; t < kk; ++t) l[t] = expf(l[t] * scale - m) * inv;
  }
  __syncthreads();

  // weighted sum of the value halo, one slab at a time
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    stage_halo(v, halo, img, h, w, c, c0, y0, x0, r, hw, nhalo);
    __syncthreads();
    for (int e = tid; e < np * kChunk; e += kThreads) {
      const int p = e / kChunk;
      const int cc = e % kChunk;
      const int py = p / kTW;
      const int px = p % kTW;
      const float* l = lg + p * kk;
      float acc = 0.f;
      for (int dy = 0; dy < ks; ++dy) {
        const float* row = halo + ((py + dy) * hw + px) * kPitch + cc;
        for (int dx = 0; dx < ks; ++dx)
          acc = fmaf(l[dy * ks + dx], row[dx * kPitch], acc);
      }
      const int y = y0 + py;
      const int x = x0 + px;
      if (y < h && x < w && c0 + cc < c)
        out[(img + (int64_t)y * w + x) * c + c0 + cc] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int di_local_attn_smem_bytes(int ks) {
  const int r = ks / 2;
  const int nhalo = (kTH + 2 * r) * (kTW + 2 * r);
  const int np = kTH * kTW;
  return (int)sizeof(float) * (nhalo * kPitch + np * kPitch + np * ks * ks);
}

extern "C" int di_local_attn_fwd(const void* q, const void* k, const void* v,
                                 void* out, int b, int h, int w, int c, int ks,
                                 float scale, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const int smem = di_local_attn_smem_bytes(ks);
  cudaError_t err = cudaFuncSetAttribute(
      local_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, b);
  local_attn_fwd_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), h, w, c, ks,
      scale);
  return static_cast<int>(cudaGetLastError());
}
