// K2: fused k x k local (sliding-window) attention on NHWC maps, forward
// (local_attn_fwd_kernel) and backward (the two passes at the end of the file).
//
//   out[p] = sum_t softmax_t(q[p] . k[p + t] / sqrt(C)) * v[p + t]
//
// over the k*k window taps t around pixel p. A tap outside the map reads a
// zero key (logit 0, which still counts in the softmax) and a zero value,
// as the reference CUDA extension and both JAX forms do.
//
// Replaces the Pallas kernel deepinteraction_tpu/ops/local_attention_pallas.py::
// _kernel (:58-101, launched by _pallas_forward at :122): block-dense MXU
// attention over an 8-row halo with a window mask, in bf16 by default.
//
// Bound on the H100 at the main-path shapes ([6,112,200,128] and
// [1,180,180,128], k = 9): the compulsory traffic is four [B, H, W, C] fp32
// maps, 0.082 ms at [6,112,200,128] at 3.35 TB/s; the useful operations
// (4 k^2 C per pixel) take 0.011 ms at the TF32 tensor-core rate, so the bytes
// bind. The fp32 CUDA-core kernel this replaces read both operands of every
// FMA from shared memory and was capped by shared-memory bandwidth.
//
// Design: the products run on the tensor cores (mma.sync m16n8k8 TF32) in
// split TF32 (tf32_mma.cuh), which keeps fp32 accuracy. A block owns 4 rows
// x 16 columns of query pixels; a warp owns 8 columns of two adjacent rows,
// as the 16 rows of its mma tiles (rows g: the upper query row, g + 8: the
// lower). Halo row r of the warp (r = 0 .. k) is window row r of the upper
// query row and row r - 1 of the lower, and every pixel's k taps in a halo
// row fall in the same 16 halo columns, so the warp takes
// S_r = Q[16 x C] K_r[16 x C]^T block-dense, as the Pallas kernel does on the
// MXU, and keeps the band: (k + 1) x 2 accumulator tiles, 80 registers at
// k = 9, hold the strip's logits. The softmax runs on those registers, each
// pixel's row reduced across its 4-lane quad with shuffles. Then
// O += P_r[16 x 16] V_r[16 x C]; the accumulator layout of S is used directly
// as the A operand by permuting the 8 columns of each k-step (k-index j < 4
// <-> column 2j, j >= 4 <-> column 2(j-4)+1), with the value rows read in the
// same order. Q K^T pairs channels the same way (j < 4 <-> channel 2j), so a
// lane reads both of its channels with one 64-bit load. Queries, the key
// halo and then the value halo are staged in 16-channel slabs by cp.async
// with zero fill (which is the zero key and value outside the map) into two
// buffers, so the next slab, and the first value slab during the softmax,
// load while the tensor cores work. 66 KB of shared memory and at most 170
// registers a thread let 3 blocks share an SM.

#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps: 2 row pairs x 2 column halves
constexpr int kTH = 4;             // tile rows
constexpr int kTW = 16;            // tile columns
constexpr int kCS = 16;            // channels per staged slab
constexpr int kQKPitch = kCS + 8;  // conflict-free 64-bit q and k fragment reads
constexpr int kVPitch = kCS + 4;   // conflict-free 32-bit v fragment reads
constexpr int kNCol = 24;          // halo columns staged (kTW + 2R <= 24)
constexpr int kMaxKernel = 9;

template <int KS>
struct Geo {
  static constexpr int R = KS / 2;
  static constexpr int NH = KS + 1;                      // halo rows of a warp
  static constexpr int HR = kTH + 2 * R;                 // halo rows of a block
  static constexpr int HALO = HR * kNCol * kQKPitch;     // floats
  static constexpr int STAGE = HALO + kTH * kTW * kQKPitch;
  static_assert(kTW + 2 * R <= kNCol, "halo columns");
};

// one slab of the key (or value) halo at `pitch`, and of the queries if q != nullptr
template <int KS, int VEC>
__device__ __forceinline__ void load_slab(float* buf, const float* __restrict__ kv,
                                          const float* __restrict__ q, int pitch, int64_t img,
                                          int h, int w, int c, int c0, int y0, int x0) {
  using G = Geo<KS>;
  constexpr int PER = kCS / VEC;
  for (int e = threadIdx.x; e < G::HR * kNCol * PER; e += kThreads) {
    const int p = e / PER;
    const int cc = (e % PER) * VEC;
    const int y = y0 - G::R + p / kNCol;
    const int x = x0 - G::R + p % kNCol;
    const bool in = y >= 0 && y < h && x >= 0 && x < w && c0 + cc < c;
    const float* src = in ? kv + (img + (int64_t)y * w + x) * c + c0 + cc : kv;
    if (VEC == 4) di::cp_async16(buf + p * pitch + cc, src, in);
    else di::cp_async4(buf + p * pitch + cc, src, in);
  }
  if (q == nullptr) return;
  float* qs = buf + G::HALO;
  for (int e = threadIdx.x; e < kTH * kTW * PER; e += kThreads) {
    const int p = e / PER;
    const int cc = (e % PER) * VEC;
    const int y = y0 + p / kTW;
    const int x = x0 + p % kTW;
    const bool in = y < h && x < w && c0 + cc < c;
    const float* src = in ? q + (img + (int64_t)y * w + x) * c + c0 + cc : q;
    if (VEC == 4) di::cp_async16(qs + p * kQKPitch + cc, src, in);
    else di::cp_async4(qs + p * kQKPitch + cc, src, in);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int KS, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
    local_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          int h, int w, int c, float scale) {
  using G = Geo<KS>;
  constexpr int NH = G::NH;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pr = warp / 2;  // query rows y0 + 2 pr (mma rows g) and + 1 (rows g + 8)
  const int cw = warp % 2;  // query columns x0 + 8 cw + g; halo columns 8 cw ..
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int64_t img = (int64_t)blockIdx.z * h * w;
  const int nslab = (c + kCS - 1) / kCS;

  // logits S[r][nt]: rows g, g+8; warp halo columns nt*8 + 2t (+1)
  float s[NH][2][4];
#pragma unroll
  for (int r = 0; r < NH; ++r)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[r][nt][e] = 0.f;
  float inv0 = 0.f, inv1 = 0.f;  // 1 / softmax sums of rows g and g+8

  // stages 0..nslab-1 stage queries + keys, nslab..2*nslab-1 values
  auto issue = [&](int st) {
    float* buf = smem + (st & 1) * G::STAGE;
    if (st < nslab) load_slab<KS, VEC>(buf, k, q, kQKPitch, img, h, w, c, st * kCS, y0, x0);
    else load_slab<KS, VEC>(buf, v, nullptr, kVPitch, img, h, w, c, (st - nslab) * kCS, y0, x0);
  };
  issue(0);
  di::cp_async_commit();
  for (int st = 0; st < 2 * nslab; ++st) {
    if (st + 1 < 2 * nslab) issue(st + 1);
    di::cp_async_commit();
    di::cp_async_wait<1>();
    __syncthreads();
    const float* buf = smem + (st & 1) * G::STAGE;
    if (st < nslab) {
      const float* q0 = buf + G::HALO + (2 * pr * kTW + 8 * cw + g) * kQKPitch + 2 * t;
      const float* k0 = buf + (8 * cw + g) * kQKPitch + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kCS; kk += 8) {
        uint32_t ah[4], al[4];
        const float2 qa = *reinterpret_cast<const float2*>(q0 + kk);
        const float2 qb = *reinterpret_cast<const float2*>(q0 + kTW * kQKPitch + kk);
        di::split_tf32(qa.x, ah[0], al[0]);
        di::split_tf32(qb.x, ah[1], al[1]);
        di::split_tf32(qa.y, ah[2], al[2]);
        di::split_tf32(qb.y, ah[3], al[3]);
#pragma unroll
        for (int r = 0; r < NH; ++r) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float2 kb = *reinterpret_cast<const float2*>(
                k0 + ((2 * pr + r) * kNCol + nt * 8) * kQKPitch + kk);
            uint32_t bh[2], bl[2];
            di::split_tf32(kb.x, bh[0], bl[0]);
            di::split_tf32(kb.y, bh[1], bl[1]);
            di::mma_split(s[r][nt], ah, al, bh, bl);
          }
        }
      }
      if (st == nslab - 1) {
        // softmax over the band: row g (upper query row) takes halo rows
        // 0..KS-1, row g+8 (lower) rows 1..KS; pixel g takes columns g..g+KS-1
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int r = 0; r < NH; ++r)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int d = nt * 8 + 2 * t + (e & 1) - g;
              const int dy = r - (e >> 1);
              const float x = s[r][nt][e] * scale;
              s[r][nt][e] = x;
              if (d >= 0 && d < KS && dy >= 0 && dy < KS) {
                if (e < 2) m0 = fmaxf(m0, x);
                else m1 = fmaxf(m1, x);
              }
            }
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int r = 0; r < NH; ++r)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int d = nt * 8 + 2 * t + (e & 1) - g;
              const int dy = r - (e >> 1);
              const bool in = d >= 0 && d < KS && dy >= 0 && dy < KS;
              const float p = in ? expf(s[r][nt][e] - (e < 2 ? m0 : m1)) : 0.f;
              s[r][nt][e] = p;
              if (e < 2) l0 += p;
              else l1 += p;
            }
        inv0 = 1.f / quad_sum(l0);
        inv1 = 1.f / quad_sum(l1);
      }
    } else {
      const int c0 = (st - nslab) * kCS;
      float o[kCS / 8][4];
#pragma unroll
      for (int cn = 0; cn < kCS / 8; ++cn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[cn][e] = 0.f;
      const float* v0 = buf + (8 * cw + 2 * t) * kVPitch + g;
#pragma unroll
      for (int r = 0; r < NH; ++r) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // A = P_r with the k-step's columns permuted (see the note above)
          uint32_t ah[4], al[4];
          di::split_tf32(s[r][nt][0], ah[0], al[0]);
          di::split_tf32(s[r][nt][2], ah[1], al[1]);
          di::split_tf32(s[r][nt][1], ah[2], al[2]);
          di::split_tf32(s[r][nt][3], ah[3], al[3]);
          const float* vp = v0 + ((2 * pr + r) * kNCol + nt * 8) * kVPitch;
#pragma unroll
          for (int cn = 0; cn < kCS / 8; ++cn) {
            uint32_t bh[2], bl[2];
            di::split_tf32(vp[cn * 8], bh[0], bl[0]);
            di::split_tf32(vp[kVPitch + cn * 8], bh[1], bl[1]);
            di::mma_split(o[cn], ah, al, bh, bl);
          }
        }
      }
      const int x = x0 + 8 * cw + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int y = y0 + 2 * pr + half;
        if (y >= h || x >= w) continue;
        const float inv = half ? inv1 : inv0;
        float* po = out + (img + (int64_t)y * w + x) * c + c0 + 2 * t;
#pragma unroll
        for (int cn = 0; cn < kCS / 8; ++cn) {
          const int ch = c0 + cn * 8 + 2 * t;
          const float a = o[cn][2 * half] * inv, b = o[cn][2 * half + 1] * inv;
          if (VEC == 4 && ch + 1 < c) {
            *reinterpret_cast<float2*>(po + cn * 8) = make_float2(a, b);
          } else {
            if (ch < c) po[cn * 8] = a;
            if (ch + 1 < c) po[cn * 8 + 1] = b;
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }
}

template <int KS, int VEC>
int launch(const float* q, const float* k, const float* v, float* out, int b, int h,
           int w, int c, float scale, cudaStream_t stream) {
  const int smem = 2 * Geo<KS>::STAGE * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(local_attn_fwd_kernel<KS, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, b);
  local_attn_fwd_kernel<KS, VEC><<<grid, kThreads, smem, stream>>>(q, k, v, out, h, w, c, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_ks(const float* q, const float* k, const float* v, float* out, int b, int h,
              int w, int c, float scale, cudaStream_t stream) {
  const bool vec = c % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return vec ? launch<KS, 4>(q, k, v, out, b, h, w, c, scale, stream)
             : launch<KS, 1>(q, k, v, out, b, h, w, c, scale, stream);
}

}  // namespace

// ks odd, 1 .. kMaxKernel (the wrapper checks); other sizes are refused
extern "C" int di_local_attn_fwd(const void* q, const void* k, const void* v,
                                 void* out, int b, int h, int w, int c, int ks,
                                 float scale, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxKernel == 9, "the dispatch below lists every size");
  switch (ks) {
    case 1: return launch_ks<1>(qf, kf, vf, o, b, h, w, c, scale, s);
    case 3: return launch_ks<3>(qf, kf, vf, o, b, h, w, c, scale, s);
    case 5: return launch_ks<5>(qf, kf, vf, o, b, h, w, c, scale, s);
    case 7: return launch_ks<7>(qf, kf, vf, o, b, h, w, c, scale, s);
    case 9: return launch_ks<9>(qf, kf, vf, o, b, h, w, c, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Backward: dq, dk, dv of the forward above, given dO.
//
// The JAX package has no backward kernel: its custom VJP re-differentiates
// the XLA oracle (deepinteraction_tpu/ops/local_attention_pallas.py::_bwd,
// :162-165). With S_t = q . k_t / sqrt(C) over the k*k taps t, P = softmax(S),
// dP_t = dO . v_t and D = sum_t P_t dP_t:
//
//   dS_t = P_t (dP_t - D) / sqrt(C),  dq = sum_t dS_t k_t,
//   dk_j = sum_t dS[j - off_t, t] q[j - off_t],  dv_j = sum_t P[j - off_t, t] dO[j - off_t]
//
// A tap outside the map is a zero key (S_t = 0, still in the softmax) and a
// zero value (dP_t = 0); it passes no gradient anywhere.
//
// Bound on the H100 at the main-path shapes: the useful operations are
// 10 k^2 C per pixel (S, dP, dq, dk, dv: 2 k^2 C each) against the bytes of
// q, k, v, dO read once and dq, dk, dv written once; on fp32 CUDA cores
// (67 TFLOP/s) the operations bind ([12,112,200,128], k = 9: 27.9 GFLOP,
// 0.416 ms, against 963 MB, 0.288 ms).
//
// Design: simple, deterministic, no atomics. Two passes, a warp per pixel,
// each lane holding 4 consecutive channels (one 16-byte load per row):
//   pass A, per query pixel: the k^2 logits and dP_t by warp reductions into
//     shared memory, the softmax and D across the warp's lanes, then dq; P and
//     dS go to a [B, H, W, k^2] fp32 scratch;
//   pass B, per key pixel j: gathers over the k^2 queries whose window holds
//     j (P and dS are one broadcast load each) for dk and dv.
// The k^2 rows a warp reads overlap its neighbours' and come from L1/L2.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBwdWarps = 8;
constexpr int kMaxTaps = kMaxKernel * kMaxKernel;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float dot(T a, T b) { return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w; }
  __device__ static void axpy(T& acc, float s, T x) {
    acc.x += s * x.x; acc.y += s * x.y; acc.z += s * x.z; acc.w += s * x.w;
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static float dot(T a, T b) { return a * b; }
  __device__ static void axpy(T& acc, float s, T x) { acc += s * x; }
};

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T ld(const float* p) {
  return *reinterpret_cast<const typename Vec<VEC>::T*>(p);
}

template <int VEC>
__device__ __forceinline__ void st(float* p, typename Vec<VEC>::T x) {
  *reinterpret_cast<typename Vec<VEC>::T*>(p) = x;
}

// pass A: one warp per query pixel
template <int VEC>
__global__ void __launch_bounds__(kBwdWarps * 32)
    local_attn_bwd_query_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                float* __restrict__ dq, float* __restrict__ pbuf,
                                float* __restrict__ dsbuf, int64_t npix, int h, int w, int c,
                                int ks, float scale) {
  using V = Vec<VEC>;
  __shared__ float sm[kBwdWarps][2][kMaxTaps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pix = (int64_t)blockIdx.x * kBwdWarps + warp;
  if (pix >= npix) return;  // the whole warp; the kernel has no block barrier
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int64_t img = pix - (int64_t)y * w - x;
  const int r = ks / 2, taps = ks * ks;
  float* s = sm[warp][0];   // logits, then P
  float* dp = sm[warp][1];  // dP, then dS
  const float* qp = q + pix * c;
  const float* gp = dout + pix * c;

  for (int t = 0; t < taps; ++t) {
    const int yy = y + t / ks - r, xx = x + t % ks - r;
    float a = 0.f, d = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {  // the same for the whole warp
      const int64_t j = (img + (int64_t)yy * w + xx) * c;
      for (int cc = lane * VEC; cc < c; cc += 32 * VEC) {
        a += V::dot(ld<VEC>(qp + cc), ld<VEC>(k + j + cc));
        d += V::dot(ld<VEC>(gp + cc), ld<VEC>(v + j + cc));
      }
    }
    a = warp_sum(a);
    d = warp_sum(d);
    if (lane == 0) {
      s[t] = a * scale;
      dp[t] = d;
    }
  }
  __syncwarp();
  float m = -INFINITY;
  for (int t = lane; t < taps; t += 32) m = fmaxf(m, s[t]);
  m = warp_max(m);
  float l = 0.f;
  for (int t = lane; t < taps; t += 32) l += expf(s[t] - m);
  const float inv = 1.f / warp_sum(l);
  float dsum = 0.f;
  for (int t = lane; t < taps; t += 32) {
    const float p = expf(s[t] - m) * inv;
    s[t] = p;
    dsum += p * dp[t];
  }
  dsum = warp_sum(dsum);
  for (int t = lane; t < taps; t += 32) {
    const float ds = s[t] * (dp[t] - dsum) * scale;
    dp[t] = ds;
    pbuf[pix * taps + t] = s[t];
    dsbuf[pix * taps + t] = ds;
  }
  __syncwarp();
  for (int cc = lane * VEC; cc < c; cc += 32 * VEC) {
    typename V::T acc = V::zero();
    for (int t = 0; t < taps; ++t) {
      const int yy = y + t / ks - r, xx = x + t % ks - r;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        V::axpy(acc, dp[t], ld<VEC>(k + (img + (int64_t)yy * w + xx) * c + cc));
    }
    st<VEC>(dq + pix * c + cc, acc);
  }
}

// pass B: one warp per key pixel j; query j - off_t reads j at its tap t
template <int VEC>
__global__ void __launch_bounds__(kBwdWarps * 32)
    local_attn_bwd_key_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                              const float* __restrict__ pbuf, const float* __restrict__ dsbuf,
                              float* __restrict__ dk, float* __restrict__ dv, int64_t npix, int h,
                              int w, int c, int ks) {
  using V = Vec<VEC>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pix = (int64_t)blockIdx.x * kBwdWarps + warp;
  if (pix >= npix) return;
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int64_t img = pix - (int64_t)y * w - x;
  const int r = ks / 2, taps = ks * ks;
  for (int cc = lane * VEC; cc < c; cc += 32 * VEC) {
    typename V::T ak = V::zero(), av = V::zero();
    for (int t = 0; t < taps; ++t) {
      const int yy = y - (t / ks - r), xx = x - (t % ks - r);
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      const int64_t i = img + (int64_t)yy * w + xx;
      V::axpy(ak, dsbuf[i * taps + t], ld<VEC>(q + i * c + cc));
      V::axpy(av, pbuf[i * taps + t], ld<VEC>(dout + i * c + cc));
    }
    st<VEC>(dk + pix * c + cc, ak);
    st<VEC>(dv + pix * c + cc, av);
  }
}

template <int VEC>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout, float* dq,
               float* dk, float* dv, float* p, float* ds, int64_t npix, int h, int w, int c,
               int ks, float scale, cudaStream_t stream) {
  const int64_t blocks = (npix + kBwdWarps - 1) / kBwdWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  local_attn_bwd_query_kernel<VEC><<<(unsigned)blocks, kBwdWarps * 32, 0, stream>>>(
      q, k, v, dout, dq, p, ds, npix, h, w, c, ks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  local_attn_bwd_key_kernel<VEC><<<(unsigned)blocks, kBwdWarps * 32, 0, stream>>>(
      q, dout, p, ds, dk, dv, npix, h, w, c, ks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout [B, H, W, C] fp32 -> dq, dk, dv; p and ds are [B, H, W, ks*ks]
// fp32 scratch. ks odd, 1 .. kMaxKernel.
extern "C" int di_local_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 void* dq, void* dk, void* dv, void* p, void* ds, int b, int h,
                                 int w, int c, int ks, float scale, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  if (ks % 2 != 1 || ks < 1 || ks > kMaxKernel) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  const bool vec = c % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                     reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                     reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  const int64_t npix = (int64_t)b * h * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* dsf = static_cast<float*>(ds);
  return vec ? launch_bwd<4>(qf, kf, vf, gf, dqf, dkf, dvf, pf, dsf, npix, h, w, c, ks, scale, s)
             : launch_bwd<1>(qf, kf, vf, gf, dqf, dkf, dvf, pf, dsf, npix, h, w, c, ks, scale, s);
}
