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
//
// The Pallas kernel's default numerics (DI_LOCATT_MXU=bf16) have a kernel
// of their own, local_attention_bf16.cu (entry di_local_attn_fwd_bf16).

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
// Replaces the custom VJP of deepinteraction_tpu/ops/local_attention_pallas.py
// (_bwd, :162-165), which differentiates the XLA form
// deepinteraction_tpu/ops/local_attention.py::local_attention. With
// S_t = q . k_t / sqrt(C) over the k*k taps t, P = softmax(S),
// dP_t = dO . v_t and D = sum_t P_t dP_t:
//
//   dS_t = P_t (dP_t - D) / sqrt(C),  dq = sum_t dS_t k_t,
//   dk_j = sum_t dS[j - off_t, t] q[j - off_t],  dv_j = sum_t P[j - off_t, t] dO[j - off_t]
//
// A tap outside the map is a zero key (S_t = 0, still in the softmax) and a
// zero value (dP_t = 0). A query outside the map does not exist: it gives
// nothing to dk or dv.
//
// Bound on the H100: 7 fp32 maps (q, k, v, dO read, dq, dk, dv written) once
// over 3.35 TB/s, against 10 k^2 C operations a pixel (S, dP, dq, dk, dv) over
// the TF32 tensor cores' 495 TFLOP/s. At [12,112,200,128], k = 9, that is
// 963 MB in 0.2876 ms against 0.0563 ms of operations, so the bytes bind;
// 0.0693 ms at [2,180,180,128].
//
// Design: the forward's tiling twice, every product block-dense on the tensor
// cores in split TF32, no atomics, so a call gives the same bits every time.
//   Pass A (local_attn_bwd_query_kernel), per 4 x 16 query tile, three sweeps
//   over the 16-channel slabs: S_r = Q K_r^T into the register band as in the
//   forward, and the softmax on it; P goes to a thread-private band in shared
//   memory, and dP_r = dO V_r^T accumulates in the same registers; then
//   D = sum P dP by rows (quad shuffles) and dS = P (dP - D) / sqrt(C) in
//   place; last dq += dS_r K_r, the forward's P V. It writes dq, and the
//   log-sum-exp and D of each query ([B, H, W] fp32 each). D comes from the
//   two bands, so no product is spent on O = P V, and the dP band is never
//   held in registers beside P.
//   Pass B (local_attn_bwd_key_kernel), per 4 x 16 key tile, the same tiling
//   mirrored: the halo holds the queries i = j - off_t around key j. Key j
//   and query i pair iff they are at most R apart in rows and in columns,
//   which is the forward's band test with the roles swapped. Four sweeps:
//   S^T_r = K Q_r^T, P^T = exp(S^T / sqrt(C) - LSE_i) (0 for a query outside
//   the map, whose LSE reads +inf); dv += P^T_r dO_r; P^T to the shared band
//   and dP^T_r = V dO_r^T into the registers, dS^T = P^T (dP^T - D_i) / sqrt(C);
//   dk += dS^T_r Q_r. Each key's sums stay in its block.
// Seven band products against the bound's five: S and dP are taken in both
// passes, in place of a [B, H, W, k^2] P and dS in device memory. Each halo
// slab is staged by cp.async at the pitch its product reads without bank
// conflicts (kQKPitch as the B of S or dP, kVPitch as the B of dq, dv or
// dk), so pass B stages dO twice. The P band (40 KB at k = 9) beside the two
// stages (66 KB) lets 2 blocks share an SM.
// ---------------------------------------------------------------------------

namespace {

// f(r, nt, e, in) for every element s[r][nt][e] of the lane's band; `in`: the
// pair is inside the window (halo columns g .. g + KS - 1 of the warp, halo
// rows e / 2 .. e / 2 + KS - 1)
template <int KS, class F>
__device__ __forceinline__ void for_band(int g, int t, F f) {
#pragma unroll
  for (int r = 0; r < Geo<KS>::NH; ++r)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = nt * 8 + 2 * t + (e & 1) - g;
        const int dy = r - (e >> 1);
        f(r, nt, e, d >= 0 && d < KS && dy >= 0 && dy < KS);
      }
}

// offset of s[r][nt][e] in a thread-private band in shared memory (a warp's
// 32 lanes on 32 banks)
__device__ __forceinline__ int band_at(int r, int nt, int e) {
  return ((r * 2 + nt) * 4 + e) * kThreads;
}

// s[r][nt] += A B_r^T over one staged slab: A the warp's two tile rows, B_r
// halo row 2 pr + r, both at kQKPitch (the forward's Q K^T). MIRROR takes the
// split's two cross terms in the other order (hi_a lo_b first), so that pass
// B's K Q^T and V dO^T sum the same products in the same order as pass A's
// Q K^T and dO V^T and give the same bits: with k = 1, P = 1 and dS = 0
// exactly, as in the plain version.
template <int KS, bool MIRROR>
__device__ __forceinline__ void band_dot(float (&s)[Geo<KS>::NH][2][4], const float* buf, int pr,
                                         int cw, int g, int t) {
  const float* a0 = buf + Geo<KS>::HALO + (2 * pr * kTW + 8 * cw + g) * kQKPitch + 2 * t;
  const float* b0 = buf + (8 * cw + g) * kQKPitch + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kCS; kk += 8) {
    uint32_t ah[4], al[4];
    const float2 aa = *reinterpret_cast<const float2*>(a0 + kk);
    const float2 ab = *reinterpret_cast<const float2*>(a0 + kTW * kQKPitch + kk);
    di::split_tf32(aa.x, ah[0], al[0]);
    di::split_tf32(ab.x, ah[1], al[1]);
    di::split_tf32(aa.y, ah[2], al[2]);
    di::split_tf32(ab.y, ah[3], al[3]);
#pragma unroll
    for (int r = 0; r < Geo<KS>::NH; ++r) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(
            b0 + ((2 * pr + r) * kNCol + nt * 8) * kQKPitch + kk);
        uint32_t bh[2], bl[2];
        di::split_tf32(bb.x, bh[0], bl[0]);
        di::split_tf32(bb.y, bh[1], bl[1]);
        if (MIRROR) {
          di::mma_tf32(s[r][nt], ah, bl);
          di::mma_tf32(s[r][nt], al, bh);
          di::mma_tf32(s[r][nt], ah, bh);
        } else {
          di::mma_split(s[r][nt], ah, al, bh, bl);
        }
      }
    }
  }
}

// o = sum_r s_r X_r over one staged slab of the halo X at kVPitch (the
// forward's P V, with its column permutation)
template <int KS>
__device__ __forceinline__ void band_apply(float (&o)[kCS / 8][4],
                                           const float (&s)[Geo<KS>::NH][2][4], const float* buf,
                                           int pr, int cw, int g, int t) {
#pragma unroll
  for (int cn = 0; cn < kCS / 8; ++cn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[cn][e] = 0.f;
  const float* x0 = buf + (8 * cw + 2 * t) * kVPitch + g;
#pragma unroll
  for (int r = 0; r < Geo<KS>::NH; ++r) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t ah[4], al[4];
      di::split_tf32(s[r][nt][0], ah[0], al[0]);
      di::split_tf32(s[r][nt][2], ah[1], al[1]);
      di::split_tf32(s[r][nt][1], ah[2], al[2]);
      di::split_tf32(s[r][nt][3], ah[3], al[3]);
      const float* xp = x0 + ((2 * pr + r) * kNCol + nt * 8) * kVPitch;
#pragma unroll
      for (int cn = 0; cn < kCS / 8; ++cn) {
        uint32_t bh[2], bl[2];
        di::split_tf32(xp[cn * 8], bh[0], bl[0]);
        di::split_tf32(xp[kVPitch + cn * 8], bh[1], bl[1]);
        di::mma_split(o[cn], ah, al, bh, bl);
      }
    }
  }
}

// channels c0 .. c0 + 15 of the lane's pixels (y, x) and (y + 1, x) from o;
// pixels outside the map are skipped
template <int VEC>
__device__ __forceinline__ void store_slab(float* __restrict__ out, const float (&o)[kCS / 8][4],
                                           int64_t img, int h, int w, int c, int c0, int y, int x,
                                           int t) {
  if (x >= w) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (y + half >= h) continue;
    float* po = out + (img + (int64_t)(y + half) * w + x) * c + c0 + 2 * t;
#pragma unroll
    for (int cn = 0; cn < kCS / 8; ++cn) {
      const int ch = c0 + cn * 8 + 2 * t;
      const float a = o[cn][2 * half], b = o[cn][2 * half + 1];
      if (VEC == 4 && ch + 1 < c) {
        *reinterpret_cast<float2*>(po + cn * 8) = make_float2(a, b);
      } else {
        if (ch < c) po[cn * 8] = a;
        if (ch + 1 < c) po[cn * 8 + 1] = b;
      }
    }
  }
}

// pass A: dq, and each query's log-sum-exp and D
template <int KS, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    local_attn_bwd_query_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                float* __restrict__ dq, float* __restrict__ lse,
                                float* __restrict__ dsum, int h, int w, int c, float scale) {
  using G = Geo<KS>;
  constexpr int NH = G::NH;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* band = smem + 2 * G::STAGE + threadIdx.x;  // see band_at

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pr = warp / 2;
  const int cw = warp % 2;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int64_t img = (int64_t)blockIdx.z * h * w;
  const int nslab = (c + kCS - 1) / kCS;
  const int y = y0 + 2 * pr, x = x0 + 8 * cw + g;  // the lane's queries: (y, x), (y + 1, x)

  float s[NH][2][4];
  for_band<KS>(g, t, [&](int r, int nt, int e, bool) { s[r][nt][e] = 0.f; });

  // sweep 0 stages q and k (S), 1 dO and v (dP), 2 k at the P V pitch (dq)
  auto issue = [&](int st) {
    float* buf = smem + (st & 1) * G::STAGE;
    const int sweep = st / nslab, c0 = (st % nslab) * kCS;
    if (sweep == 0) load_slab<KS, VEC>(buf, k, q, kQKPitch, img, h, w, c, c0, y0, x0);
    else if (sweep == 1) load_slab<KS, VEC>(buf, v, dout, kQKPitch, img, h, w, c, c0, y0, x0);
    else load_slab<KS, VEC>(buf, k, nullptr, kVPitch, img, h, w, c, c0, y0, x0);
  };
  issue(0);
  di::cp_async_commit();
  for (int st = 0; st < 3 * nslab; ++st) {
    if (st + 1 < 3 * nslab) issue(st + 1);
    di::cp_async_commit();
    di::cp_async_wait<1>();
    __syncthreads();
    const float* buf = smem + (st & 1) * G::STAGE;
    if (st < 2 * nslab) {
      band_dot<KS, false>(s, buf, pr, cw, g, t);
      if (st == nslab - 1) {
        // softmax over the band (rows e < 2: query (y, x), e >= 2: (y + 1, x));
        // P to the shared band, the registers cleared for dP
        float m0 = -INFINITY, m1 = -INFINITY;
        for_band<KS>(g, t, [&](int r, int nt, int e, bool in) {
          const float z = s[r][nt][e] * scale;
          s[r][nt][e] = z;
          if (in) {
            if (e < 2) m0 = fmaxf(m0, z);
            else m1 = fmaxf(m1, z);
          }
        });
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        float l0 = 0.f, l1 = 0.f;
        for_band<KS>(g, t, [&](int r, int nt, int e, bool in) {
          const float p = in ? expf(s[r][nt][e] - (e < 2 ? m0 : m1)) : 0.f;
          s[r][nt][e] = p;
          if (e < 2) l0 += p;
          else l1 += p;
        });
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
        for_band<KS>(g, t, [&](int r, int nt, int e, bool) {
          band[band_at(r, nt, e)] = s[r][nt][e] * (e < 2 ? inv0 : inv1);
          s[r][nt][e] = 0.f;
        });
        if (t == 0 && x < w) {
          if (y < h) lse[img + (int64_t)y * w + x] = m0 + logf(l0);
          if (y + 1 < h) lse[img + (int64_t)(y + 1) * w + x] = m1 + logf(l1);
        }
      } else if (st == 2 * nslab - 1) {
        // D = sum_t P_t dP_t by rows, then dS = P (dP - D) / sqrt(C) in place
        float a0 = 0.f, a1 = 0.f;
        for_band<KS>(g, t, [&](int r, int nt, int e, bool) {
          const float pd = band[band_at(r, nt, e)] * s[r][nt][e];
          if (e < 2) a0 += pd;
          else a1 += pd;
        });
        const float d0 = quad_sum(a0), d1 = quad_sum(a1);
        for_band<KS>(g, t, [&](int r, int nt, int e, bool) {
          s[r][nt][e] = band[band_at(r, nt, e)] * (s[r][nt][e] - (e < 2 ? d0 : d1)) * scale;
        });
        if (t == 0 && x < w) {
          if (y < h) dsum[img + (int64_t)y * w + x] = d0;
          if (y + 1 < h) dsum[img + (int64_t)(y + 1) * w + x] = d1;
        }
      }
    } else {
      float o[kCS / 8][4];
      band_apply<KS>(o, s, buf, pr, cw, g, t);
      store_slab<VEC>(dq, o, img, h, w, c, (st - 2 * nslab) * kCS, y, x, t);
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }
}

// pass B: dk and dv; the rows of the tile are keys, the halo holds queries
template <int KS, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    local_attn_bwd_key_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dsum,
                              float* __restrict__ dk, float* __restrict__ dv, int h, int w, int c,
                              float scale) {
  using G = Geo<KS>;
  constexpr int NH = G::NH;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* band = smem + 2 * G::STAGE + threadIdx.x;  // see band_at
  float* hl = smem + 2 * G::STAGE + NH * 8 * kThreads;  // the halo queries' log-sum-exp
  float* hd = hl + G::HR * kNCol;                         // and their D

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pr = warp / 2;
  const int cw = warp % 2;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int64_t img = (int64_t)blockIdx.z * h * w;
  const int nslab = (c + kCS - 1) / kCS;
  const int y = y0 + 2 * pr, x = x0 + 8 * cw + g;  // the lane's keys: (y, x), (y + 1, x)

  // a query outside the map: P^T = exp(z - inf) = 0 and D = 0, so nothing
  // (its q and dO are zero-filled too); read after the first barrier below
  for (int e = threadIdx.x; e < G::HR * kNCol; e += kThreads) {
    const int yy = y0 - G::R + e / kNCol, xx = x0 - G::R + e % kNCol;
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    hl[e] = in ? lse[img + (int64_t)yy * w + xx] : INFINITY;
    hd[e] = in ? dsum[img + (int64_t)yy * w + xx] : 0.f;
  }
  // halo column of s[r][nt][e]: nt * 8 + (e & 1) from here, halo row r
  const float* hl0 = hl + 2 * pr * kNCol + 8 * cw + 2 * t;
  const float* hd0 = hd + 2 * pr * kNCol + 8 * cw + 2 * t;

  float s[NH][2][4];
  for_band<KS>(g, t, [&](int r, int nt, int e, bool) { s[r][nt][e] = 0.f; });

  // sweep 0 stages k (tile) and q (halo) (S^T), 1 dO at the P V pitch (dv),
  // 2 v (tile) and dO (halo) (dP^T), 3 q at the P V pitch (dk)
  auto issue = [&](int st) {
    float* buf = smem + (st & 1) * G::STAGE;
    const int sweep = st / nslab, c0 = (st % nslab) * kCS;
    if (sweep == 0) load_slab<KS, VEC>(buf, q, k, kQKPitch, img, h, w, c, c0, y0, x0);
    else if (sweep == 1) load_slab<KS, VEC>(buf, dout, nullptr, kVPitch, img, h, w, c, c0, y0, x0);
    else if (sweep == 2) load_slab<KS, VEC>(buf, dout, v, kQKPitch, img, h, w, c, c0, y0, x0);
    else load_slab<KS, VEC>(buf, q, nullptr, kVPitch, img, h, w, c, c0, y0, x0);
  };
  issue(0);
  di::cp_async_commit();
  for (int st = 0; st < 4 * nslab; ++st) {
    if (st + 1 < 4 * nslab) issue(st + 1);
    di::cp_async_commit();
    di::cp_async_wait<1>();
    __syncthreads();
    const float* buf = smem + (st & 1) * G::STAGE;
    const int sweep = st / nslab;
    if (sweep == 0 || sweep == 2) {
      band_dot<KS, true>(s, buf, pr, cw, g, t);
      if (st == nslab - 1) {
        for_band<KS>(g, t, [&](int r, int nt, int e, bool in) {
          s[r][nt][e] = in ? expf(s[r][nt][e] * scale - hl0[r * kNCol + nt * 8 + (e & 1)]) : 0.f;
        });
      } else if (st == 3 * nslab - 1) {
        for_band<KS>(g, t, [&](int r, int nt, int e, bool) {
          s[r][nt][e] = band[band_at(r, nt, e)] *
                        (s[r][nt][e] - hd0[r * kNCol + nt * 8 + (e & 1)]) * scale;
        });
      }
    } else {
      float o[kCS / 8][4];
      band_apply<KS>(o, s, buf, pr, cw, g, t);
      store_slab<VEC>(sweep == 1 ? dv : dk, o, img, h, w, c, (st % nslab) * kCS, y, x, t);
      if (st == 2 * nslab - 1) {  // P^T to the shared band, the registers cleared for dP^T
        for_band<KS>(g, t, [&](int r, int nt, int e, bool) {
          band[band_at(r, nt, e)] = s[r][nt][e];
          s[r][nt][e] = 0.f;
        });
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }
}

template <int KS, int VEC>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout, float* dq,
               float* dk, float* dv, float* lse, float* dsum, int b, int h, int w, int c,
               float scale, cudaStream_t stream) {
  using G = Geo<KS>;
  const int smem_a = (2 * G::STAGE + G::NH * 8 * kThreads) * (int)sizeof(float);
  const int smem_b = smem_a + 2 * G::HR * kNCol * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(local_attn_bwd_query_kernel<KS, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(local_attn_bwd_key_kernel<KS, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, b);
  local_attn_bwd_query_kernel<KS, VEC><<<grid, kThreads, smem_a, stream>>>(
      q, k, v, dout, dq, lse, dsum, h, w, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  local_attn_bwd_key_kernel<KS, VEC><<<grid, kThreads, smem_b, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, h, w, c, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_bwd_ks(const float* q, const float* k, const float* v, const float* dout, float* dq,
                  float* dk, float* dv, float* lse, float* dsum, int b, int h, int w, int c,
                  float scale, cudaStream_t stream) {
  const bool vec = c % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                     reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                     reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  return vec ? launch_bwd<KS, 4>(q, k, v, dout, dq, dk, dv, lse, dsum, b, h, w, c, scale, stream)
             : launch_bwd<KS, 1>(q, k, v, dout, dq, dk, dv, lse, dsum, b, h, w, c, scale, stream);
}

}  // namespace

// q, k, v, dout [B, H, W, C] fp32 -> dq, dk, dv [B, H, W, C]. lse and dsum are
// fp32 scratch of B*H*W floats each (each query's log-sum-exp and D, written
// by pass A and read by pass B). ks odd, 1 .. kMaxKernel.
extern "C" int di_local_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 void* dq, void* dk, void* dv, void* lse, void* dsum, int b,
                                 int h, int w, int c, int ks, float scale, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* lf = static_cast<float*>(lse);
  float* df = static_cast<float*>(dsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ks) {
    case 1: return launch_bwd_ks<1>(qf, kf, vf, gf, dqf, dkf, dvf, lf, df, b, h, w, c, scale, s);
    case 3: return launch_bwd_ks<3>(qf, kf, vf, gf, dqf, dkf, dvf, lf, df, b, h, w, c, scale, s);
    case 5: return launch_bwd_ks<5>(qf, kf, vf, gf, dqf, dkf, dvf, lf, df, b, h, w, c, scale, s);
    case 7: return launch_bwd_ks<7>(qf, kf, vf, gf, dqf, dkf, dvf, lf, df, b, h, w, c, scale, s);
    case 9: return launch_bwd_ks<9>(qf, kf, vf, gf, dqf, dkf, dvf, lf, df, b, h, w, c, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
