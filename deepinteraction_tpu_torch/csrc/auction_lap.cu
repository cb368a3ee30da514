// The Jacobi auction for the linear assignment problem (Bertsekas), one
// problem per CTA, every round on the device.
//
// Replaces deepinteraction_tpu/ops/hungarian.py::auction_assign (:82-200),
// which is not a Pallas kernel but an XLA lax.while_loop under vmap: up to
// 4096 rounds of a few [P, G] ops. Run op by op in PyTorch that would be
// about 15 launches and one host read of the loop condition a round; here
// the loop condition is a __syncthreads_or and nothing leaves the card.
//
// Per problem (cost [P, G] float32, num_gt valid columns, G <= P), as JAX:
// the problem is squared with P - G dummy columns; benefit = -cost on the
// valid columns and 0 elsewhere (a dummy bids like any column); scale =
// max|benefit| floored at 1e-6; each phase sets eps = eps_rel * scale,
// unassigns every column and keeps the prices. A round: every unassigned
// column j finds its best row (the first of the largest benefit - price),
// the top and the runner-up value over the other rows (the top itself
// where P = 1), and bids price[best] + (top - second) + eps; every row
// takes its highest bid, the smallest column among equal ones, drops its
// previous owner and sets its price to the bid. The phase ends when no
// column is unassigned or after `cap` rounds. The output inverts column ->
// row into row -> column over the valid columns (-1 for the rest).
//
// Every add and subtract is __fadd_rn / __fsub_rn and the product
// eps_rel * scale is __fmul_rn, so nvcc contracts nothing into an FMA and
// the kernel computes JAX's float32 operations in JAX's order; the maxima
// and minima are order-free. So the result equals the plain version's
// (ops/hungarian.py::auction_assign_plain) bit for bit, ties included,
// with no atomics: one thread per column computes its bid, then one thread
// per row reduces over all columns, in column order, the bids made to it.
//
// Bound on the H100: the compulsory traffic is the cost read once (8 x 200
// x 200 fp32 = 1.28 MB at the fusion_base train step, 0.38 us at 3.35
// TB/s) and there is no arithmetic worth a rate. What sets the time is the
// chain of rounds: each is four block barriers and two sweeps of P
// dependent-free iterations per thread, one over L2-resident cost rows
// and one over the shared bids, so the kernel runs for rounds x a round's
// latency in 8 of the 132 SMs. Kept simple: the cost stays in global
// memory (L2-resident at this size), one problem a CTA.

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPhases = 8;

struct Phases {
  float eps_rel[kMaxPhases];
  int n;
};

// benefit[i][j] of the squared problem: JAX pads the cost with zeros to P
// columns and takes -cost on the valid ones
__device__ __forceinline__ float benefit(const float* __restrict__ c, int i, int j, int g_in, int ng) {
  if (j >= ng) return 0.0f;
  return j < g_in ? -__ldg(c + (int64_t)i * g_in + j) : -0.0f;
}

__global__ void auction_kernel(const float* __restrict__ cost, const int32_t* __restrict__ num_gt,
                               Phases phases, int32_t* __restrict__ out, int32_t* __restrict__ rounds_out,
                               int p, int g_in, int cap) {
  extern __shared__ float smem[];
  float* price = smem;                                  // [p]
  float* row_bid = price + p;                           // [p]
  float* bid = row_bid + p;                             // [g]
  int* win_col = reinterpret_cast<int*>(bid + p);       // [p]; the output at the end
  int* assign_col = win_col + p;                        // [g]: column -> row or -1
  int* best = assign_col + p;                           // [g]
  __shared__ float warp_max[32];

  const int g = p;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* c = cost + (int64_t)blockIdx.x * p * g_in;
  const int ng = num_gt[blockIdx.x];

  // scale: the largest |benefit| (the dummy columns are 0), floored at 1e-6
  const int gr = min(ng, g_in);
  float m = 0.0f;
  for (int e = tid; e < p * gr; e += nt) m = fmaxf(m, fabsf(benefit(c, e / gr, e % gr, g_in, ng)));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  for (int i = tid; i < p; i += nt) price[i] = 0.0f;
  __syncthreads();
  float scale = 1e-6f;
  for (int w = 0; w < (nt >> 5); ++w) scale = fmaxf(scale, warp_max[w]);

  int total = 0;
  for (int ph = 0; ph < phases.n; ++ph) {
    const float eps = __fmul_rn(phases.eps_rel[ph], scale);
    for (int j = tid; j < g; j += nt) assign_col[j] = -1;
    int r = 0;
    while (true) {
      int open = 0;
      for (int j = tid; j < g; j += nt) open |= assign_col[j] < 0;
      if (!__syncthreads_or(open) || r >= cap) break;

      // each unassigned column's best row, top and runner-up, and its bid
      for (int j = tid; j < g; j += nt) {
        int bi = 0;
        float b = -INFINITY;
        if (assign_col[j] < 0) {
          float top = -INFINITY, second = -INFINITY;
          for (int i = 0; i < p; ++i) {
            const float v = __fsub_rn(benefit(c, i, j, g_in, ng), price[i]);
            if (v > top) {
              second = top;
              top = v;
              bi = i;
            } else if (v > second) {
              second = v;
            }
          }
          if (!isfinite(second)) second = top;
          b = __fadd_rn(__fadd_rn(price[bi], __fsub_rn(top, second)), eps);
        }
        best[j] = bi;
        bid[j] = b;
      }
      __syncthreads();

      // each row's highest bid, the smallest column among equal bids
      for (int i = tid; i < p; i += nt) {
        float rb = -INFINITY;
        int wc = g;
        for (int j = 0; j < g; ++j) {
          if (best[j] == i && bid[j] > rb) {
            rb = bid[j];
            wc = j;
          }
        }
        row_bid[i] = rb;
        win_col[i] = wc;
      }
      __syncthreads();

      // rows that took a bid drop their previous owners ...
      for (int j = tid; j < g; j += nt) {
        const int a = assign_col[j];
        if (a >= 0 && win_col[a] < g) assign_col[j] = -1;
      }
      __syncthreads();
      // ... and pass to the winners at the winning bid
      for (int i = tid; i < p; i += nt) {
        const int wc = win_col[i];
        if (wc < g) {
          assign_col[wc] = i;
          price[i] = row_bid[i];
        }
      }
      __syncthreads();
      ++r;
    }
    total += r;
  }

  // column -> row into row -> column over the valid columns
  for (int i = tid; i < p; i += nt) win_col[i] = -1;
  __syncthreads();
  for (int j = tid; j < min(ng, g); j += nt) {
    const int a = assign_col[j];
    if (a >= 0) win_col[a] = j;
  }
  __syncthreads();
  for (int i = tid; i < p; i += nt) out[(int64_t)blockIdx.x * p + i] = win_col[i];
  if (tid == 0) rounds_out[blockIdx.x] = total;
}

}  // namespace

// cost [n, p, g] float32, num_gt [n] int32 (device); eps_rel [phases] on the
// host; out [n, p] int32 and rounds [n] int32 (device). g <= p <= 2048.
extern "C" int di_auction_lap(const void* cost, const void* num_gt, const float* eps_rel, void* out,
                              void* rounds, int n, int p, int g, int phases, int cap, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  if (g > p || p > 2048 || phases < 0 || phases > kMaxPhases) return (int)cudaErrorInvalidValue;
  Phases ph{};
  for (int i = 0; i < phases; ++i) ph.eps_rel[i] = eps_rel[i];
  ph.n = phases;
  const int threads = min(1024, (p + 31) / 32 * 32);
  const size_t smem = (size_t)6 * p * sizeof(float);
  auction_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int32_t*>(num_gt), ph, static_cast<int32_t*>(out),
      static_cast<int32_t*>(rounds), p, g, cap);
  return (int)cudaGetLastError();
}
