// The Jacobi auction for the linear assignment problem (Bertsekas), one
// problem per CTA, every round on the device.
//
// Replaces deepinteraction_tpu/ops/hungarian.py::auction_assign (:82-200),
// which is not a Pallas kernel but an XLA lax.while_loop under vmap: up to
// 4096 rounds of a few [P, G] ops. Run op by op in PyTorch that would be
// about 15 launches and one host read of the loop condition a round; here
// nothing leaves the card.
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
// Bound on the H100: the compulsory traffic is the cost read once (8 x 200
// x 200 fp32 = 1.28 MB at the fusion_base train step, 0.38 us at 3.35
// TB/s) and there is no arithmetic worth a rate. What sets the time is the
// chain of rounds, whose number JAX's semantics fix (110-327 at that step):
// the kernel runs for rounds x a round's latency on 8 of the 132 SMs. So
// the design cuts the latency of one round:
//
// - The benefits of the columns with a cost (j < min(num_gt, G)) are
//   staged once in shared memory, transposed to [j][P] with an odd row
//   stride, so that a column's rows are contiguous and the transposing
//   writes fall on distinct banks. The scale comes from the same pass.
//   Where P x G does not fit beside the state, the same kernel reads them
//   from L2 (kStaged = false).
// - One warp a column: lane l scans rows l, l + 32, ... in order, keeping
//   (top, its first row, runner-up); the warp merges them with redux.sync
//   on order-preserving integer keys (max top; min row among equal tops;
//   the runner-up from every lane's runner-up and the other lanes' tops).
//   Maxima do not depend on order, so this is JAX's argmax and runner-up
//   exactly. -0 is keyed as +0, so that a -0 and a +0 tie as they compare.
// - The columns without a cost (padded real ones and the dummies) all see
//   the benefit +-0, so every open one makes the same bid for the same row,
//   and only the smallest open one can win it: one scan a round, and that
//   column enters the row pass as the only candidate among them. Real
//   columns are smaller, so a real column with an equal bid still wins.
// - The row pass is order-free and touches the bidders only: each bidder
//   packs (its bid's key, ~column) into 64 bits and takes the row's
//   atomicMax in shared memory, which is the largest bid and, among equal
//   ones, the smallest column; after one barrier the bidder holding the
//   row's key has won it and hands the row over itself (the previous
//   owner reopens; the price becomes the winner's own bid bits).
// - The open columns are a bitset. Every warp reads it at the start of a
//   round and counts the open columns itself (redux.sync), so the loop
//   condition costs no barrier: a round is two block barriers. The number
//   of open columns never grows within a phase (a row that changes hands
//   closes its winner and reopens at most one column), so once it falls
//   to kSoloBelow the rest of the phase runs on warp 0 alone, with
//   __syncwarp in place of the block barriers.
//
// Every add and subtract is __fadd_rn / __fsub_rn and the product
// eps_rel * scale is __fmul_rn, so nvcc contracts nothing into an FMA and
// the kernel computes JAX's float32 operations in JAX's order. So the
// result equals the plain version's (ops/hungarian.py::
// auction_assign_plain) bit for bit, ties included, and one call gives the
// same bits as the next whatever order the atomics take.

#include <math.h>
#include <stdint.h>

// threads a CTA, and the open-column count at or below which warp 0 runs
// the rest of a phase alone (0: never); set by timing on an H100
// (kernel_ab.py --auction-sweep)
#ifndef DI_AUCTION_THREADS
#define DI_AUCTION_THREADS 512
#endif
#ifndef DI_AUCTION_SOLO_BELOW
#define DI_AUCTION_SOLO_BELOW 1
#endif

namespace {

constexpr int kMaxPhases = 8;
constexpr int kThreads = DI_AUCTION_THREADS;
constexpr int kSoloBelow = DI_AUCTION_SOLO_BELOW;
constexpr uint32_t kFull = 0xffffffffu;

struct Phases {
  float eps_rel[kMaxPhases];
  int n;
};

// order-preserving key of a float, -0 keyed as +0 (they compare equal)
__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the bits of word q that stand for columns j < gr
__device__ __forceinline__ uint32_t below(int q, int gr) {
  const int n = gr - 32 * q;
  return n >= 32 ? kFull : n <= 0 ? 0u : (1u << n) - 1u;
}

struct Shared {
  unsigned long long* row_key;   // [p] the best (bid key, ~column) a row got this round; 0: none
  unsigned long long* slot_key;  // [p] each bidder's key, by its rank
  float* price;                  // [p]
  float* slot_bid;               // [p] each bidder's bid
  int* owner;                    // [p] row -> column or -1
  int* slot_row;                 // [p] each bidder's row
  uint32_t* open;                // [(p + 31) / 32] the unassigned columns
  float* ben;                    // [gr][stride] -cost, transposed (kStaged)
};

struct Problem {
  const float* c;  // [p][g_in]
  int p, g_in, gr, stride;
  float eps;
};

// The bid of column j (rank k among this round's bidders), by one warp;
// `costed` says whether the column has a cost (else its benefit is +-0).
template <bool kStaged>
__device__ __forceinline__ void bid(const Shared& s, const Problem& pr, int j, int k, bool costed, int lane) {
  const float* col = s.ben + (size_t)j * pr.stride;
  float top = -INFINITY, second = -INFINITY;
  uint32_t best = lane < pr.p ? lane : kFull;
  // 8 rows a lane a step, unrolled and branch-free, so that their loads
  // go out together; rows past P read as -inf and change nothing
  for (int base = lane; base < pr.p; base += 256) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + 32 * u;
      const bool in = i < pr.p;
      const float b = !costed || !in ? 0.0f : kStaged ? col[i] : -__ldg(pr.c + (int64_t)i * pr.g_in + j);
      const float v = in ? __fsub_rn(b, s.price[in ? i : 0]) : -INFINITY;
      const bool above_top = v > top, above_second = v > second;
      second = above_top ? top : above_second ? v : second;
      top = above_top ? v : top;
      best = above_top ? (uint32_t)i : best;
    }
  }
  // The runner-up over the rows other than the best one is the best row's
  // lane's runner-up or another lane's top: the largest of every lane's
  // runner-up, every top below the largest, and the largest itself where
  // two lanes hold it. So two dependent steps: the largest top and
  // runner-up, then the best row and the rest.
  const uint32_t tk = key_of(top);
  const uint32_t t = __reduce_max_sync(kFull, tk);
  const uint32_t s_all = __reduce_max_sync(kFull, key_of(second));
  const uint32_t bi = __reduce_min_sync(kFull, tk == t ? best : kFull);
  const uint32_t t_below = __reduce_max_sync(kFull, tk < t ? tk : 0u);
  const int tied = __reduce_add_sync(kFull, tk == t ? 1 : 0);
  const uint32_t sk = max(max(s_all, t_below), tied > 1 ? t : 0u);
  const float hi = float_of(t);
  float lo = float_of(sk);
  if (!isfinite(lo)) lo = hi;
  const float b = __fadd_rn(__fadd_rn(s.price[bi], __fsub_rn(hi, lo)), pr.eps);
  if (lane == 0) {
    const unsigned long long key = (unsigned long long)key_of(b) << 32 | (kFull - (uint32_t)j);
    atomicMax(s.row_key + bi, key);
    s.slot_key[k] = key;
    s.slot_bid[k] = b;
    s.slot_row[k] = (int)bi;
  }
}

// One round, run by `nw` warps (warp `w` of them) and synchronised by
// `sync`. Returns false, having changed nothing, where no column is open.
template <bool kStaged, typename Sync>
__device__ __forceinline__ bool auction_round(const Shared& s, const Problem& pr, int w, int nw, int lane, Sync sync,
                                      int* n_open) {
  // count the open columns: all, those with a cost, and the smallest open
  // one without a cost (the only candidate among them)
  const int words = (pr.p + 31) >> 5;
  int all = 0, costed = 0;
  uint32_t cand = kFull;
  for (int q = lane; q < words; q += 32) {
    const uint32_t m = s.open[q], r = below(q, pr.gr);
    all += __popc(m);
    costed += __popc(m & r);
    if ((m & ~r) && cand == kFull) cand = 32 * q + __ffs(m & ~r) - 1;
  }
  all = __reduce_add_sync(kFull, all);
  costed = __reduce_add_sync(kFull, costed);
  cand = __reduce_min_sync(kFull, cand);
  *n_open = all;
  if (all == 0) return false;

  // the bids: warp w takes the open costed columns of rank w, w + nw, ...,
  // and the candidate has rank `costed`
  int skip = w;  // open columns to pass over before this warp's next one
  int k = 0;
  for (int q = 0; q < (pr.gr + 31) >> 5 && k < costed; ++q) {
    uint32_t m = s.open[q] & below(q, pr.gr);
    const int n = __popc(m);
    if (skip >= n) {
      skip -= n;
      k += n;
      continue;
    }
    while (m) {
      if (skip == 0) {
        bid<kStaged>(s, pr, 32 * q + __ffs(m) - 1, k, true, lane);
        skip = nw;
      }
      m &= m - 1;
      --skip;
      ++k;
    }
  }
  if (cand != kFull && costed % nw == w) bid<kStaged>(s, pr, (int)cand, costed, false, lane);
  sync();

  // the bidder that holds its row's key won the row
  const int bidders = costed + (cand != kFull);
  const int t0 = 32 * w + lane, nt = 32 * nw;
  for (int b = t0; b < bidders; b += nt) {
    const int row = s.slot_row[b];
    const unsigned long long key = s.slot_key[b];
    if (s.row_key[row] == key) {
      const int j = (int)(kFull - (uint32_t)key);
      const int prev = s.owner[row];
      s.owner[row] = j;
      s.price[row] = s.slot_bid[b];
      s.row_key[row] = 0ull;
      atomicAnd(s.open + (j >> 5), ~(1u << (j & 31)));
      if (prev >= 0) atomicOr(s.open + (prev >> 5), 1u << (prev & 31));
    }
  }
  sync();
  return true;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const int32_t* __restrict__ num_gt, Phases phases,
               int32_t* __restrict__ out, int32_t* __restrict__ rounds_out, int p, int g_in, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_max[kThreads / 32];
  const int words = (p + 31) >> 5;
  Shared s;
  s.row_key = reinterpret_cast<unsigned long long*>(smem);
  s.slot_key = s.row_key + p;
  s.price = reinterpret_cast<float*>(s.slot_key + p);
  s.slot_bid = s.price + p;
  s.owner = reinterpret_cast<int*>(s.slot_bid + p);
  s.slot_row = s.owner + p;
  s.open = reinterpret_cast<uint32_t*>(s.slot_row + p);
  s.ben = reinterpret_cast<float*>(s.open + words);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = kThreads / 32;
  const int ng = num_gt[blockIdx.x];
  Problem pr;
  pr.c = cost + (int64_t)blockIdx.x * p * g_in;
  pr.p = p;
  pr.g_in = g_in;
  pr.gr = max(0, min(ng, g_in));  // the columns with a cost
  pr.stride = p | 1;

  // the benefits, transposed, and the scale: the largest |benefit| (the
  // rest are 0), floored at 1e-6
  float m = 0.0f;
  for (int i = warp; i < p; i += nw)
    for (int j = lane; j < pr.gr; j += 32) {
      const float b = -__ldg(pr.c + (int64_t)i * g_in + j);
      m = fmaxf(m, fabsf(b));
      if (kStaged) s.ben[j * pr.stride + i] = b;
    }
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 16));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 8));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 4));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
  if (lane == 0) warp_max[warp] = m;
  for (int i = tid; i < p; i += kThreads) {
    s.price[i] = 0.0f;
    s.row_key[i] = 0ull;
  }
  __syncthreads();
  float scale = 1e-6f;
  for (int v = 0; v < nw; ++v) scale = fmaxf(scale, warp_max[v]);

  const auto block = [] { __syncthreads(); };
  const auto solo = [] { __syncwarp(); };
  int total = 0;
  for (int ph = 0; ph < phases.n; ++ph) {
    pr.eps = __fmul_rn(phases.eps_rel[ph], scale);
    for (int i = tid; i < p; i += kThreads) s.owner[i] = -1;
    for (int q = tid; q < words; q += kThreads) s.open[q] = 32 * (q + 1) <= p ? kFull : (1u << (p & 31)) - 1u;
    __syncthreads();
    int r = 0, n_open = p;
    while (r < cap && n_open > kSoloBelow && auction_round<kStaged>(s, pr, warp, nw, lane, block, &n_open)) ++r;
    // the rest of the phase, on warp 0 alone: nothing else reads the state
    if (warp == 0)
      while (r < cap && auction_round<kStaged>(s, pr, 0, 1, lane, solo, &n_open)) ++r;
    __syncthreads();
    total += r;
  }

  // row -> column over the valid columns
  for (int i = tid; i < p; i += kThreads) {
    const int o = s.owner[i];
    out[(int64_t)blockIdx.x * p + i] = o >= 0 && o < ng ? o : -1;
  }
  if (tid == 0) rounds_out[blockIdx.x] = total;
}

// dynamic shared bytes of a CTA: the state, then the staged benefits
size_t state_bytes(int p) { return (size_t)32 * p + 4 * (size_t)((p + 31) / 32); }
size_t staged_bytes(int p, int g) { return state_bytes(p) + (size_t)4 * g * (p | 1); }

template <bool kStaged>
int launch(const Phases& ph, const void* cost, const void* num_gt, void* out, void* rounds, int n, int p, int g,
           int cap, size_t smem, cudaStream_t stream) {
  auto kernel = auction_kernel<kStaged>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n, kThreads, smem, stream>>>(static_cast<const float*>(cost), static_cast<const int32_t*>(num_gt), ph,
                                         static_cast<int32_t*>(out), static_cast<int32_t*>(rounds), p, g, cap);
  return (int)cudaGetLastError();
}

// dynamic shared bytes a CTA may take on the current device
cudaError_t shared_room(size_t* room) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *room = (size_t)optin - sizeof(float) * (kThreads / 32);  // less the static warp maxima
  return err;
}

}  // namespace

// cost [n, p, g] float32, num_gt [n] int32 (device); eps_rel [phases] on the
// host; out [n, p] int32 and rounds [n] int32 (device). g <= p <= 2048.
// The benefits are staged in shared memory where they fit (sized from the
// shapes, never from num_gt, which stays on the device), else read from L2.
extern "C" int di_auction_lap(const void* cost, const void* num_gt, const float* eps_rel, void* out,
                              void* rounds, int n, int p, int g, int phases, int cap, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  if (g > p || p > 2048 || phases < 0 || phases > kMaxPhases) return (int)cudaErrorInvalidValue;
  Phases ph{};
  for (int i = 0; i < phases; ++i) ph.eps_rel[i] = eps_rel[i];
  ph.n = phases;
  size_t room = 0;
  const cudaError_t err = shared_room(&room);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t staged = staged_bytes(p, g);
  if (staged <= room) return launch<true>(ph, cost, num_gt, out, rounds, n, p, g, cap, staged, s);
  return launch<false>(ph, cost, num_gt, out, rounds, n, p, g, cap, state_bytes(p), s);
}

// 1 where a [p, g] problem's benefits are staged in shared memory, 0 where
// they are read from L2, or a CUDA error code below 0
extern "C" int di_auction_lap_staged(int p, int g) {
  size_t room = 0;
  const cudaError_t err = shared_room(&room);
  if (err != cudaSuccess) return -(int)err;
  return staged_bytes(p, g) <= room ? 1 : 0;
}
