// The sparse middle encoder's neighbour tables, built on the card: the
// dense index map, the neighbour table of a submanifold or a strided conv,
// the banded plan's overflow flag, the output sites of a strided conv and
// a strided table's inverse.
//
// Replaces no Pallas kernel: the JAX package builds these tables with XLA
// ops inside its jitted forward (deepinteraction_tpu/ops/sparse_conv.py,
// sparse_conv_banded.py::make_banded_plan), which XLA fuses into a few
// programs. Run op by op in PyTorch (ops/sparse_conv.py's plain versions)
// the same arithmetic is some 27 small ops for each of a table's 27 taps,
// plus three boolean-mask reads that each wait for the device: on a
// realistic fusion_base frame about 6 000 of its 10 003 launches and 20 of
// its 62 host syncs, 183 host ms of a 390 ms traced frame against 11.7 ms
// of device work, the card idle in between (an H100 80GB HBM3). These
// kernels do the same work in a few launches a table and never read a
// value back to the host.
//
// Bound on the H100: bytes. The arithmetic is a few integer operations an
// element. The compulsory traffic of one table is the dense map's fill and
// scatter (the 41 x 1440 x 1440 stage-0 grid is 340 MB, 0.10 ms at 3.35
// TB/s; the later stages' maps 43, 5.7 and 0.7 MB), the coords read once
// and the [Ko, D] table written once (160 000 x 27 x 4 B = 17 MB at stage
// 0); the map's reads are one int a tap, scattered over a few rows of the
// map around each site. A stage's submanifold and strided tables look up
// the same map, but each wrapper builds its own (the encoder calls them
// apart), so a frame fills eight maps where four would do. What the
// design does about it:
//
// - The map is filled with int4 stores by a grid-stride kernel sized to
//   the card, then one thread a row scatters its row number. Valid coords
//   are unique, so the map holds the plain version's bits, with no
//   compaction and no mask.
// - One lookup kernel serves both table kinds: a thread a table element,
//   so that a row's taps are written contiguously and the stores coalesce;
//   a row's coords are read by its D threads from the same cache lines. A
//   submanifold table is the case stride 1, padding kernel / 2, the output
//   coords the input's.
// - The overflow flag reads the table once, a block a tile of rows: the
//   nine (dz, dy) groups' smallest and largest hit by shared-memory
//   atomics, then a store of true into the flag where a group's largest
//   hit lies the window or more past its 8-aligned start. Every store
//   writes the same value, so their order does not matter.
// - The output sites of a strided conv are marked in an occupancy bitmask
//   over the output grid (a bit a cell: 1.4 MB at stage 0's 21 x 720 x
//   720), each valid input site setting the bits of its up to 8 candidate
//   outputs. A stream compaction over the bitmask (count a block, scan the
//   counts in one block, write each set bit at its rank) then yields the
//   linear ids sorted and deduplicated, with no sort; ranks past the
//   capacity are dropped, which keeps the smallest ids, and the rows past
//   the count are written as (0, 0, 0), not valid. The count stays on the
//   card.
// - A strided table's inverse is a fill and a scatter, a thread a table
//   element: each (input row, tap) is reached at most once.
//
// Every entry launches on the caller's stream, allocates nothing (the
// wrapper passes the outputs and the scratch) and returns the CUDA error
// code of its launches.

#include <limits.h>
#include <stdint.h>

namespace {

// threads a block; the compaction gives each thread one word of the
// bitmask, so that its serial walk over the set bits is at most 32 long and
// a warp's stores fall on neighbouring ranks
constexpr int kThreads = 256;
// blocks of the grid-stride fill: enough to keep every SM's memory pipe busy
constexpr int kFillBlocks = 132 * 8;

// the geometry of a conv over a grid: kernel, stride, padding, and the
// input grid (lookup) or the output grid (downsampling), z y x each
struct Geometry {
  int k[3], s[3], p[3], n[3];
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void fill_kernel(int* __restrict__ out, long long n, int value) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int4* out4 = reinterpret_cast<int4*>(out);
  const int4 v = make_int4(value, value, value, value);
  for (long long i = first; i < n4; i += stride) out4[i] = v;
  for (long long i = 4 * n4 + first; i < n; i += stride) out[i] = value;
}

__global__ void scatter_rows_kernel(const int* __restrict__ coords, const bool* __restrict__ valid,
                                    int* __restrict__ dense, int k, int nz, int ny, int nx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k || !valid[i]) return;
  const int z = coords[3 * i], y = coords[3 * i + 1], x = coords[3 * i + 2];
  if (z < 0 || z >= nz || y < 0 || y >= ny || x < 0 || x >= nx) return;
  dense[((long long)z * ny + y) * nx + x] = i;
}

// table[i, d]: the row at out_coords[i] * stride - padding + offset(d), or
// `miss` where the output row is not valid, the tap leaves the grid or the
// site is empty (ops/sparse_conv.py::_lookup)
__global__ void lookup_kernel(const int* __restrict__ dense, const int* __restrict__ oc,
                              const bool* __restrict__ ok, int* __restrict__ table, int ko, int miss,
                              Geometry g) {
  const int taps = g.k[0] * g.k[1] * g.k[2];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // ko * taps fits an int (the entry checks)
  if (e >= ko * taps) return;
  const int i = e / taps;
  const int d = e - i * taps;
  int v = miss;
  if (ok[i]) {
    const int dz = d / (g.k[1] * g.k[2]);
    const int r = d - dz * g.k[1] * g.k[2];
    const int dy = r / g.k[2], dx = r - dy * g.k[2];
    const int tz = oc[3 * i] * g.s[0] - g.p[0] + dz;
    const int ty = oc[3 * i + 1] * g.s[1] - g.p[1] + dy;
    const int tx = oc[3 * i + 2] * g.s[2] - g.p[2] + dx;
    if (tz >= 0 && tz < g.n[0] && ty >= 0 && ty < g.n[1] && tx >= 0 && tx < g.n[2])
      v = dense[((long long)tz * g.n[1] + ty) * g.n[2] + tx];
  }
  table[e] = v;
}

// one block a tile of t rows of a [k, 27] table
__global__ void banded_overflow_kernel(const int* __restrict__ nbr, const bool* __restrict__ valid,
                                       bool* __restrict__ flag, int k, int t, int w, int start_hi) {
  __shared__ int lo[9], hi[9];
  if (threadIdx.x < 9) {
    lo[threadIdx.x] = INT_MAX;
    hi[threadIdx.x] = -1;
  }
  __syncthreads();
  const int r0 = blockIdx.x * t;  // k * 27 fits an int (the entry checks)
  const int end = min(r0 + t, k) * 27;
  for (int e = r0 * 27 + threadIdx.x; e < end; e += blockDim.x) {
    const int v = nbr[e];
    const int row = e / 27;
    if (v == k || !valid[row]) continue;
    const int grp = (e - row * 27) / 3;
    atomicMin(&lo[grp], v);
    atomicMax(&hi[grp], v);
  }
  __syncthreads();
  if (threadIdx.x < 9 && hi[threadIdx.x] >= 0) {
    const int start = max(0, min(lo[threadIdx.x] & ~7, start_hi));
    if (hi[threadIdx.x] - start >= w) *flag = true;
  }
}

// the up to two output positions along one axis that a site at x reaches
// (ops/sparse_conv.py::downsample_candidates' axis_candidates)
__device__ __forceinline__ int axis_candidates(int x, int k, int s, int p, int n_out, int c[2]) {
  const int hi = floor_div(x + p, s);
  const int lo = -floor_div(-(x + p - k + 1), s);
  int n = 0;
  if (hi >= lo && hi >= 0 && hi < n_out) c[n++] = hi;
  const int c1 = max(hi - 1, lo);
  if (c1 < hi && c1 >= 0 && c1 < n_out) c[n++] = c1;
  return n;
}

__global__ void mark_sites_kernel(const int* __restrict__ coords, const bool* __restrict__ valid,
                                  unsigned* __restrict__ bits, int k, Geometry g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k || !valid[i]) return;
  int cz[2], cy[2], cx[2];
  const int nz = axis_candidates(coords[3 * i], g.k[0], g.s[0], g.p[0], g.n[0], cz);
  const int ny = axis_candidates(coords[3 * i + 1], g.k[1], g.s[1], g.p[1], g.n[1], cy);
  const int nx = axis_candidates(coords[3 * i + 2], g.k[2], g.s[2], g.p[2], g.n[2], cx);
  for (int a = 0; a < nz; ++a)
    for (int b = 0; b < ny; ++b)
      for (int c = 0; c < nx; ++c) {
        const long long id = ((long long)cz[a] * g.n[1] + cy[b]) * g.n[2] + cx[c];
        atomicOr(&bits[id >> 5], 1u << (id & 31));
      }
}

// exclusive prefix sum of v over the block (blockDim.x a multiple of 32),
// and the block's total; every thread of the block must call it
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[warps - 1];
  __syncthreads();  // warp_sums is free for the next call
  return before + x - v;
}

// this thread's word of the bitmask (0 past its end)
__device__ __forceinline__ unsigned load_word(const unsigned* bits, long long nwords, long long* index) {
  *index = (long long)blockIdx.x * kThreads + threadIdx.x;
  return *index < nwords ? bits[*index] : 0u;
}

__global__ void count_sites_kernel(const unsigned* __restrict__ bits, int* __restrict__ counts, long long nwords) {
  long long index;
  int total;
  block_exclusive_scan(__popc(load_word(bits, nwords, &index)), &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// offsets[b] = sum of counts[:b]; offsets[nb] = the total (one block)
__global__ void scan_counts_kernel(const int* __restrict__ counts, int* __restrict__ offsets, int nb) {
  int carry = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int total;
    const int ex = block_exclusive_scan(i < nb ? counts[i] : 0, &total);
    if (i < nb) offsets[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) offsets[nb] = carry;
}

// each set bit, in order, at its rank below cap as (z, y, x) and valid;
// the slots from the count up to cap as (0, 0, 0) and not valid
__global__ void write_sites_kernel(const unsigned* __restrict__ bits, const int* __restrict__ offsets,
                                   int* __restrict__ oc, bool* __restrict__ ov, long long nwords, int nb,
                                   int cap, int ony, int onx) {
  long long index;
  int total;
  unsigned word = load_word(bits, nwords, &index);
  int rank = offsets[blockIdx.x] + block_exclusive_scan(__popc(word), &total);
  const unsigned plane = (unsigned)ony * onx;  // the grid's cells < 2^32 (the entry checks)
  for (; word != 0u && rank < cap; word &= word - 1u, ++rank) {
    const unsigned id = (unsigned)index * 32u + (unsigned)(__ffs(word) - 1);
    const unsigned yx = id % plane;
    oc[3 * rank] = (int)(id / plane);
    oc[3 * rank + 1] = (int)(yx / onx);
    oc[3 * rank + 2] = (int)(yx % onx);
    ov[rank] = true;
  }
  const int n_out = min(offsets[nb], cap);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += stride) {
    if (s < n_out) continue;
    oc[3 * s] = 0;
    oc[3 * s + 1] = 0;
    oc[3 * s + 2] = 0;
    ov[s] = false;
  }
}

// inv[nbr[i, d], d] = i for each hit of the [ko, taps] table (a miss,
// nbr = k_in, writes nothing)
__global__ void scatter_inverse_kernel(const int* __restrict__ nbr, int* __restrict__ inv, int ko, int taps,
                                       int k_in) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // ko * taps fits an int (the entry checks)
  if (e >= ko * taps) return;
  const int j = nbr[e];
  if (j < 0 || j >= k_in) return;
  const int i = e / taps;
  inv[(long long)j * taps + (e - i * taps)] = i;
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

inline int fill(int* out, long long n, int value, cudaStream_t s) {
  if (n <= 0) return 0;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  fill_kernel<<<(unsigned)(want < 1 ? 1 : want < kFillBlocks ? want : kFillBlocks), kThreads, 0, s>>>(out, n, value);
  return (int)cudaGetLastError();
}

inline Geometry geometry(const int* g) {
  Geometry out;
  for (int a = 0; a < 3; ++a) {
    out.k[a] = g[a];
    out.s[a] = g[3 + a];
    out.p[a] = g[6 + a];
    out.n[a] = g[9 + a];
  }
  return out;
}

inline long long words_of(long long cells) { return (cells + 31) / 32; }
inline int blocks_of_words(long long words) { return (int)((words + kThreads - 1) / kThreads); }

}  // namespace

// dense [nz*ny*nx] int32 (16-byte aligned): k everywhere, then the row of
// each valid site at its linear id. 2 launches.
extern "C" int di_dense_index_map(const void* coords, const void* valid, void* dense, int k, int nz, int ny,
                                  int nx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(dense) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int err = fill(static_cast<int*>(dense), (long long)nz * ny * nx, k, s);
  if (err != 0 || k <= 0) return err;
  scatter_rows_kernel<<<blocks_for(k), kThreads, 0, s>>>(static_cast<const int*>(coords),
                                                          static_cast<const bool*>(valid),
                                                          static_cast<int*>(dense), k, nz, ny, nx);
  return (int)cudaGetLastError();
}

// table [ko, kz*ky*kx] int32 over a dense map of the input grid; geom: the
// kernel, stride, padding and input grid, z y x each. 1 launch.
extern "C" int di_neighbor_table(const void* dense, const void* out_coords, const void* out_valid, void* table,
                                 int ko, int miss, const int* geom, void* stream) {
  const Geometry g = geometry(geom);
  const long long n = (long long)ko * g.k[0] * g.k[1] * g.k[2];
  if (n <= 0) return 0;
  if (n > INT_MAX - kThreads) return (int)cudaErrorInvalidValue;
  lookup_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dense), static_cast<const int*>(out_coords), static_cast<const bool*>(out_valid),
      static_cast<int*>(table), ko, miss, g);
  return (int)cudaGetLastError();
}

// flag [] bool: false, then true where a tile of t rows of the [k, 27]
// table overflows its window of w (start_hi: the largest window start). A
// memset and 1 launch.
extern "C" int di_banded_overflow(const void* nbr, const void* valid, void* flag, int k, int t, int w,
                                  int start_hi, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flag, 0, 1, s);
  if (err != cudaSuccess || k <= 0) return (int)err;
  if (t <= 0 || (long long)k * 27 > INT_MAX - kThreads) return (int)cudaErrorInvalidValue;
  banded_overflow_kernel<<<(unsigned)((k + t - 1) / t), kThreads, 0, s>>>(
      static_cast<const int*>(nbr), static_cast<const bool*>(valid), static_cast<bool*>(flag), k, t, w, start_hi);
  return (int)cudaGetLastError();
}

// out_coords [cap, 3] int32 and out_valid [cap] bool: the output sites of
// a strided conv, sorted by linear id, deduplicated, the smallest cap kept;
// geom: the kernel, stride, padding and output grid, z y x each. scratch:
// words + 2 nb + 1 int32 (words = cells / 32 rounded up, nb = words /
// kThreads rounded up, at least 1): the bitmask, the blocks' counts and
// their offsets. A memset and 4 launches.
extern "C" int di_downsample_sites(const void* coords, const void* valid, void* scratch, void* out_coords,
                                   void* out_valid, int k, int cap, const int* geom, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(geom);
  const long long cells = (long long)g.n[0] * g.n[1] * g.n[2];
  if (cells > UINT_MAX) return (int)cudaErrorInvalidValue;
  const long long words = words_of(cells);
  const int nb = blocks_of_words(words) > 0 ? blocks_of_words(words) : 1;
  unsigned* bits = static_cast<unsigned*>(scratch);
  int* counts = static_cast<int*>(scratch) + words;
  int* offsets = counts + nb;
  cudaError_t err = cudaMemsetAsync(bits, 0, words * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  if (k > 0) {
    mark_sites_kernel<<<blocks_for(k), kThreads, 0, s>>>(static_cast<const int*>(coords),
                                                          static_cast<const bool*>(valid), bits, k, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  count_sites_kernel<<<nb, kThreads, 0, s>>>(bits, counts, words);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_counts_kernel<<<1, 1024, 0, s>>>(counts, offsets, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  write_sites_kernel<<<nb, kThreads, 0, s>>>(bits, offsets, static_cast<int*>(out_coords),
                                             static_cast<bool*>(out_valid), words, nb, cap, g.n[1], g.n[2]);
  return (int)cudaGetLastError();
}

// inv [k_in, taps] int32: ko everywhere, then inv[nbr[i, d], d] = i for
// each hit of the [ko, taps] table. 2 launches.
extern "C" int di_inverse_table(const void* nbr, void* inv, int ko, int taps, int k_in, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(inv) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int err = fill(static_cast<int*>(inv), (long long)k_in * taps, ko, s);
  const long long n = (long long)ko * taps;
  if (err != 0 || n <= 0) return err;
  if (n > INT_MAX - kThreads) return (int)cudaErrorInvalidValue;
  scatter_inverse_kernel<<<blocks_for(n), kThreads, 0, s>>>(static_cast<const int*>(nbr), static_cast<int*>(inv),
                                                             ko, taps, k_in);
  return (int)cudaGetLastError();
}
