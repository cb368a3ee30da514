// The port's native sweep reader: one call reads the key cloud and the
// chosen sweeps, moves each sweep into the key frame with its sensor2lidar
// rotation and translation in double precision (R.x + t, one cast to float),
// writes the timestamp deltas, range-filters, optionally shuffles
// (splitmix64 Fisher-Yates) and zero-pads to ``max_points`` rows with a
// validity mask. A copy of ``deepinteraction_tpu/data/native/points_io.cpp``,
// so the port's sweeps are the JAX package's bit for bit. Plain C ABI, bound
// with ctypes by ``__init__.py``, which builds it with
// ``g++ -O3 -shared -fPIC -ffp-contract=off``: no fused multiply-add on any
// host, so each product and sum rounds as in the reference's x86-64 build.
// Each cloud is read up to 400 000 rows.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    __uint128_t m = (__uint128_t)next() * (__uint128_t)n;
    return (uint64_t)(m >> 64);
  }
};

// read a float32 .bin of shape [-1, load_dim]; returns rows read (<= cap)
int read_cloud(const char* path, int load_dim, float* dst, int cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  size_t n = std::fread(dst, sizeof(float), (size_t)cap * load_dim, f);
  std::fclose(f);
  return (int)(n / load_dim);
}

}  // namespace

extern "C" {

// Assemble key cloud + sweeps into a padded static buffer.
//
//   paths:        num_clouds null-terminated strings (paths[0] = key frame)
//   rot:          num_clouds * 9 row-major 3x3 sensor2lidar rotations
//                 (identity for the key frame)
//   trans:        num_clouds * 3 translations
//   ts_delta:     num_clouds timestamp deltas (seconds; 0 for key)
//   pcr:          [xmin ymin zmin xmax ymax zmax] range filter
//   shuffle:      nonzero -> Fisher-Yates with `seed`
//   out:          max_points * load_dim floats (zero-padded)
//   mask:         max_points bytes (1 = valid)
// Returns the number of valid points, or -1 on read failure.
int assemble_points(const char** paths, int num_clouds, const double* rot,
                    const double* trans, const double* ts_delta, int load_dim,
                    const double* pcr, int shuffle, uint64_t seed, float* out,
                    uint8_t* mask, int max_points) {
  const int kMaxCloud = 400000;
  std::vector<float> buf((size_t)kMaxCloud * load_dim);
  int total = 0;
  for (int ci = 0; ci < num_clouds && total < max_points; ++ci) {
    int n = read_cloud(paths[ci], load_dim, buf.data(), kMaxCloud);
    if (n < 0) return -1;
    const double* R = rot + (size_t)ci * 9;
    const double* t = trans + (size_t)ci * 3;
    const bool is_key = ci == 0;
    const float dt = (float)ts_delta[ci];
    for (int i = 0; i < n && total < max_points; ++i) {
      const float* p = buf.data() + (size_t)i * load_dim;
      double x = p[0], y = p[1], z = p[2];
      double tx, ty, tz;
      if (is_key) {
        tx = x; ty = y; tz = z;
      } else {
        tx = R[0] * x + R[1] * y + R[2] * z + t[0];
        ty = R[3] * x + R[4] * y + R[5] * z + t[1];
        tz = R[6] * x + R[7] * y + R[8] * z + t[2];
      }
      if (tx < pcr[0] || tx > pcr[3] || ty < pcr[1] || ty > pcr[4] ||
          tz < pcr[2] || tz > pcr[5])
        continue;
      float* q = out + (size_t)total * load_dim;
      q[0] = (float)tx;
      q[1] = (float)ty;
      q[2] = (float)tz;
      for (int d = 3; d < load_dim; ++d) q[d] = p[d];
      if (load_dim >= 5) q[4] = dt;  // sweep time lag; 0 for key frame
      ++total;
    }
  }
  if (shuffle && total > 1) {
    SplitMix64 rng(seed);
    for (int i = total - 1; i > 0; --i) {
      int j = (int)rng.bounded((uint64_t)(i + 1));
      float tmp[16];
      float* a = out + (size_t)i * load_dim;
      float* b = out + (size_t)j * load_dim;
      std::memcpy(tmp, a, sizeof(float) * load_dim);
      std::memcpy(a, b, sizeof(float) * load_dim);
      std::memcpy(b, tmp, sizeof(float) * load_dim);
    }
  }
  std::memset(out + (size_t)total * load_dim, 0,
              sizeof(float) * (size_t)(max_points - total) * load_dim);
  std::memset(mask, 1, total);
  std::memset(mask + total, 0, max_points - total);
  return total;
}

}  // extern "C"
