// Native host-side image augmentation (a copy of
// optwboundeigenval_tpu/native/augment.cpp; the arithmetic must stay the
// same, so that both packages augment a batch bit for bit alike).
//
// The reference pipelines its augmentations through torchvision
// transforms executed per-image in Python worker processes
// (usps_data.py:25-33, cifar_data.py:98-106).  These C++ functions do
// random crop-pad + bilinear rotation (the USPS recipe) and translate +
// horizontal flip (the CIFAR recipe) over a whole batch in one call, on
// the host, with no Python per-image overhead.  Exposed through a plain
// C ABI and loaded via ctypes (optwboundeigenval_tpu_torch/native/__init__.py).
//
// Layout: NHWC float32, contiguous.  Randomness: per-batch seeded
// splitmix64 generator — deterministic for a given seed (the same
// reproducibility contract as the numpy path, different stream).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    // splitmix64
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // uniform integer in [0, n)
  int64_t below(int64_t n) { return (int64_t)(uniform() * n); }
};

inline float sample_bilinear_clamped(const float* img, int H, int W, int C,
                                     float y, float x, int c) {
  // clamp-to-edge ("nearest" border mode)
  y = std::min(std::max(y, 0.0f), (float)(H - 1));
  x = std::min(std::max(x, 0.0f), (float)(W - 1));
  int y0 = (int)y, x0 = (int)x;
  int y1 = std::min(y0 + 1, H - 1), x1 = std::min(x0 + 1, W - 1);
  float fy = y - y0, fx = x - x0;
  const float v00 = img[(y0 * W + x0) * C + c];
  const float v01 = img[(y0 * W + x1) * C + c];
  const float v10 = img[(y1 * W + x0) * C + c];
  const float v11 = img[(y1 * W + x1) * C + c];
  return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
         v10 * fy * (1 - fx) + v11 * fy * fx;
}

}  // namespace

extern "C" {

// Random crop (after zero padding by `pad`) + random rotation of up to
// +-max_deg, bilinear, clamp-to-edge — the USPS aug recipe.
void crop_pad_rotate_f32(const float* in, float* out, int64_t B, int64_t H,
                         int64_t W, int64_t C, int pad, float max_deg,
                         uint64_t seed) {
  Rng rng(seed);
  const float pi = 3.14159265358979323846f;
  for (int64_t b = 0; b < B; ++b) {
    const float* img = in + b * H * W * C;
    float* dst = out + b * H * W * C;
    const int64_t oy = rng.below(2 * pad + 1) - pad;  // crop offset
    const int64_t ox = rng.below(2 * pad + 1) - pad;
    const float deg = (float)(rng.uniform() * 2.0 - 1.0) * max_deg;
    const float th = deg * pi / 180.0f;
    const float ct = std::cos(th), st = std::sin(th);
    const float cy = (H - 1) * 0.5f, cx = (W - 1) * 0.5f;
    for (int64_t y = 0; y < H; ++y) {
      for (int64_t x = 0; x < W; ++x) {
        // inverse rotation about center, then crop shift
        const float dy = (float)y - cy, dx = (float)x - cx;
        const float sy = ct * dy - st * dx + cy + (float)oy;
        const float sx = st * dy + ct * dx + cx + (float)ox;
        for (int64_t c = 0; c < C; ++c) {
          // zero padding outside the original image (crop-pad), edge
          // clamp inside (rotation border)
          float v;
          if (sy < -(float)pad || sy > (float)(H - 1 + pad) ||
              sx < -(float)pad || sx > (float)(W - 1 + pad)) {
            v = 0.0f;
          } else {
            v = sample_bilinear_clamped(img, (int)H, (int)W, (int)C, sy, sx,
                                        (int)c);
          }
          dst[(y * W + x) * C + c] = v;
        }
      }
    }
  }
}

// Random translation up to +-frac of the image size + random horizontal
// flip — the CIFAR aug recipe.
void translate_hflip_f32(const float* in, float* out, int64_t B, int64_t H,
                         int64_t W, int64_t C, float frac, uint64_t seed) {
  Rng rng(seed);
  for (int64_t b = 0; b < B; ++b) {
    const float* img = in + b * H * W * C;
    float* dst = out + b * H * W * C;
    const float ty = (float)(rng.uniform() * 2.0 - 1.0) * frac * H;
    const float tx = (float)(rng.uniform() * 2.0 - 1.0) * frac * W;
    const bool flip = rng.uniform() < 0.5;
    for (int64_t y = 0; y < H; ++y) {
      for (int64_t x = 0; x < W; ++x) {
        const float sy = (float)y - ty;
        const float sx0 = flip ? (float)(W - 1 - x) : (float)x;
        const float sx = sx0 - (flip ? -tx : tx);
        for (int64_t c = 0; c < C; ++c) {
          dst[(y * W + x) * C + c] = sample_bilinear_clamped(
              img, (int)H, (int)W, (int)C, sy, sx, (int)c);
        }
      }
    }
  }
}

// Gather rows into a contiguous batch (index-select) — the batch
// assembly step of the loader, GIL-free.
void gather_rows_f32(const float* in, const int64_t* idx, float* out,
                     int64_t n_idx, int64_t row_elems) {
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(out + i * row_elems, in + idx[i] * row_elems,
                sizeof(float) * row_elems);
  }
}

}  // extern "C"
