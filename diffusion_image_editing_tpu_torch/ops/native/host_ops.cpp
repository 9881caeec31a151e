// Native host-side ops for the data/preprocessing pipeline: the label merge
// of CelebAMask-HQ's part masks, a bilinear uint8 resize, ImageNet
// normalisation and the [-1, 1] image codec, exposed through ctypes.
//
// Build: ops/native/__init__.py (g++ -O3 -march=native -shared -fPIC, at
// first use, into the package's ignored ops/.build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Merge per-part CelebAMask-HQ annotation masks into one label map.
// parts: (n_parts, size*size) uint8, pixel==255 marker value `marker` (225)
// out:   (size*size) uint8; part i gets class id i+1, later parts win.
void die_merge_part_masks(const uint8_t* parts, int n_parts, int npix,
                          uint8_t marker, uint8_t* out) {
  std::memset(out, 0, npix);
  for (int p = 0; p < n_parts; ++p) {
    const uint8_t* src = parts + static_cast<int64_t>(p) * npix;
    const uint8_t cls = static_cast<uint8_t>(p + 1);
    for (int i = 0; i < npix; ++i) {
      if (src[i] == marker) out[i] = cls;
    }
  }
}

// Bilinear resize HWC uint8 -> HWC uint8 (half-pixel centers, like PIL/torch
// antialias=off).
void die_resize_bilinear_u8(const uint8_t* in, int ih, int iw, int c,
                            uint8_t* out, int oh, int ow) {
  const float sy = static_cast<float>(ih) / oh;
  const float sx = static_cast<float>(iw) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), ih - 1);
    int y1c = std::min(std::max(y0 + 1, 0), ih - 1);
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), iw - 1);
      int x1c = std::min(std::max(x0 + 1, 0), iw - 1);
      for (int k = 0; k < c; ++k) {
        float v00 = in[(y0c * iw + x0c) * c + k];
        float v01 = in[(y0c * iw + x1c) * c + k];
        float v10 = in[(y1c * iw + x0c) * c + k];
        float v11 = in[(y1c * iw + x1c) * c + k];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        out[(y * ow + x) * c + k] = static_cast<uint8_t>(
            std::min(std::max(v + 0.5f, 0.0f), 255.0f));
      }
    }
  }
}

// uint8 HWC -> float32 HWC, ImageNet-normalized ((x/255 - mean) / std).
void die_normalize_imagenet(const uint8_t* in, int npix, float* out) {
  static const float mean[3] = {0.485f, 0.456f, 0.406f};
  static const float istd[3] = {1.0f / 0.229f, 1.0f / 0.224f, 1.0f / 0.225f};
  for (int i = 0; i < npix; ++i) {
    for (int k = 0; k < 3; ++k) {
      out[i * 3 + k] = (in[i * 3 + k] * (1.0f / 255.0f) - mean[k]) * istd[k];
    }
  }
}

// uint8 HWC -> float32 HWC in [-1, 1] (the diffusion-image input codec).
void die_to_symmetric_range(const uint8_t* in, int64_t n, float* out) {
  constexpr float s = 2.0f / 255.0f;
  for (int64_t i = 0; i < n; ++i) out[i] = in[i] * s - 1.0f;
}

}  // extern "C"
