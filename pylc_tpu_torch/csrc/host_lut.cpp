// Host-side palette look-ups of the PyTorch port: class map -> RGB mask
// (colourize) and RGB mask -> class map (class_encode).
//
// Host code, not a GPU kernel: the device hands back a uint8 class map
// (one byte per pixel), and expanding it to RGB on the host keeps the copy
// from the device three times smaller; ground-truth masks are encoded on
// the host while the device runs the forward pass.  Same semantics as the
// JAX package's native/pylc_host.cpp (colourize_u8, class_encode_u8), which
// the port does not load.
//
// Build: g++ -O3 -shared -fPIC (pylc_tpu_torch/ops/kernels/_build.py);
// bound with ctypes in pylc_tpu_torch/native.py.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

inline uint32_t rgb_key(const uint8_t* p) {
  return (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | uint32_t(p[2]);
}

// above this many pixels a 16 MiB direct table over all 2^24 colours pays
// for building it; below, a scan of the palette per pixel
constexpr int64_t kLutPixels = 1 << 20;

}  // namespace

extern "C" {

// cm [n_px] u8, palette [n_classes, 3] u8 -> out [n_px, 3] u8.  A class
// index outside the palette takes colour 0.
void host_colourize_u8(const uint8_t* cm, int64_t n_px,
                       const uint8_t* palette, int32_t n_classes,
                       uint8_t* out) {
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t c = cm[i] < n_classes ? cm[i] : 0;
    const uint8_t* pc = palette + int64_t(c) * 3;
    uint8_t* o = out + i * 3;
    o[0] = pc[0];
    o[1] = pc[1];
    o[2] = pc[2];
  }
}

// rgb [n_px, 3] u8, palette [n_classes, 3] u8 -> out [n_px] u8.  A colour
// that is not in the palette gets default_class (the reference's quirk:
// class 1, utils/tools.py:437); of two equal palette colours the first
// wins.
void host_class_encode_u8(const uint8_t* rgb, int64_t n_px,
                          const uint8_t* palette, int32_t n_classes,
                          uint8_t default_class, uint8_t* out) {
  if (n_px >= kLutPixels) {
    std::vector<uint8_t> lut(std::size_t(1) << 24, default_class);
    for (int32_t c = n_classes - 1; c >= 0; --c) {
      lut[rgb_key(palette + c * 3)] = uint8_t(c);
    }
    for (int64_t i = 0; i < n_px; ++i) out[i] = lut[rgb_key(rgb + i * 3)];
    return;
  }
  for (int64_t i = 0; i < n_px; ++i) {
    const uint32_t key = rgb_key(rgb + i * 3);
    uint8_t cls = default_class;
    for (int32_t c = 0; c < n_classes; ++c) {
      if (rgb_key(palette + c * 3) == key) {
        cls = uint8_t(c);
        break;
      }
    }
    out[i] = cls;
  }
}

}  // extern "C"
