// Native host preprocessing: fused normalize + patchify.
//
// The host-side data loader. Replaces the reference's
// Python/torch preprocessing chain (Qwen2VLImageProcessor rescale ->
// normalize -> reshape -> transpose, plus the aux CLIP processor) with
// single-pass C++ over the uint8 image: one read of each pixel, writes
// straight into the final patch-major layout the ViT consumes. Exposed via
// ctypes (vlm_fo1_tpu_torch/native/__init__.py); the numpy path in
// preprocess/image.py agrees to 1e-6 (it divides by std where this
// multiplies by 1/std).
//
// Layouts:
//   input : uint8 HWC (H, W, 3), already resized
//   qwen  : float32 [grid_h*grid_w, C*T*ph*pw] rows ordered
//           (h_block, w_block, merge_h, merge_w), channel-major within a row
//           (C, T, ph, pw) — matches HF Qwen2VLImageProcessor flattening
//   aux   : float32 CHW

#include <cstdint>
#include <cstddef>

extern "C" {

// Fused (x/255 - mean)/std + Qwen patchify.
// pixel_values must hold grid_h*grid_w * 3*temporal*patch*patch floats.
void qwen_patchify_u8(
    const uint8_t* img,      // [H, W, 3]
    int64_t h, int64_t w,
    int64_t patch, int64_t merge, int64_t temporal,
    const float* mean,       // [3]
    const float* inv_std,    // [3] = 1/std
    float* pixel_values) {
  const int64_t grid_h = h / patch;
  const int64_t grid_w = w / patch;
  const int64_t row_len = 3 * temporal * patch * patch;
  const int64_t plane = temporal * patch * patch;  // per-channel chunk

  for (int64_t hb = 0; hb < grid_h / merge; ++hb) {
    for (int64_t wb = 0; wb < grid_w / merge; ++wb) {
      for (int64_t mh = 0; mh < merge; ++mh) {
        for (int64_t mw = 0; mw < merge; ++mw) {
          const int64_t gy = hb * merge + mh;   // patch row
          const int64_t gx = wb * merge + mw;   // patch col
          const int64_t out_row =
              ((hb * (grid_w / merge) + wb) * merge + mh) * merge + mw;
          float* out = pixel_values + out_row * row_len;
          for (int64_t py = 0; py < patch; ++py) {
            const uint8_t* src = img + ((gy * patch + py) * w
                                        + gx * patch) * 3;
            for (int64_t px = 0; px < patch; ++px) {
              const uint8_t* p = src + px * 3;
              for (int64_t c = 0; c < 3; ++c) {
                const float v = ((float)p[c] / 255.0f - mean[c]) * inv_std[c];
                // channel c, all temporal repeats, position (py, px)
                for (int64_t t = 0; t < temporal; ++t) {
                  out[c * plane + t * patch * patch + py * patch + px] = v;
                }
              }
            }
          }
        }
      }
    }
  }
}

// Fused normalize to CHW float32 (aux/DaViT branch).
void normalize_chw_u8(
    const uint8_t* img,      // [H, W, 3]
    int64_t h, int64_t w,
    const float* mean, const float* inv_std,
    float* out) {            // [3, H, W]
  const int64_t hw = h * w;
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const uint8_t* p = img + (y * w + x) * 3;
      const int64_t o = y * w + x;
      out[o] = ((float)p[0] / 255.0f - mean[0]) * inv_std[0];
      out[hw + o] = ((float)p[1] / 255.0f - mean[1]) * inv_std[1];
      out[2 * hw + o] = ((float)p[2] / 255.0f - mean[2]) * inv_std[2];
    }
  }
}

// Raw uint8 patchify (no normalize): layout transform for the
// device-normalize path — raw pixels ship to the card at 1 byte each and
// the /255-mean-std affine fuses into patch embed on device.
void qwen_patchify_u8_raw(
    const uint8_t* img,      // [H, W, 3]
    int64_t h, int64_t w,
    int64_t patch, int64_t merge, int64_t temporal,
    uint8_t* pixel_values) { // [grid_h*grid_w, 3*T*patch*patch]
  const int64_t grid_h = h / patch;
  const int64_t grid_w = w / patch;
  const int64_t row_len = 3 * temporal * patch * patch;
  const int64_t plane = temporal * patch * patch;

  for (int64_t hb = 0; hb < grid_h / merge; ++hb) {
    for (int64_t wb = 0; wb < grid_w / merge; ++wb) {
      for (int64_t mh = 0; mh < merge; ++mh) {
        for (int64_t mw = 0; mw < merge; ++mw) {
          const int64_t gy = hb * merge + mh;
          const int64_t gx = wb * merge + mw;
          const int64_t out_row =
              ((hb * (grid_w / merge) + wb) * merge + mh) * merge + mw;
          uint8_t* out = pixel_values + out_row * row_len;
          for (int64_t py = 0; py < patch; ++py) {
            const uint8_t* src = img + ((gy * patch + py) * w
                                        + gx * patch) * 3;
            for (int64_t px = 0; px < patch; ++px) {
              const uint8_t* p = src + px * 3;
              for (int64_t c = 0; c < 3; ++c) {
                const uint8_t v = p[c];
                for (int64_t t = 0; t < temporal; ++t) {
                  out[c * plane + t * patch * patch + py * patch + px] = v;
                }
              }
            }
          }
        }
      }
    }
  }
}

}  // extern "C"
