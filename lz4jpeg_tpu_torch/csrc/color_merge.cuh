// The reference's YCbCr -> RGB merge (assemble_image, JPEG.c:598-604) as
// ops/color.py::ycbcr_planes_to_rgb runs it in float32, shared by the plane
// colour kernel (csrc/plane_color_kernel.cu) and the inverse megakernel
// (csrc/inv_megakernel.cu): each chroma term is one IEEE fp32 product of
// (float)c - 128.0f by the fp32 constant (1.402, 0.344136, 0.714136,
// 1.772), truncated toward zero to an int; R = y + cr_term, G = y - g_cb -
// g_cr, B = y + cb_term, each clamped to [0, 255].  The products are
// __fmul_rn, never contracted, so both kernels are bit-identical to the
// torch version.

#pragma once

#include <cstdint>

namespace color_merge {

struct Terms {
  int cr, g, cb;  // cr_term, g_cb + g_cr, cb_term
};

// The terms of chroma values given as fr = (float)cr - 128.0f and fb.
__device__ __forceinline__ Terms terms_of(float fr, float fb) {
  Terms t;
  t.cr = static_cast<int>(truncf(__fmul_rn(1.402f, fr)));
  t.g = static_cast<int>(truncf(__fmul_rn(0.344136f, fb))) +
        static_cast<int>(truncf(__fmul_rn(0.714136f, fr)));
  t.cb = static_cast<int>(truncf(__fmul_rn(1.772f, fb)));
  return t;
}

__device__ __forceinline__ Terms terms(uint32_t cr, uint32_t cb) {
  return terms_of(static_cast<float>(cr) - 128.0f,
                  static_cast<float>(cb) - 128.0f);
}

__device__ __forceinline__ uint32_t clamp255(int v) {
  return static_cast<uint32_t>(min(max(v, 0), 255));
}

}  // namespace color_merge
