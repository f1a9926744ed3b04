// Fused post chain for Hopper (sm_90a): dark tweak -> chroma-bright tweak
// -> optional colormap -> clamp, one per-pixel program over interleaved
// (T, H, W, 3) float32 RGB.
//
// Replaces the TPU kernel havc_tpu/ops/pallas_kernels.py::
// _post_chain_pallas_impl (pixel math _post_math).  The plain PyTorch
// version is havc_tpu_torch/ops/post_chain.py::post_chain_reference; the
// kernel repeats its arithmetic operation for operation.
//
// Bound: bytes.  Each pixel is read once and written once, 24 B per pixel
// (12 in, 12 out), against roughly 150 flops of HSV arithmetic: far below
// the card's flops-per-byte balance.  Design: one thread per pixel in a
// grid-stride loop reading the NHWC tensor directly (no planar copy, no
// padding to tiles; the loop bound masks the ragged end), with every
// intermediate in registers, so device memory sees exactly one read and
// one write per pixel.
//
// Numerics: built without --use_fast_math and with -fmad=false, so
// division is IEEE, the v == r / v == g sextant tests see the same values
// as the plain version, and no multiply-add is contracted.  The ramp
// constants (banker's round in Python) and every scalar formed in Python
// doubles arrive precomputed in the parameter block.
#include <cuda_runtime.h>

#define MAX_RANGES 8

struct PostChainParams {
  float dark_sat, dark_vscale, dark_tresh, dark_grad;
  float sm_sat, sm_vscale, sm_tresh, sm_grad;
  int n_ranges;
  float lo[MAX_RANGES], hi[MAX_RANGES];
  float cmap_shift, cmap_sat, cmap_weight, cmap_keep;
};

// jnp.remainder: fmod with the sign fix-up toward the divisor
__device__ __forceinline__ float py_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ void rgb_to_hsv(float r, float g, float b,
                                           float& h, float& s, float& v) {
  v = fmaxf(fmaxf(r, g), b);
  float mn = fminf(fminf(r, g), b);
  float c = v - mn;
  float safe_c = c > 0.0f ? c : 1.0f;
  float h_r = py_mod(__fdiv_rn(g - b, safe_c), 6.0f);
  float h_g = __fadd_rn(__fdiv_rn(b - r, safe_c), 2.0f);
  float h_b = __fadd_rn(__fdiv_rn(r - g, safe_c), 4.0f);
  float hh = v == r ? h_r : (v == g ? h_g : h_b);
  h = c > 0.0f ? __fdiv_rn(hh, 6.0f) : 0.0f;
  s = v > 0.0f ? __fdiv_rn(c, v > 0.0f ? v : 1.0f) : 0.0f;
}

__device__ __forceinline__ void hsv_to_rgb(float h, float s, float v,
                                           float& r, float& g, float& b) {
  float h6 = py_mod(h, 1.0f) * 6.0f;
  float fi = floorf(h6);
  float f = h6 - fi;
  float p = v * (1.0f - s);
  float q = v * (1.0f - s * f);
  float t = v * (1.0f - s * (1.0f - f));
  int i = ((int)fi) % 6;
  if (i < 0) i += 6;
  switch (i) {
    case 0: r = v; g = t; b = p; break;
    case 1: r = q; g = v; b = p; break;
    case 2: r = p; g = v; b = t; break;
    case 3: r = p; g = q; b = v; break;
    case 4: r = t; g = p; b = v; break;
    default: r = v; g = p; b = q; break;
  }
}

// HSV tweak (S * sat, V * vscale) blended back toward the input by the
// clamped luma ramp ((255 y - tresh) * grad)
__device__ __forceinline__ void tweak_blend(float& r, float& g, float& b,
                                            float sat, float vscale,
                                            float tresh, float grad) {
  float h, s, v;
  rgb_to_hsv(r, g, b, h, s, v);
  float rd, gd, bd;
  hsv_to_rgb(h, clamp01(s * sat), clamp01(v * vscale), rd, gd, bd);
  float y = 0.299f * r + 0.587f * g + 0.114f * b;
  float w = clamp01((y * 255.0f - tresh) * grad);
  float k = 1.0f - w;
  r = rd * k + r * w;
  g = gd * k + g * w;
  b = bd * k + b * w;
}

__global__ void post_chain_kernel(const float* __restrict__ in,
                                  float* __restrict__ out, long long n,
                                  PostChainParams p) {
  long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float* px = in + 3 * i;
    float r = px[0], g = px[1], b = px[2];
    tweak_blend(r, g, b, p.dark_sat, p.dark_vscale, p.dark_tresh, p.dark_grad);
    tweak_blend(r, g, b, p.sm_sat, p.sm_vscale, p.sm_tresh, p.sm_grad);
    if (p.n_ranges > 0) {
      float h, s, v;
      rgb_to_hsv(r, g, b, h, s, v);
      float h_deg = h * 360.0f;
      // unrolled with constant indices: a loop bounded by n_ranges would
      // index the parameter arrays dynamically and make the compiler copy
      // the whole parameter block into per-thread local memory
      bool in_range = false;
#pragma unroll
      for (int k = 0; k < MAX_RANGES; ++k)
        if (k < p.n_ranges)
          in_range = in_range || (h_deg > p.lo[k] && h_deg < p.hi[k]);
      float rm, gm, bm;
      hsv_to_rgb(py_mod(h + p.cmap_shift, 1.0f), clamp01(s * p.cmap_sat), v,
                 rm, gm, bm);
      float m = in_range ? 1.0f : 0.0f;
      float km = 1.0f - m;
      float r3 = r * km + rm * m;
      float g3 = g * km + gm * m;
      float b3 = b * km + bm * m;
      if (p.cmap_weight > 0.0f) {
        r3 = r3 * p.cmap_keep + r * p.cmap_weight;
        g3 = g3 * p.cmap_keep + g * p.cmap_weight;
        b3 = b3 * p.cmap_keep + b * p.cmap_weight;
      }
      r = r3; g = g3; b = b3;
    }
    float* po = out + 3 * i;
    po[0] = clamp01(r);
    po[1] = clamp01(g);
    po[2] = clamp01(b);
  }
}

// C entry point for ctypes: launches on `stream` and returns
// cudaGetLastError() (0 on success).  The caller owns both buffers.
extern "C" int post_chain_launch(const void* in, void* out, long long n_pixels,
                                 const PostChainParams* params, void* stream) {
  if (n_pixels <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_pixels + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
  post_chain_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, n_pixels, *params);
  return (int)cudaGetLastError();
}
