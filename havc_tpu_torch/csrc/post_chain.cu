// Fused post chain for Hopper (sm_90a): dark tweak -> chroma-bright tweak
// -> optional colormap -> clamp, one per-pixel program over interleaved
// (T, H, W, 3) float32 RGB.
//
// Replaces the TPU kernel havc_tpu/ops/pallas_kernels.py::
// _post_chain_pallas_impl (pixel math _post_math).  The plain PyTorch
// version is havc_tpu_torch/ops/post_chain.py::post_chain_reference; the
// kernel gives the same value for every pixel as the arithmetic of that
// version, rounded operation by operation.
//
// Bound: bytes by the card's peak rates (24 B per pixel: 12 in, 12 out,
// against ~150 flops), but instruction issue in practice: each pixel
// runs a long chain of IEEE divisions, remainders and selects, and in
// the 7.2 ps that 24 B take at 3.35 TB/s the card issues only ~240
// thread instructions (132 SMs x 4 warp instructions a clock x 32 lanes
// at 1.98 GHz); with its data in L2 the kernel is no faster per pixel.
//
// Design: each thread takes 4 pixels at a time (48 B: three 16-byte
// streaming loads and stores), runs the four independent pixel programs
// in one loop trip, and loops over the tensor in a grid sized from the
// kernel's occupancy on this card; the up to 3 pixels before the first
// 16-byte boundary and the up to 3 after the last group go one per
// thread.  Arithmetic: one IEEE division for the hue numerator that is
// selected (not three), and range-limited forms of the remainders, each
// with its proof below and checked against the generic form over every
// float of its range on the card (post_chain_check_forms).  This replaces
// the first design: one thread per pixel with three 4-byte loads and
// stores at a 12-byte stride, three hue divisions and two fmodf per
// tweak, and a switch over the sextant, in a fixed 132 x 32 grid.
//
// Numerics: built without --use_fast_math and with -fmad=false, so
// division is IEEE, the v == r / v == g sextant tests see the same values
// as the plain version, and no multiply-add is contracted.  The ramp
// constants (banker's round in Python) and every scalar formed in Python
// doubles arrive precomputed in the parameter block.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_RANGES 8
#define PIX 4          // pixels per thread and step: three float4 each way
#define THREADS 256

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

// py_mod(x, 6) for x in [-1, 1] or NaN, the hue numerator over the chroma:
// |x| < 6, so fmodf(x, 6) is x exactly, and the fix-up adds 6 when x < 0;
// x + -0 is x, -0 and NaN included.  The addend alone lets rgb_to_hsv
// fold it into the addition of its other two sextants.
__device__ __forceinline__ float mod6_addend(float x) { return x < 0.0f ? 6.0f : -0.0f; }
__device__ __forceinline__ float py_mod6_unit(float x) { return __fadd_rn(x, mod6_addend(x)); }

// py_mod(h, 1) for h in [0, 1] or NaN, every hue hsv_to_rgb is given:
// fmodf(h, 1) is h below 1 and +0 at 1, never negative, so the fix-up
// never fires; -0 and NaN pass through both forms.
__device__ __forceinline__ float py_mod1_unit(float h) { return h < 1.0f ? h : h - 1.0f; }

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// The quotient (g - b) / c, (b - r) / c or (r - g) / c lies in [-1, 1] or
// is NaN: the numerator is a difference of two of the channels, c the
// difference of their maximum and minimum, and rounding is monotone, so
// |fl(num)| <= fl(c) (c = 0 gives a 0 numerator over 1).  Only the
// numerator that the sextant test selects is divided: the selected
// quotient is the same IEEE division of the same operands.
__device__ __forceinline__ void rgb_to_hsv(float r, float g, float b,
                                           float& h, float& s, float& v) {
  v = fmaxf(fmaxf(r, g), b);
  float mn = fminf(fminf(r, g), b);
  float c = v - mn;
  float safe_c = c > 0.0f ? c : 1.0f;
  const bool is_r = v == r, is_g = v == g;
  float q = __fdiv_rn(is_r ? g - b : (is_g ? b - r : r - g), safe_c);
  // py_mod6_unit(q), q + 2 or q + 4 as one addition
  float hh = __fadd_rn(q, is_r ? mod6_addend(q) : (is_g ? 2.0f : 4.0f));
  // both divisions run for every pixel and the select follows, so that no
  // branch surrounds them
  float h6 = __fdiv_rn(hh, 6.0f);
  float sv = __fdiv_rn(c, v > 0.0f ? v : 1.0f);
  h = c > 0.0f ? h6 : 0.0f;
  s = v > 0.0f ? sv : 0.0f;
}

// The sextant of h in [0, 1] or NaN: h6 = py_mod1_unit(h) * 6 < 6 (the
// largest float below 1 times 6 rounds to 6 - 2^-21), so floor(h6) is in
// 0..5, where "% 6" and its sign fix-up are the identity; NaN converts
// to 0 either way.
__device__ __forceinline__ void hsv_to_rgb(float h, float s, float v,
                                           float& r, float& g, float& b) {
  float h6 = py_mod1_unit(h) * 6.0f;
  float fi = floorf(h6);
  float f = h6 - fi;
  float p = v * (1.0f - s);
  float q = v * (1.0f - s * f);
  float t = v * (1.0f - s * (1.0f - f));
  // (r, g, b) by sextant (0: v t p, 1: q v p, 2: p v t, 3: p q v, 4: t p
  // v, else v p q) as selects: the four pixels of a thread, and the lanes
  // of a warp, take different sextants, and a switch's branches diverge
  const int i = (int)fi;
  r = i == 1 ? q : (i == 2 || i == 3) ? p : i == 4 ? t : v;
  g = i == 0 ? t : (i == 1 || i == 2) ? v : i == 3 ? q : p;
  b = (i == 0 || i == 1) ? p : i == 2 ? t : (i == 3 || i == 4) ? v : q;
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

__device__ __forceinline__ void pixel(float& r, float& g, float& b, const PostChainParams& p) {
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
    // h + shift lies in [-1, 2]: the generic remainder; its result is in
    // [0, 1], as hsv_to_rgb needs
    hsv_to_rgb(py_mod(h + p.cmap_shift, 1.0f), clamp01(s * p.cmap_sat), v, rm, gm, bm);
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
  r = clamp01(r);
  g = clamp01(g);
  b = clamp01(b);
}

// Pixels [0, head) and [tail, n) one per thread; the groups of PIX pixels
// in between, whose input starts on a 16-byte boundary, in a grid-stride
// loop.  The output is stored as float4 when it shares the input's
// alignment (vec_out), else one float at a time.
__global__ void __launch_bounds__(THREADS)
post_chain_kernel(const float* __restrict__ in, float* __restrict__ out, long long n, int head,
                  int vec_out, PostChainParams p) {
  const long long n_groups = (n - head) / PIX;
  const long long tail = head + n_groups * PIX;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (gid < head + (n - tail)) {
    const long long i = gid < head ? gid : tail + (gid - head);
    float r = in[3 * i], g = in[3 * i + 1], b = in[3 * i + 2];
    pixel(r, g, b, p);
    out[3 * i] = r;
    out[3 * i + 1] = g;
    out[3 * i + 2] = b;
  }
  const float4* in4 = reinterpret_cast<const float4*>(in + 3 * head);
  for (long long grp = gid; grp < n_groups; grp += stride) {
    float x[3 * PIX];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float4 f = __ldcs(in4 + 3 * grp + j);
      x[4 * j] = f.x; x[4 * j + 1] = f.y; x[4 * j + 2] = f.z; x[4 * j + 3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < PIX; ++j) pixel(x[3 * j], x[3 * j + 1], x[3 * j + 2], p);
    float* o = out + 3 * (head + PIX * grp);
    if (vec_out) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        __stcs(reinterpret_cast<float4*>(o) + j,
               make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < 3 * PIX; ++j) o[j] = x[j];
    }
  }
}

// C entry point for ctypes: launches on `stream` and returns
// cudaGetLastError() (0 on success).  The caller owns both buffers; any
// alignment of either and any n_pixels are taken.
extern "C" int post_chain_launch(const void* in, void* out, long long n_pixels,
                                 const PostChainParams* params, void* stream) {
  if (n_pixels <= 0) return 0;
  static int resident[64];  // blocks per SM at THREADS, per device
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64 && resident[dev] == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev], post_chain_kernel, THREADS, 0);
  const long long per_sm = dev < 64 && resident[dev] > 0 ? resident[dev] : 1;
  const int mis = (int)((uintptr_t)in & 15) / 4;  // floats past a 16-byte boundary
  const int head = (int)(n_pixels < mis ? n_pixels : mis);
  const int vec_out = (((uintptr_t)out + 12 * (uintptr_t)head) & 15) == 0;
  const long long n_groups = (n_pixels - head) / PIX;
  long long blocks = (n_groups + THREADS - 1) / THREADS;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  if (blocks < 1) blocks = 1;  // the scalar pixels (at most 6)
  post_chain_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, n_pixels, head, vec_out, *params);
  return (int)cudaGetLastError();
}

// ---- the range-limited forms against the generic ones -----------------------

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (isnan(a) && isnan(b));
}

__device__ __forceinline__ int sextant_generic(float h) {  // with "% 6"
  int i = ((int)floorf(py_mod(h, 1.0f) * 6.0f)) % 6;
  if (i < 0) i += 6;
  return i;
}

__device__ __forceinline__ int sextant(float h) {
  return (int)floorf(py_mod1_unit(h) * 6.0f);
}

// Over every float of each form's range, NaN and -0: counts into m[0] the
// x in [-1, 1] where py_mod6_unit(x) differs from py_mod(x, 6), into m[1]
// the h in [0, 1] where py_mod1_unit differs from py_mod(h, 1), and into
// m[2] those where the sextant differs from the generic one.  NaNs of any
// payload count as equal.
__global__ void check_forms_kernel(unsigned* m) {
  const unsigned n = 0x3F800001u;  // the bit patterns of 0 .. 1
  unsigned c6 = 0, c1 = 0, cs = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float xp = __uint_as_float(i), xn = __uint_as_float(i | 0x80000000u);
    c6 += !same_bits(py_mod6_unit(xp), py_mod(xp, 6.0f));
    c6 += !same_bits(py_mod6_unit(xn), py_mod(xn, 6.0f));
    c1 += !same_bits(py_mod1_unit(xp), py_mod(xp, 1.0f));
    cs += sextant(xp) != sextant_generic(xp);
    if (i == 0) {
      const float nan = __uint_as_float(0x7FC00000u), mz = -0.0f;
      c6 += !same_bits(py_mod6_unit(nan), py_mod(nan, 6.0f));
      c1 += !same_bits(py_mod1_unit(nan), py_mod(nan, 1.0f));
      c1 += !same_bits(py_mod1_unit(mz), py_mod(mz, 1.0f));
      cs += (sextant(nan) != sextant_generic(nan)) + (sextant(mz) != sextant_generic(mz));
    }
  }
  if (c6) atomicAdd(m, c6);
  if (c1) atomicAdd(m + 1, c1);
  if (cs) atomicAdd(m + 2, cs);
}

// C entry point for ctypes: `m` is three zeroed unsigned ints on the card.
extern "C" int post_chain_check_forms(void* m, void* stream) {
  check_forms_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>((unsigned*)m);
  return (int)cudaGetLastError();
}
