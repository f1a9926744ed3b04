// A U-Net decoder block's upsample-and-join for Hopper (sm_90a), one pass:
//
//   conv_out -(BN: x * inv + shift, or nothing)- ReLU - pixel shuffle (r)
//     - replicate pad (1, 0, 1, 0) - 2x2 stride-1 average pool ("blur")  -> [0, C)
//   second: ReLU(second * inv_s + shift_s) ("skip"), or second as it is
//     ("copy"), or nothing ("none")                                     -> [C, C + S)
//
// written into the channel slices of one (N, C + S, rH, rW) float32 tensor.
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it.  In PyTorch it was about a dozen passes over device memory at
// each decoder block of DeOldify and DDColor (the BN multiply and add, the
// ReLU, the shuffle's permuted copy, the pad, the pool, the cat and the
// ReLU over the joined tensor).  The plain version is
// havc_tpu_torch/ops/unet_join.py::unet_join_reference; the kernel gives
// the same bits: the same operations, rounded one by one, in the same order.
//
// Bound: bytes.  Each conv_out and second value is read once and each
// joined value written once (r = 2: 8 B a blurred value; 1-2 flops).
//
// Design: a block of the shuffle range takes one (n, c) and a tile of T
// output rows by R * XW output columns (T a multiple of R, XW of 4).  It
// loads the R * R conv_out planes' input rows and columns the tile needs,
// plus the one-row and one-column halo, into shared memory with 16-byte
// loads (scalar where the rows are not 16-byte aligned), applying BN and
// ReLU once per input element; then each thread forms four neighbouring
// blurred outputs from shared memory and stores them with one 16-byte
// store where the rows allow.  Tiles of ~8192 outputs (at most 48 KB of
// shared memory) for any H and W.  Blocks past the shuffle range
// stream the second range, 4096 values a block, in the same launch.
//
// Numerics: built without --use_fast_math and with -fmad=false, so
// x * inv + shift is a multiply and an add, each rounded, as PyTorch's two
// element-wise kernels do.  The ReLU is PyTorch's clamp_min on CUDA:
// NaN kept, else fmaxf(v, 0).  The blur sums from 0 in
// avg_pool2d_out_cuda_frame's order (top-left, top, left, centre) and
// divides by 4.  No ReLU over [0, C) after the blur: the means of values
// that have been through a ReLU are +0, positive, +inf or NaN, which it
// leaves as they are.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define TILE_OUT 8192    // outputs of a shuffle tile, about
#define MAX_SMEM 49152   // shared bytes a block may take without opting in
#define TILE_COLS 128    // output columns of a shuffle tile, at most
#define STREAM_CHUNK 4096  // second-range values of a block
#define PAD 4            // shared columns before the tile's first input column

enum { MODE_NONE = 0, MODE_COPY = 1, MODE_SKIP = 2 };

struct JoinArgs {
  const float* conv;   // (N, C * R * R, H, W)
  const float* inv;    // (C * R * R) or null: no BN
  const float* shift;
  const float* second; // (N, S, R * H, R * W) or null
  const float* inv_s;  // (S) or null: copy
  const float* shift_s;
  float* out;          // (N, C + S, R * H, R * W)
  int n, c, s, h, w;
  int rows, xw;        // a tile's output rows and input columns
  int row_tiles, col_tiles;
  long long shuf_blocks;
  int stream_per_n;    // blocks of the second range per batch element
  int vec_in, vec_out, vec_s;
};

__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

template <bool BN>
__device__ __forceinline__ float act(float v, const float* inv, const float* shift, int p) {
  if (BN) v = v * __ldg(inv + p) + __ldg(shift + p);
  return relu(v);
}

template <int R, bool BN>
__device__ void shuffle_tile(const JoinArgs& a, long long b, float* sm) {
  const int ct = (int)(b % a.col_tiles);
  long long t = b / a.col_tiles;
  const int rt = (int)(t % a.row_tiles);
  t /= a.row_tiles;
  const int c = (int)(t % a.c);
  const int n = (int)(t / a.c);

  const int H = a.h, W = a.w, RH = R * H, RW = R * W;
  const int TR = a.rows / R;                 // input rows of the tile
  const int y0 = rt * TR, x0 = ct * a.xw;
  const int ny = min(TR, H - y0), nx = min(a.xw, W - x0);
  const int SR = TR + 1, SW = a.xw + PAD;    // a plane's shared rows and columns
  const int p0 = c * R * R;                  // the channel's first conv_out plane
  const float* src = a.conv + ((long long)n * a.c * R * R + p0) * H * W;

  // shared plane p = dy * R + dx, row y - y0 + 1, column x - x0 + PAD
  auto at = [&](int p, int y, int x) -> float& {
    return sm[(p * SR + (y - y0 + 1)) * SW + (x - x0 + PAD)];
  };
  auto load1 = [&](int p, int y, int x) -> float {
    return act<BN>(__ldg(src + ((long long)p * H + y) * W + x), a.inv, a.shift, p0 + p);
  };

  // the body: R * R planes x ny rows x nx columns
  if (a.vec_in) {
    const int nq = nx / 4;  // W % 4 == 0 and x0 % 4 == 0, so nx % 4 == 0
    const int items = R * R * ny * nq;
    for (int base = threadIdx.x; base < items; base += 4 * THREADS) {
      float4 v[4];
      int pi[4], yi[4], qi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int it = base + k * THREADS;
        if (it < items) {
          qi[k] = it % nq;
          const int r2 = it / nq;
          yi[k] = y0 + r2 % ny;
          pi[k] = r2 / ny;
          v[k] = __ldg(reinterpret_cast<const float4*>(
              src + ((long long)pi[k] * H + yi[k]) * W + x0 + 4 * qi[k]));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (base + k * THREADS < items) {
          float4 u = v[k];
          if (BN) {
            const float iv = __ldg(a.inv + p0 + pi[k]), sh = __ldg(a.shift + p0 + pi[k]);
            u.x = u.x * iv + sh;
            u.y = u.y * iv + sh;
            u.z = u.z * iv + sh;
            u.w = u.w * iv + sh;
          }
          u = make_float4(relu(u.x), relu(u.y), relu(u.z), relu(u.w));
          *reinterpret_cast<float4*>(&at(pi[k], yi[k], x0 + 4 * qi[k])) = u;
        }
      }
    }
  } else {
    const int items = R * R * ny * nx;
    for (int it = threadIdx.x; it < items; it += THREADS) {
      const int x = x0 + it % nx;
      const int r2 = it / nx;
      const int y = y0 + r2 % ny, p = r2 / ny;
      at(p, y, x) = load1(p, y, x);
    }
  }
  // the halo: the row above (planes dy = R - 1) and the column to the left
  // (planes dx = R - 1), the corner with them; at the top and left edges
  // the clamped reads stay inside the body
  const int hx = x0 > 0 ? 1 : 0, hy = y0 > 0 ? 1 : 0;
  const int row_items = hy * R * (nx + hx), col_items = hx * R * ny;
  for (int it = threadIdx.x; it < row_items + col_items; it += THREADS) {
    int p, y, x;
    if (it < row_items) {
      const int dx = it % R;
      x = x0 - hx + it / R;
      y = y0 - 1;
      p = (R - 1) * R + dx;
      if (x < x0 && dx != R - 1) continue;  // the corner: only plane (R-1, R-1)
    } else {
      const int j = it - row_items;
      p = (j % R) * R + (R - 1);
      y = y0 + j / R;
      x = x0 - 1;
    }
    at(p, y, x) = load1(p, y, x);
  }
  __syncthreads();

  // the blur of the shuffled values X(s, t) = plane (s % R, t % R) at
  // (s / R, t / R): shared offset row_off(s) + col_off(t)
  const int i0 = rt * a.rows, j0 = x0 * R;
  const int n_rows = R * ny, n_cols = R * nx, j_last = j0 + n_cols - 1;
  const int groups = (n_cols + 3) / 4;
  auto row_off = [&](int s) { return ((s % R) * R * SR + (s / R - y0 + 1)) * SW; };
  auto col_off = [&](int t) { return (t % R) * SR * SW + (t / R - x0 + PAD); };
  float* dst = a.out + ((long long)n * (a.c + a.s) + c) * RH * RW;
  for (int g = threadIdx.x; g < n_rows * groups; g += THREADS) {
    const int i = i0 + g / groups;
    const int jb = j0 + 4 * (g - (i - i0) * groups);
    const int r1 = row_off(max(i - 1, 0)), r2 = row_off(i);
    float top[5], mid[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int co = col_off(min(max(jb - 1 + k, 0), j_last));
      top[k] = sm[r1 + co];
      mid[k] = sm[r2 + co];
    }
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float sum = 0.0f;
      sum += top[q];
      sum += top[q + 1];
      sum += mid[q];
      sum += mid[q + 1];
      o[q] = sum / 4.0f;
    }
    float* row = dst + (long long)i * RW;
    if (a.vec_out && jb + 3 <= j_last) {
      *reinterpret_cast<float4*>(row + jb) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (jb + q <= j_last) row[jb + q] = o[q];
    }
  }
}

// the channel of value e of a batch element's second range: a 32-bit
// division where the range allows it (a 64-bit one is a long call)
__device__ __forceinline__ int channel(long long e, long long plane) {
  return plane <= 0x7FFFFFFF && e <= 0x7FFFFFFF ? (int)((unsigned)e / (unsigned)plane)
                                                : (int)(e / plane);
}

template <int MODE>
__device__ void stream_chunk(const JoinArgs& a, long long b, int R) {
  const int n = (int)(b / a.stream_per_n);
  const long long plane = (long long)R * a.h * R * a.w;
  const long long total = (long long)a.s * plane;
  const long long e0 = (b % a.stream_per_n) * (long long)STREAM_CHUNK;
  const long long e1 = min(e0 + STREAM_CHUNK, total);
  const float* src = a.second + (long long)n * total;
  float* dst = a.out + ((long long)n * (a.c + a.s) + a.c) * plane;
  if (a.vec_s) {  // plane % 4 == 0: the four values of a float4 share a channel
    float4 v[STREAM_CHUNK / 4 / THREADS];
#pragma unroll
    for (int k = 0; k < STREAM_CHUNK / 4 / THREADS; ++k) {
      const long long e = e0 + 4 * (threadIdx.x + k * THREADS);
      if (e < e1) v[k] = __ldg(reinterpret_cast<const float4*>(src + e));
    }
#pragma unroll
    for (int k = 0; k < STREAM_CHUNK / 4 / THREADS; ++k) {
      const long long e = e0 + 4 * (threadIdx.x + k * THREADS);
      if (e >= e1) continue;
      float4 u = v[k];
      if (MODE == MODE_SKIP) {
        const int ch = channel(e, plane);
        const float iv = __ldg(a.inv_s + ch), sh = __ldg(a.shift_s + ch);
        u.x = relu(u.x * iv + sh);
        u.y = relu(u.y * iv + sh);
        u.z = relu(u.z * iv + sh);
        u.w = relu(u.w * iv + sh);
      }
      *reinterpret_cast<float4*>(dst + e) = u;
    }
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) {
      float v = __ldg(src + e);
      if (MODE == MODE_SKIP) {
        const int ch = channel(e, plane);
        v = relu(v * __ldg(a.inv_s + ch) + __ldg(a.shift_s + ch));
      }
      dst[e] = v;
    }
  }
}

template <int R, bool BN, int MODE>
__global__ void __launch_bounds__(THREADS) unet_join_kernel(const JoinArgs a) {
  extern __shared__ float4 smem4[];
  const long long b = blockIdx.x;
  if (b < a.shuf_blocks) {
    shuffle_tile<R, BN>(a, b, reinterpret_cast<float*>(smem4));
  } else if (MODE != MODE_NONE) {
    stream_chunk<MODE>(a, b - a.shuf_blocks, R);
  }
}

template <int R, bool BN, int MODE>
static int launch(JoinArgs& a, cudaStream_t stream) {
  // tile columns: the fewest tiles of at most TILE_COLS output columns,
  // evened out; rows: ~TILE_OUT outputs a tile, whole input rows
  const int max_xw = TILE_COLS / R;
  a.col_tiles = (a.w + max_xw - 1) / max_xw;
  a.xw = ((a.w + a.col_tiles - 1) / a.col_tiles + 3) / 4 * 4;
  a.col_tiles = (a.w + a.xw - 1) / a.xw;
  const int smem_rows = (MAX_SMEM / (int)sizeof(float) / (R * R * (a.xw + PAD)) - 1) * R;
  int rows = min(TILE_OUT / (R * a.xw) / R * R, smem_rows);
  const int all_rows = R * a.h;
  rows = max(R, min(rows, all_rows));
  a.rows = rows;
  a.row_tiles = (all_rows + rows - 1) / rows;
  a.shuf_blocks = (long long)a.n * a.c * a.row_tiles * a.col_tiles;
  const long long per_n = (long long)a.s * all_rows * R * a.w;
  a.stream_per_n = MODE == MODE_NONE ? 0 : (int)((per_n + STREAM_CHUNK - 1) / STREAM_CHUNK);
  const long long blocks = a.shuf_blocks + (long long)a.n * a.stream_per_n;
  const size_t smem = sizeof(float) * R * R * (rows / R + 1) * (a.xw + PAD);
  if (blocks <= 0) return 0;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  unet_join_kernel<R, BN, MODE><<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R>
static int launch_r(JoinArgs& a, bool bn, int mode, cudaStream_t st) {
  if (bn) {
    if (mode == MODE_SKIP) return launch<R, true, MODE_SKIP>(a, st);
    if (mode == MODE_COPY) return launch<R, true, MODE_COPY>(a, st);
    return launch<R, true, MODE_NONE>(a, st);
  }
  if (mode == MODE_SKIP) return launch<R, false, MODE_SKIP>(a, st);
  if (mode == MODE_COPY) return launch<R, false, MODE_COPY>(a, st);
  return launch<R, false, MODE_NONE>(a, st);
}

// C entry point for ctypes: launches on `stream` and returns
// cudaGetLastError() (0 on success).  `conv` is (n, c * r * r, h, w),
// `second` (n, s, r * h, r * w) or null (mode "none"), `inv`/`shift` (c *
// r * r) or null (no BN), `inv_s`/`shift_s` (s) or null (mode "copy"),
// `out` (n, c + s, r * h, r * w); all float32, contiguous, on the current
// device; r is 2 or 4.  The caller owns every buffer.
extern "C" int unet_join_launch(const void* conv, const void* inv, const void* shift,
                                const void* second, const void* inv_s, const void* shift_s,
                                void* out, int n, int c, int s, int h, int w, int r,
                                void* stream) {
  if (r != 2 && r != 4) return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  JoinArgs a = {};
  a.conv = (const float*)conv;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.second = (const float*)second;
  a.inv_s = (const float*)inv_s;
  a.shift_s = (const float*)shift_s;
  a.out = (float*)out;
  a.n = n;
  a.c = c;
  a.s = second ? s : 0;
  a.h = h;
  a.w = w;
  const long long plane = (long long)r * h * r * w;
  a.vec_in = w % 4 == 0 && ((uintptr_t)conv & 15) == 0;
  a.vec_out = (r * w) % 4 == 0 && ((uintptr_t)out & 15) == 0;
  a.vec_s = plane % 4 == 0 && ((uintptr_t)second & 15) == 0 && ((uintptr_t)out & 15) == 0;
  const int mode = !second ? MODE_NONE : inv_s ? MODE_SKIP : MODE_COPY;
  const bool bn = inv != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  return r == 2 ? launch_r<2>(a, bn, mode, st) : launch_r<4>(a, bn, mode, st);
}
