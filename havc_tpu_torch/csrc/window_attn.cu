// Local window attention for Hopper (sm_90a): for every query pixel,
// softmax over the (2*max_dis+1)^2 offsets of its window of
// (q * scale) . k + rel, out-of-frame offsets at -1e8, then the weighted
// sum of v.  q, k (B, H, W, d_qk), v and out (B, H, W, d_vu), rel
// (B, H, W, win*win), channel-last and contiguous, all float32.  bf16
// inputs go to csrc/window_attn_tc.cu, one launch on the tensor cores.
//
// Replaces the TPU kernel havc_tpu/ops/pallas_attn.py::_kernel (public
// local_window_attention).  The plain PyTorch version is
// havc_tpu_torch/ops/window_attn.py::window_attn_reference (unfold +
// einsum).
//
// Bound: operations.  The function does 2 x (d_qk + d_vu) operations per
// (pixel, in-frame offset) pair; out-of-frame offsets have weight 0 and
// are skipped.  At ColorMNet's path shape (1, 14, 28, 64 / 1024) 56,056
// of the 392 x 225 pairs lie in the frame: 0.122 GFLOP, 1.82 us at the
// card's f32 rate, against 3.76 MB read, 1.12 us.  At this size what the
// time goes to is latency: 392 pixels give little parallelism, each step
// waits on a load from L2, and v (1.6 MB) is re-read from the 50 MB L2
// by every tile whose windows cover it.
//
// Design: two launches over tiles of TH x TW = 2 x 4 output pixels.
// 1. window_attn_weights_kernel, one CTA per tile: a thread per window
//    position of the tile ((TH + 2 max_dis) x (TW + 2 max_dis), 288 at
//    max_dis 7) loads that position's k into registers and takes its dot
//    product with each of the tile's TP = 8 scaled queries (broadcast
//    from shared memory): each k vector is read once for the 8 pixels,
//    and every thread computes whole dot products, with no shuffle
//    reduction.  Then warp p takes the softmax of pixel p once, 8 offsets
//    per lane at a time, and the CTA writes the tile's weights as one
//    padded block: per window position, TP floats, 0 where the position
//    is outside a pixel's window.
// 2. window_attn_sum_kernel, one CTA per tile and per 128 output channels
//    (4 per thread, one 16-byte copy), two warps that take alternate rows:
//    each warp streams its v rows through a 3-stage cp.async ring (each
//    thread copies and reads only its own channels, so the ring needs no
//    barrier) and adds every v vector into the TP accumulators it serves,
//    reading the TP weights of that position as float4 broadcasts; warp 1
//    hands its sums to warp 0 at the end.  Each v vector loaded serves
//    all 8 pixels (36 loads per pixel at 2 x 4, against 225 for one pixel
//    alone); 392 CTAs at the path shape.  It is a programmatic dependent
//    launch: it starts while the weights kernel runs, fetches its first
//    v rows, and waits for the weights with griddepcontrol.wait.
// This replaces the first design, a single kernel (one CTA per 4 pixels
// of a row and per 256 channels), which recomputed the logits in each of
// the 4 channel-chunk CTAs, reduced each dot product across a warp with
// shuffles, and read v with dependent 4-byte loads.
//
// Offset order o = (dy + max_dis) * win + (dx + max_dis), dy-major: the
// channel order of rel.  q is scaled, as the TPU kernel does.  Numerics:
// built without fast math; multiply-adds may contract (the tolerance
// against the plain version, 1e-5, covers another rounding order).  expf
// and the division are the accurate ones.  Out-of-frame offsets get
// exactly 0 weight (expf(-1e8 - m) is 0).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WA_TH 2                // output tile rows
#define WA_TW 4                // output tile columns
#define WA_TP (WA_TH * WA_TW)  // pixels of a tile
#define SUM_WARPS 2            // warps of a weighted-sum CTA
#define STAGES 3               // v rows in flight per warp in the sum kernel's ring

static_assert(WA_TP % 4 == 0, "a position's tile weights are read as float4");

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// floor(i / n) for 0 <= i < 2^22, given inv = 1.0f / n: (i + 0.5) / n is
// at least 0.5 / n from the next integer, and the two roundings of
// (i + 0.5) * inv move it by at most (i + 0.5) / n * 2^-23, which is less.
// Every index divided here is below the shared-memory or weight-block
// size, far under 2^22.
__device__ __forceinline__ int div_small(int i, float inv) {
  return (int)(((float)i + 0.5f) * inv);
}

// `BYTES` (16 or 4) bytes from global to shared memory by cp.async, both
// addresses aligned to them
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- 1. logits and softmax -------------------------------------------------

#define K_REGS 16                 // float4 of k a thread holds (d_qk <= 64); beyond, read again
#define SOFTMAX_UNROLL 8          // offsets a lane takes at once in the softmax (8 x 32 >= 225)
#define GATHER 8                  // loads in flight per thread when staging rel and q
#define WEIGHTS_MAX_THREADS 512   // a thread per window position, up to this

// dst[i] = load(i) for i < n over the CTA's threads, GATHER loads in
// flight per thread before their stores
template <typename F>
__device__ __forceinline__ void gather(float* dst, int n, F load) {
  for (int i0 = threadIdx.x; i0 < n; i0 += GATHER * blockDim.x) {
    float t[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = i0 + u * blockDim.x;
      t[u] = i < n ? load(i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = t[u];
    }
  }
}

// k[d..d+3].  V 4: one 16-byte load, k aligned to it and d_qk % 4 == 0;
// V 1: element by element, any
template <int V>
__device__ __forceinline__ float4 load_k4(const float* kp, int d, int d_qk) {
  if constexpr (V == 4) {
    return __ldg(reinterpret_cast<const float4*>(kp + d));
  } else {
    return make_float4(d < d_qk ? __ldg(kp + d) : 0.0f, d + 1 < d_qk ? __ldg(kp + d + 1) : 0.0f,
                       d + 2 < d_qk ? __ldg(kp + d + 2) : 0.0f,
                       d + 3 < d_qk ? __ldg(kp + d + 3) : 0.0f);
  }
}

// One CTA per tile, at least one warp per pixel (warp p takes pixel p's
// softmax) and one thread per window position of the tile.  Shared
// memory: q_s (TP x d4, the scaled queries, d_qk rounded up to 4 with
// zeros), r_s (TP x n_off, rel), l_s (TP x n_off, logits then weights).
template <int V>
__global__ void __launch_bounds__(WEIGHTS_MAX_THREADS)
window_attn_weights_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ rel, float* __restrict__ wts, int H, int W,
                           int d_qk, int max_dis, float scale) {
  // let the weighted sum launch now: it fetches v while this grid runs,
  // and waits for this grid to finish before it reads the weights
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ float4 smem4[];
  const int win = 2 * max_dis + 1, n_off = win * win;
  const int ph = WA_TH + 2 * max_dis, pw = WA_TW + 2 * max_dis;
  const int x0 = blockIdx.x * WA_TW, y0 = blockIdx.y * WA_TH, b = blockIdx.z;
  const int ybase = y0 - max_dis, xbase = x0 - max_dis;
  const int tid = threadIdx.x, lane = tid & 31, p = tid >> 5;
  const int y = y0 + p / WA_TW, x = x0 + p % WA_TW;
  const bool live = p < WA_TP && y < H && x < W;  // warp p has a pixel in the frame
  const long long hw = (long long)H * W, base = b * hw;
  const int d4 = (d_qk + 3) & ~3;
  float* q_s = reinterpret_cast<float*>(smem4);
  float* r_s = q_s + WA_TP * d4;
  float* l_s = r_s + WA_TP * n_off;

  // this thread's window position: its k, fetched first, into registers
  const float inv_pw = 1.0f / pw;
  float4 kr[K_REGS];
  int r = 0, c = 0;
  const float* kp = k;
  auto fetch = [&](int pos) {
    r = div_small(pos, inv_pw);
    c = pos - r * pw;
    const int yy = ybase + r, xx = xbase + c;
    if (pos >= ph * pw || yy < 0 || yy >= H || xx < 0 || xx >= W) return false;
    kp = k + (base + (long long)yy * W + xx) * d_qk;
#pragma unroll
    for (int j = 0; j < K_REGS; ++j)
      if (4 * j < d4) kr[j] = load_k4<V>(kp, 4 * j, d_qk);
    return true;
  };
  bool have = fetch(tid);
  // the tile's rel, and its queries scaled
  const float inv_off = 1.0f / n_off, inv_d4 = 1.0f / d4;
  gather(r_s, WA_TP * n_off, [&](int i) {
    const int pp = div_small(i, inv_off), o = i - pp * n_off;
    const int yy = y0 + pp / WA_TW, xx = x0 + pp % WA_TW;
    return yy < H && xx < W ? __ldg(rel + (base + (long long)yy * W + xx) * n_off + o) : 0.0f;
  });
  gather(q_s, WA_TP * d4, [&](int i) {
    const int pp = div_small(i, inv_d4), d = i - pp * d4;
    const int yy = y0 + pp / WA_TW, xx = x0 + pp % WA_TW;
    const float* qp = q + (base + (long long)yy * W + xx) * d_qk + d;
    return yy < H && xx < W && d < d_qk ? __ldg(qp) * scale : 0.0f;
  });
  __syncthreads();

  // a thread per in-frame window position: the dot product of its k with
  // every query of the tile, kept where the position lies in that
  // pixel's window
  for (int pos = tid; pos < ph * pw; pos += blockDim.x) {
    if (pos != tid) have = fetch(pos);
    if (!have) continue;
#pragma unroll 1  // unrolled, the kernel's code doubles and it runs slower
    for (int pp = 0; pp < WA_TP; ++pp) {
      const float* qp = q_s + pp * d4;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
      for (int j = 0; j < K_REGS; ++j) {
        if (4 * j < d4) {
          const float4 a = *reinterpret_cast<const float4*>(qp + 4 * j);
          s0 += a.x * kr[j].x;
          s1 += a.y * kr[j].y;
          s2 += a.z * kr[j].z;
          s3 += a.w * kr[j].w;
        }
      }
      for (int d = 4 * K_REGS; d < d4; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qp + d);
        const float4 kv = load_k4<V>(kp, d, d_qk);
        s0 += a.x * kv.x;
        s1 += a.y * kv.y;
        s2 += a.z * kv.z;
        s3 += a.w * kv.w;
      }
      const int dy = r - pp / WA_TW, dx = c - pp % WA_TW;
      if (dy >= 0 && dy < win && dx >= 0 && dx < win)
        l_s[pp * n_off + dy * win + dx] = (s0 + s1) + (s2 + s3);
    }
  }
  __syncthreads();

  // softmax of warp p's pixel over its offsets: + rel, out of frame -1e8;
  // each pass takes SOFTMAX_UNROLL offsets per lane at once
  if (live) {
    float* lp = l_s + p * n_off;
    const float* rq = r_s + p * n_off;
    const float inv_win = 1.0f / win;
    float m = -INFINITY;
    for (int o0 = lane; o0 < n_off; o0 += 32 * SOFTMAX_UNROLL) {
#pragma unroll
      for (int u = 0; u < SOFTMAX_UNROLL; ++u) {
        const int o = o0 + 32 * u;
        if (o < n_off) {
          const int dy = div_small(o, inv_win), dx = o - dy * win;
          const int yy = y + dy - max_dis, xx = x + dx - max_dis;
          const float logit = yy >= 0 && yy < H && xx >= 0 && xx < W ? lp[o] + rq[o] : -1e8f;
          lp[o] = logit;
          m = fmaxf(m, logit);
        }
      }
    }
    m = warp_max(m);
    float s = 0.0f;
    for (int o0 = lane; o0 < n_off; o0 += 32 * SOFTMAX_UNROLL) {
#pragma unroll
      for (int u = 0; u < SOFTMAX_UNROLL; ++u) {
        const int o = o0 + 32 * u;
        if (o < n_off) {
          const float e = expf(lp[o] - m);
          lp[o] = e;
          s += e;
        }
      }
    }
    s = warp_sum(s);
    // 0 / s is 0: the out-of-frame offsets skip the division, whose slow
    // path a zero numerator takes
    for (int o0 = lane; o0 < n_off; o0 += 32 * SOFTMAX_UNROLL) {
#pragma unroll
      for (int u = 0; u < SOFTMAX_UNROLL; ++u) {
        const int o = o0 + 32 * u;
        if (o < n_off) {
          const float e = lp[o];
          lp[o] = e == 0.0f ? 0.0f : e / s;
        }
      }
    }
  }
  __syncthreads();

  // the tile's padded weight block, written whole (zeros included), four
  // pixels of a position per float4
  const int blk4 = ph * pw * (WA_TP / 4);
  float4* blk = reinterpret_cast<float4*>(wts) +
                ((long long)(b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * blk4;
  for (int i = tid; i < blk4; i += blockDim.x) {
    const int pos = i / (WA_TP / 4), pp0 = (i % (WA_TP / 4)) * 4;
    const int r = div_small(pos, inv_pw), c = pos - r * pw;
    float w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = pp0 + e;
      const int dy = r - pp / WA_TW, dx = c - pp % WA_TW;
      w[e] = dy >= 0 && dy < win && dx >= 0 && dx < win && y0 + pp / WA_TW < H &&
                     x0 + pp % WA_TW < W
                 ? l_s[pp * n_off + dy * win + dx]
                 : 0.0f;
    }
    blk[i] = make_float4(w[0], w[1], w[2], w[3]);
  }
}

// ---- 2. weighted sum of v ---------------------------------------------------

// Bytes of one warp's part of the sum kernel's shared memory: its ring of
// STAGES v rows (pw positions x 32 x V elements each), at least the
// TP x 32 x V float32 sums it hands to warp 0 at the end, rounded to 16.
template <int V>
__host__ __device__ __forceinline__ int sum_warp_bytes(int pw) {
  const int ring = STAGES * pw * 32 * V * (int)sizeof(float);
  const int sums = WA_TP * 32 * V * (int)sizeof(float);
  return ((ring > sums ? ring : sums) + 15) & ~15;
}

// Shared memory: the tile's weight block (ph x pw x TP floats), then per
// warp sum_warp_bytes: a ring of STAGES v rows.  The warps take the
// window's in-frame rows in turn (warp w the rows ya + w, ya + w +
// SUM_WARPS, ...) and share the output channels; after its rows, a warp
// other than 0 leaves its float32 sums in its part for warp 0.
template <int V>  // V output channels per thread: 4 (v aligned to 4 elements,
                  // d_vu % 4 == 0) or 1
__global__ void __launch_bounds__(32 * SUM_WARPS)
window_attn_sum_kernel(const float* __restrict__ v, const float* __restrict__ wts,
                       float* __restrict__ out, int H, int W, int d_vu, int max_dis,
                       int n_chunks) {
  extern __shared__ float4 smem4[];
  const int ph = WA_TH + 2 * max_dis, pw = WA_TW + 2 * max_dis;
  const int n4 = ph * pw * (WA_TP / 4);
  const int b = blockIdx.z / n_chunks, chunk = blockIdx.z - b * n_chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (chunk * 32 + lane) * V;
  const bool active = c < d_vu;
  const int x0 = blockIdx.x * WA_TW, y0 = blockIdx.y * WA_TH;
  const int ybase = y0 - max_dis, xbase = x0 - max_dis;
  const int ya = max(ybase, 0), yb = min(ybase + ph - 1, H - 1);
  const int xa = max(xbase, 0), xb = min(xbase + pw - 1, W - 1);
  const int cols = xb - xa + 1;
  const int rows = yb - ya >= warp ? (yb - ya - warp) / SUM_WARPS + 1 : 0;
  const long long hw = (long long)H * W;
  const int slot = pw * 32 * V;  // elements of one ring stage
  char* part = reinterpret_cast<char*>(smem4 + n4) + warp * sum_warp_bytes<V>(pw);
  float* ring = reinterpret_cast<float*>(part) + lane * V;
  const float* vt = v + (b * hw + (long long)(ya + warp) * W + xa) * d_vu + c;

  auto issue = [&](int j) {  // the warp's j-th row into its ring stage
    if (!active || j >= rows) return;
    float* dst = ring + (j % STAGES) * slot;
    const float* src = vt + (long long)j * SUM_WARPS * W * d_vu;
    for (int i = 0; i < cols; ++i)
      cp_async<V * (int)sizeof(float)>(dst + i * 32 * V, src + (long long)i * d_vu);
  };
  // v does not depend on the weights: fetch the first rows before waiting
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    issue(j);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float4* blk =
      reinterpret_cast<const float4*>(wts) +
      ((long long)(b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * n4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) cp_async<16>(smem4 + i, blk + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[WA_TP][V];
#pragma unroll
  for (int p = 0; p < WA_TP; ++p)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[p][e] = 0.0f;

  for (int j = 0; j < rows; ++j) {
    issue(j + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    const float* vs = ring + (j % STAGES) * slot;
    const float4* wq =
        smem4 + ((ya + warp + j * SUM_WARPS - ybase) * pw + xa - xbase) * (WA_TP / 4);
#pragma unroll 2
    for (int i = 0; i < cols; ++i) {
      float val[V];
      if constexpr (V == 1) {
        val[0] = vs[i * 32];
      } else {
        const float4 f = *reinterpret_cast<const float4*>(vs + i * 32 * V);
        val[0] = f.x; val[1] = f.y; val[2] = f.z; val[3] = f.w;
      }
#pragma unroll
      for (int q4 = 0; q4 < WA_TP / 4; ++q4) {
        const float4 w4 = wq[i * (WA_TP / 4) + q4];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[4 * q4 + 0][e] += w4.x * val[e];
          acc[4 * q4 + 1][e] += w4.y * val[e];
          acc[4 * q4 + 2][e] += w4.z * val[e];
          acc[4 * q4 + 3][e] += w4.w * val[e];
        }
      }
    }
  }

  // warps 1.. hand their sums to warp 0 through their own parts, after
  // their last ring read
  float* sums = reinterpret_cast<float*>(part) + lane * V;
  if (warp > 0) {
#pragma unroll
    for (int p = 0; p < WA_TP; ++p)
#pragma unroll
      for (int e = 0; e < V; ++e) sums[p * 32 * V + e] = acc[p][e];
  }
  __syncthreads();
  if (warp > 0 || !active) return;
  for (int w = 1; w < SUM_WARPS; ++w) {
    const float* other =
        reinterpret_cast<const float*>(part + w * sum_warp_bytes<V>(pw)) + lane * V;
#pragma unroll
    for (int p = 0; p < WA_TP; ++p)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[p][e] += other[p * 32 * V + e];
  }
#pragma unroll
  for (int p = 0; p < WA_TP; ++p) {
    const int y = y0 + p / WA_TW, x = x0 + p % WA_TW;
    if (y < H && x < W) {
      float* dst = out + (b * hw + (long long)y * W + x) * d_vu + c;
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      else
        dst[0] = acc[p][0];
    }
  }
}

// ---- host entry points -------------------------------------------------------

static bool aligned(const void* p, size_t bytes) { return ((uintptr_t)p % bytes) == 0; }

// Sets the dynamic shared-memory limit of `fn` where `bytes` needs more
// than the default 48 KB; cudaErrorInvalidValue above the card's limit.
static int smem_for(const void* fn, size_t bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Floats of the weights scratch that window_attn_launch needs: one padded
// weight block per tile.
extern "C" long long window_attn_scratch_floats(int B, int H, int W, int max_dis) {
  const long long tiles = (long long)B * ((H + WA_TH - 1) / WA_TH) * ((W + WA_TW - 1) / WA_TW);
  return tiles * (WA_TH + 2 * max_dis) * (WA_TW + 2 * max_dis) * WA_TP;
}

template <int V>
static int launch_weights(const dim3& grid, int threads, size_t smem, cudaStream_t st,
                          const float* q, const float* k, const float* rel, float* wts, int H,
                          int W, int d_qk, int max_dis, float scale) {
  const int rc = smem_for((const void*)window_attn_weights_kernel<V>, smem);
  if (rc != 0) return rc;
  window_attn_weights_kernel<V><<<grid, threads, smem, st>>>(q, k, rel, wts, H, W, d_qk,
                                                             max_dis, scale);
  return (int)cudaGetLastError();
}

template <int V>
static int launch_sum(int tiles_x, int tiles_y, int B, cudaStream_t st, const float* v,
                      const float* wts, float* out, int H, int W, int d_vu, int max_dis) {
  const int ph = WA_TH + 2 * max_dis, pw = WA_TW + 2 * max_dis;
  const int n_chunks = (d_vu / V + 31) / 32;
  if ((long long)B * n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)ph * pw * WA_TP +
                      (size_t)SUM_WARPS * sum_warp_bytes<V>(pw);
  int rc = smem_for((const void*)window_attn_sum_kernel<V>, smem);
  if (rc != 0) return rc;
  // programmatic dependent launch: may start while the weights kernel
  // runs (it waits for it with griddepcontrol.wait)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_x, tiles_y, B * n_chunks);
  cfg.blockDim = dim3(32 * SUM_WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, window_attn_sum_kernel<V>, v, wts, out, H, W, d_vu,
                                 max_dis, n_chunks);
}

// C entry point for ctypes: launches on `stream` the weights kernel
// (stages & 1), which writes `wts`, and the weighted sum (stages & 2),
// which reads it; the wrapper passes 3, the two halves are apart only for
// timing.  q, k, v, rel and `out` are float32.  Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape the grid or the
// card's shared memory does not take.  The caller owns every buffer;
// `wts` holds window_attn_scratch_floats(B, H, W, max_dis) floats, 16-byte
// aligned.
extern "C" int window_attn_launch(const float* q, const float* k, const float* v,
                                  const float* rel, float* wts, float* out, int B, int H, int W,
                                  int d_qk, int d_vu, int max_dis, float scale, int stages,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || d_vu <= 0) return 0;
  if (max_dis < 0 || d_qk <= 0 || (H + WA_TH - 1) / WA_TH > 65535 || B > 65535 ||
      !aligned(wts, 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles_y = (H + WA_TH - 1) / WA_TH, tiles_x = (W + WA_TW - 1) / WA_TW;
  const int win = 2 * max_dis + 1;
  const int ph = WA_TH + 2 * max_dis, pw = WA_TW + 2 * max_dis;
  constexpr int VS = 4;  // channels a thread sums on the vector path
  if (stages & 1) {
    const size_t smem = sizeof(float) * WA_TP * ((size_t)((d_qk + 3) & ~3) + 2 * win * win);
    int threads = (ph * pw + 31) / 32 * 32;  // a thread per window position
    if (threads < 32 * WA_TP) threads = 32 * WA_TP;
    if (threads > WEIGHTS_MAX_THREADS) threads = WEIGHTS_MAX_THREADS;
    const dim3 grid(tiles_x, tiles_y, B);
    const int rc = d_qk % 4 == 0 && aligned(k, 4 * sizeof(float))
        ? launch_weights<4>(grid, threads, smem, st, q, k, rel, wts, H, W, d_qk, max_dis, scale)
        : launch_weights<1>(grid, threads, smem, st, q, k, rel, wts, H, W, d_qk, max_dis, scale);
    if (rc != 0) return rc;
  }
  if (stages & 2) {
    const int rc = d_vu % VS == 0 && aligned(v, VS * sizeof(float)) && aligned(out, 16)
        ? launch_sum<VS>(tiles_x, tiles_y, B, st, v, wts, out, H, W, d_vu, max_dis)
        : launch_sum<1>(tiles_x, tiles_y, B, st, v, wts, out, H, W, d_vu, max_dis);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

