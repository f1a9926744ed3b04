// Local window attention on bf16 inputs for Hopper (sm_90a), on the bf16
// tensor cores, in one launch: for every query pixel, softmax over the
// (2*max_dis+1)^2 offsets of its window of (q . k) * scale + rel (offsets
// outside the frame take no weight), then the weighted sum of v.  q, k
// (B, H, W, d_qk), v (B, H, W, d_vu) and rel (B, H, W, win*win) bfloat16,
// out (B, H, W, d_vu) float32, channel-last and contiguous.  Logits,
// softmax and sums are float32, as the TPU kernel computes them from the
// bf16 values (its wrapper casts them to f32, pallas_attn.py:122-128).
//
// Replaces the TPU kernel havc_tpu/ops/pallas_attn.py::_kernel (public
// local_window_attention) for bf16 inputs; float32 inputs go to
// csrc/window_attn.cu.  The plain PyTorch version is
// havc_tpu_torch/ops/window_attn.py::window_attn_reference.
//
// Bound: bytes.  Each input read once in bf16 and the f32 output written
// once: at ColorMNet's path shape (1, 14, 28, 64 / 1024) 2,685,200 B,
// 0.80 us at 3.35 TB/s.  The operations, 2 x (d_qk + 2 d_vu) per in-frame
// (pixel, offset) pair with the second P.V product below, take 0.24 us at
// the bf16 tensor-core rate.  At this size the floor is a launch's latency
// and the chain of loads and scalar softmax steps a CTA waits on, so the
// design keeps one launch and spreads each CTA's steps over 16 warps.
//
// Design: a CTA takes a tile of TH x 4 query pixels (TH up to 16: 64
// query slots in 4 blocks of 4 x 4 = 16, one mma.sync M each) and one
// chunk of CW output channels (64; 128 where the CTAs of 64 would not all
// fit on the SMs at once: fewer CTAs then repeat each tile's logits);
// blockIdx.x walks the chunks of a column of tiles first.  At the path
// shape (TH 16 with 14 rows in the frame, 7 column tiles, 16 chunks of 64)
// that is 112 CTAs of 512 threads.
// - Staging (cp.async, 16-byte copies where rows are aligned, zeros where
//   the tile or the halo ends): the tile's q, the keys of its halo (the
//   (TH + 2 max_dis) x (4 + 2 max_dis) window positions of its pixels,
//   clipped to the frame: 14 x 18 = 252 at the path shape) and the tile's
//   rel rows in one group, the halo's v chunk in a second group that lands
//   while the first logits are computed; the rel rows' unaligned ends,
//   which cp.async cannot copy, are loaded before the copies are issued.
//   A CTA reads each k and v row of its halo once for the tile's 64
//   queries, against 8 in the float32 design.
// - Logits S = Q K^T with mma.sync.m16n8k16 (bf16 operands, f32 sums)
//   over 16 keys a step; then * scale (1/8 at d_qk 64, exact) + rel at
//   offset (ky - qy + m) * win + (kx - qx + m) for the keys in a pixel's
//   window, -inf elsewhere.  Four warps share each 16-query block, each
//   over every fourth 16-key step of the halo rows the block's windows
//   reach, with a running maximum per row (a row sits on the 4 lanes of
//   a quad): e = exp(s - max), its sum, and the sums so far rescaled when
//   the maximum grows.  At the end the four warps' sums and products are
//   combined through shared memory with exp(max_w - max).
// - P.V: e is split into two bf16 terms, hi = bf16(e) and lo = bf16(e -
//   hi) (e - hi is exact in f32), and both multiply v into the same f32
//   accumulators: one bf16 term would round the weights to 2^-9 and miss
//   the 1e-5 tolerance by ~20x; two keep them to ~2^-17.  S's accumulator
//   layout is the A operand's, so e never leaves registers; v comes from
//   shared memory with ldmatrix.trans.
// - Output: (sum of the products) / (sum of e), float32, written once per
//   pixel and channel.
//
// Numerics: built without fast math; expf and the division are the
// accurate ones.  The products are exact (bf16 x bf16 in f32), the sums
// are in another order than the plain version's; the tolerance against it
// is 1e-5.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TC_TW 4      // tile columns; a 16-query block is 4 tile rows x 4 columns
#define TC_MAX_TH 16  // tile rows at most (4 query blocks)
#define TC_KSPLIT 4   // warps that share a query block, each over a quarter of its keys
#define TC_EDGE 16    // edge elements of a tile row's rel run (7 before, 7 after, padded)

typedef __nv_bfloat16 bf16;

// floor(i / n) for 0 <= i < 2^22, given inv = 1.0f / n: (i + 0.5) / n is
// at least 0.5 / n from the next integer, and the two roundings of
// (i + 0.5) * inv move it by at most (i + 0.5) / n * 2^-23, which is less.
__device__ __forceinline__ int div_small(int i, float inv) {
  return (int)(((float)i + 0.5f) * inv);
}

// the most rows (or columns) of a halo: tiles of t along n, windows
// reaching m past them, clipped to [0, n)
static int halo_extent(int n, int t, int m) {
  int most = 0;
  for (int a = 0; a < n; a += t) {
    const int lo = a - m > 0 ? a - m : 0, hi = a + t - 1 + m < n - 1 ? a + t - 1 + m : n - 1;
    most = hi - lo + 1 > most ? hi - lo + 1 : most;
  }
  return most;
}

// Shared-memory geometry of a launch, computed on the host and passed to
// every CTA, in bytes: q_s (th * 4 rows of lq bf16), then k_s and v_s (nk
// halo keys, rows of lq and cw + 8 bf16), which the split warps' partial
// sums (TC_KSPLIT x th * 4 rows of cw + 8 floats) overwrite after the last
// product, then r_s (th rows of rrow bf16), then each split warp's row
// maxima and row sums (TC_KSPLIT x th * 4 floats each).
struct TcGeom {
  int th, cw, win, n_off, lq, nk, rrow, kv_bytes;
  TcGeom(int H, int W, int d_qk, int max_dis, int th_, int cw_) {
    th = th_;
    cw = cw_;
    win = 2 * max_dis + 1;
    n_off = win * win;
    lq = ((d_qk + 15) & ~15) + 8;  // d_qk padded to 16 with zeros, + 8: no bank conflicts
    nk = (halo_extent(H, th, max_dis) * halo_extent(W, TC_TW, max_dis) + 15) & ~15;
    rrow = (TC_TW * n_off + 7 + 7) & ~7;  // a tile row's rel, shifted by up to 7 to align
    const int kv = 2 * nk * (lq + cw + 8), part = 4 * TC_KSPLIT * th * TC_TW * (cw + 8);
    kv_bytes = kv > part ? kv : part;
  }
  __host__ __device__ int q_bytes() const { return 2 * th * TC_TW * lq; }
  __host__ __device__ int r_bytes() const { return 2 * th * rrow; }
  long long bytes() const {
    return (long long)q_bytes() + kv_bytes + r_bytes() + 2 * 4 * TC_KSPLIT * th * TC_TW;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned short ld_bits(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// rows x cols (cols % 8 == 0) bf16 into shared memory at row stride ld:
// element (r, c) is src(r)[c] for c < valid and 0 past it or where src(r)
// is null.  vec: every src(r) is 16-byte aligned, so whole 8-element units
// go by cp.async; the rest element by element.
template <typename RowSrc>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, int rows, int cols, int valid,
                                           bool vec, RowSrc src) {
  const int units = cols / 8;
  const float inv_units = 1.0f / units;
  for (int i = threadIdx.x; i < rows * units; i += blockDim.x) {
    const int r = div_small(i, inv_units), c = (i - r * units) * 8;
    bf16* d = dst + r * ld + c;
    const bf16* s = src(r);
    if (s != nullptr && vec && c + 8 <= valid) {
      cp_async16(d, s + c);
    } else {
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned lo = s != nullptr && c + 2 * e < valid ? ld_bits(s + c + 2 * e) : 0u;
        const unsigned hi = s != nullptr && c + 2 * e + 1 < valid ? ld_bits(s + c + 2 * e + 1) : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The elements of n contiguous bf16 before src's first 16-byte line (at
// most 7): the rest up to the last whole line goes by cp.async, the ends
// are the caller's.
__device__ __forceinline__ int run_head(const bf16* src, int n) {
  return min((8 - (int)(((uintptr_t)src >> 1) & 7)) & 7, n);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) as two bf16 terms each: hi = bf16(x), lo = bf16(x - hi), packed
// with a in the low half (the lower key of an A-operand register)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One CTA per (channel chunk, column tile), row tile, frame: th / 4
// blocks of 16 queries, TC_KSPLIT warps each.  vec_qk: q and k rows
// 16-byte aligned (d_qk % 8 == 0); vec_v: v rows (d_vu % 8 == 0).
template <int CW>  // output channels of a CTA
__global__ void __launch_bounds__(32 * TC_KSPLIT * TC_MAX_TH / 4)
window_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ rel,
                      float* __restrict__ out, const TcGeom g, int H, int W, int d_qk,
                      int d_vu, int max_dis, int n_chunks, float scale, int vec_qk, int vec_v) {
  constexpr int LV = CW + 8;  // shared row stride of v (bf16): 144 B at 64, no ldmatrix conflicts
  constexpr int LP = CW + 8;  // shared row stride of a partial sum (floats)
  extern __shared__ uint4 smem_u4[];
  const int th = g.th, m = max_dis, win = g.win, n_off = g.n_off, lq = g.lq;
  const int nq = th * TC_TW;  // query slots of the tile
  const int chunk = blockIdx.x % n_chunks, x0 = (blockIdx.x / n_chunks) * TC_TW;
  const int y0 = blockIdx.y * th, c0 = chunk * CW;
  const long long base = (long long)blockIdx.z * H * W;  // first pixel of the frame
  const int hy0 = max(y0 - m, 0), hy1 = min(y0 + th - 1 + m, H - 1);
  const int hx0 = max(x0 - m, 0), hx1 = min(x0 + TC_TW - 1 + m, W - 1);
  const int hw = hx1 - hx0 + 1, nkeys = (hy1 - hy0 + 1) * hw, nkp = (nkeys + 15) & ~15;
  const float inv_hw = 1.0f / hw;
  char* smem = reinterpret_cast<char*>(smem_u4);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + g.q_bytes());
  bf16* v_s = k_s + g.nk * lq;
  float* part_s = reinterpret_cast<float*>(k_s);  // after the last product
  bf16* r_s = reinterpret_cast<bf16*>(smem + g.q_bytes() + g.kv_bytes);
  float* max_s = reinterpret_cast<float*>(smem + g.q_bytes() + g.kv_bytes + g.r_bytes());
  float* sum_s = max_s + TC_KSPLIT * nq;
  auto key_pixel = [&](int i) {  // halo key i, row-major over the halo
    const int r = div_small(i, inv_hw);
    return base + (long long)(hy0 + r) * W + hx0 + (i - r * hw);
  };
  // rel of tile row tr: its pixels' rows, one run, at the run's own
  // alignment within its 16-byte line
  auto rel_run = [&](int tr) { return rel + (base + (long long)(y0 + tr) * W + x0) * n_off; };
  auto rel_shift = [&](int tr) { return (int)(((uintptr_t)rel_run(tr) >> 1) & 7); };
  const int ncols = min(TC_TW, W - x0), run = ncols * n_off;

  // group 0: q, k, rel; group 1: the v chunk.  The rel runs' edge elements
  // (2-byte aligned, no cp.async) are loaded first, one per thread at
  // most, and stored once the copies are on their way.
  const int edge_tr = threadIdx.x / TC_EDGE, edge_e = threadIdx.x % TC_EDGE;
  const bool has_edge = edge_tr < th && y0 + edge_tr < H;
  const int head = has_edge ? run_head(rel_run(edge_tr), run) : 0;
  const int tail = head + (run - head) / 8 * 8;
  const int edge_i = edge_e < 8 ? edge_e : tail + edge_e - 8;
  const bool edge = has_edge && (edge_e < 8 ? edge_e < head : edge_i < run);
  const unsigned short edge_val = edge ? ld_bits(rel_run(edge_tr) + edge_i) : 0;
  stage_rows(q_s, lq, nq, lq - 8, d_qk, vec_qk, [&](int r) -> const bf16* {
    const int y = y0 + r / TC_TW, x = x0 + r % TC_TW;
    return y < H && x < W ? q + (base + (long long)y * W + x) * d_qk : nullptr;
  });
  stage_rows(k_s, lq, nkp, lq - 8, d_qk, vec_qk, [&](int i) -> const bf16* {
    return i < nkeys ? k + key_pixel(i) * d_qk : nullptr;
  });
  // the runs' whole 16-byte lines, over all threads: line u of row tr
  const int lines = (run + 7) / 8, rows_in = min(th, H - y0);
  const float inv_lines = 1.0f / lines;
  for (int j = threadIdx.x; j < rows_in * lines; j += blockDim.x) {
    const int tr = div_small(j, inv_lines), u = j - tr * lines;
    const bf16* src = rel_run(tr);
    const int h0 = run_head(src, run);
    if (u < (run - h0) / 8)
      cp_async16(r_s + tr * g.rrow + rel_shift(tr) + h0 + 8 * u, src + h0 + 8 * u);
  }
  cp_async_commit();
  stage_rows(v_s, LV, nkp, CW, d_vu - c0, vec_v, [&](int i) -> const bf16* {
    return i < nkeys ? v + key_pixel(i) * d_vu + c0 : nullptr;
  });
  cp_async_commit();
  if (edge)
    reinterpret_cast<unsigned short*>(r_s + edge_tr * g.rrow + rel_shift(edge_tr))[edge_i] =
        edge_val;

  // this warp's query block and key split; this thread's two query rows
  // of the block's 16 (MMA rows gq and gq + 8)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = warp / TC_KSPLIT, split = warp % TC_KSPLIT;
  const int gq = lane >> 2, tig = lane & 3;
  // in halo coordinates: key (r, c) lies in row h's window when r - wr[h]
  // and c - wc[h] are in [0, win) (never for a row outside the frame), and
  // its rel is r_s[rbase[h] + r * win + c]
  int wr[2], wc[2], rbase[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = 4 * qb + gq / 4 + 2 * h, tc = gq % 4;
    const bool in_frame = y0 + tr < H && x0 + tc < W;
    wr[h] = in_frame ? y0 + tr - m - hy0 : -(1 << 24);
    wc[h] = x0 + tc - m - hx0;
    rbase[h] = in_frame ? tr * g.rrow + rel_shift(tr) + tc * n_off - wr[h] * win - wc[h] : 0;
  }
  // the block's keys: the halo rows its pixels' windows reach, in 16-key
  // steps; this warp takes every TC_KSPLIT-th step from kb0 + split
  const int wy = y0 + 4 * qb;
  int kb0 = 0, kb1 = 0;
  if (wy < H) {
    const int ry0 = max(wy - m, hy0), ry1 = min(min(wy + 3, H - 1) + m, hy1);
    kb0 = (ry0 - hy0) * hw / 16 + split;
    kb1 = ((ry1 - hy0 + 1) * hw + 15) / 16;
  }
  const bf16* qa_row =
      q_s + (16 * qb + (lane & 7) + ((lane >> 3) & 1) * 8) * lq + (lane >> 4) * 8;

  // logits of the 16 keys of step kb: s[t][2h + e] is query row gq + 8h,
  // key 16 kb + 8 t + 2 tig + e; -inf off the pixel's window
  auto logits = [&](int kb, float (&s)[2][4]) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[t][j] = 0.0f;
    const bf16* kb_row =
        k_s + (16 * kb + (lane & 7) + (lane >> 4) * 8) * lq + ((lane >> 3) & 1) * 8;
#pragma unroll 4
    for (int d0 = 0; d0 < lq - 8; d0 += 16) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, qa_row + d0);
      ldmatrix_x4(b, kb_row + d0);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 16 * kb + 8 * t + 2 * tig + e;
        const int r = div_small(i, inv_hw), c = i - r * hw, lin = r * win + c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool in = i < nkeys && (unsigned)(r - wr[h]) < (unsigned)win &&
                          (unsigned)(c - wc[h]) < (unsigned)win;
          const int o = in ? rbase[h] + lin : 0;
          const float rv = __bfloat162float(r_s[o]);
          s[t][2 * h + e] = in ? s[t][2 * h + e] * scale + rv : -INFINITY;
        }
      }
    }
  };
  // row r of the tile's 64 query slots for this thread's MMA row h
  const int row0 = 16 * qb + gq, row1 = row0 + 8;

  cp_async_wait<1>();
  __syncthreads();
  // the first step's logits while v lands
  float s[2][4];
  if (kb0 < kb1) logits(kb0, s);
  cp_async_wait<0>();
  __syncthreads();

  // one pass over the warp's steps with a running maximum per row (the
  // row's 4 lanes agree on it): e = exp(s - max), its sum, and e in two
  // bf16 terms times v; the sums so far are rescaled when the maximum
  // grows.  The next step's logits are taken before this step's products.
  float acc[CW / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  const bf16* v_row = v_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * LV + (lane >> 4) * 8;
  for (int kb = kb0; kb < kb1; kb += TC_KSPLIT) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m = fmaxf(m, mx[h]);
      const float alpha = m == mx[h] ? 1.0f : expf(mx[h] - m);  // 0 from -inf
      mx[h] = m;
      sum[h] *= alpha;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[t][j];
        s[t][j] = x == -INFINITY ? 0.0f : expf(x - mx[j >> 1]);
        sum[j >> 1] += s[t][j];
      }
    // A operand: keys 0-7 of the step in registers 0 (row gq) and 1 (row
    // gq + 8), keys 8-15 in 2 and 3
    uint32_t hi[4], lo[4];
    split2(s[0][0], s[0][1], hi[0], lo[0]);
    split2(s[0][2], s[0][3], hi[1], lo[1]);
    split2(s[1][0], s[1][1], hi[2], lo[2]);
    split2(s[1][2], s[1][3], hi[3], lo[3]);
    if (kb + TC_KSPLIT < kb1) logits(kb + TC_KSPLIT, s);
#pragma unroll
    for (int n = 0; n < CW / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_row + 16 * kb * LV + 16 * n);
      mma_bf16(acc[2 * n], hi, b[0], b[1]);
      mma_bf16(acc[2 * n], lo, b[0], b[1]);
      mma_bf16(acc[2 * n + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * n + 1], lo, b[2], b[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }

  // each warp's row maxima; then per row max = the largest, and each
  // warp scales its products and sum by exp(max_w - max) into k/v's
  // region; out = (sum of the products) / (sum of the sums), written once
  // per pixel and channel
  if (tig == 0) {
    max_s[split * nq + row0] = mx[0];
    max_s[split * nq + row1] = mx[1];
  }
  __syncthreads();  // every warp is also done with k_s and v_s
  float* pw = part_s + split * nq * LP;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    float m = -INFINITY;
#pragma unroll
    for (int sp = 0; sp < TC_KSPLIT; ++sp) m = fmaxf(m, max_s[sp * nq + row]);
    const float f = mx[h] == -INFINITY ? 0.0f : expf(mx[h] - m);
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
      *reinterpret_cast<float2*>(pw + row * LP + 8 * n + 2 * tig) =
          make_float2(acc[n][2 * h] * f, acc[n][2 * h + 1] * f);
    if (tig == 0) sum_s[split * nq + row] = sum[h] * f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * CW; i += blockDim.x) {
    const int r = i / CW, c = i % CW;
    const int y = y0 + r / TC_TW, x = x0 + r % TC_TW;
    if (y >= H || x >= W || c0 + c >= d_vu) continue;
    float a = 0.0f, l = 0.0f;
#pragma unroll
    for (int sp = 0; sp < TC_KSPLIT; ++sp) {
      a += part_s[(sp * nq + r) * LP + c];
      l += sum_s[sp * nq + r];
    }
    out[(base + (long long)y * W + x) * d_vu + c0 + c] = a / l;
  }
}

// ---- host entry points -------------------------------------------------------

static bool aligned(const void* p, size_t bytes) { return ((uintptr_t)p % bytes) == 0; }

// Tile rows of a launch at cw channels a CTA: 16, or fewer where the
// frame is lower, in steps of 4 (one warp), fewer still while the shared
// memory would not fit; 0 when not even 4 fit.
static int tile_rows(int H, int W, int d_qk, int max_dis, int cw, int optin) {
  int th = H < TC_MAX_TH ? (H + 3) & ~3 : TC_MAX_TH;
  while (th > 4 && TcGeom(H, W, d_qk, max_dis, th, cw).bytes() > optin) th -= 4;
  return TcGeom(H, W, d_qk, max_dis, th, cw).bytes() > optin ? 0 : th;
}

// A launch's tile rows and channels a CTA: 64 channels, or 128 where the
// CTAs of 64 would not all fit on the card's SMs at once and 128 keep the
// tile rows (half as many CTAs then compute each tile's logits and read
// its halo's k and rel).  th 0: the window does not fit.
static void plan(int B, int H, int W, int d_qk, int d_vu, int max_dis, int& th, int& cw) {
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cw = 64;
  th = tile_rows(H, W, d_qk, max_dis, cw, optin);
  if (th == 0 || d_vu <= 64) return;
  const long long ctas = (long long)B * ((H + th - 1) / th) * ((W + TC_TW - 1) / TC_TW) *
                         ((d_vu + 63) / 64);
  if (ctas > sms && tile_rows(H, W, d_qk, max_dis, 128, optin) == th) cw = 128;
}

// Dynamic shared memory of a launch at these sizes on the current
// device, in bytes; 0 for a window it cannot hold.
extern "C" long long window_attn_tc_smem(int B, int H, int W, int d_qk, int d_vu, int max_dis) {
  int th, cw;
  plan(B, H, W, d_qk, d_vu, max_dis, th, cw);
  return th ? TcGeom(H, W, d_qk, max_dis, th, cw).bytes() : 0;
}

template <int CW>
static int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* rel, float* out,
                  const TcGeom& g, int B, int H, int W, int d_qk, int d_vu, int max_dis,
                  float scale, cudaStream_t stream) {
  const long long smem = g.bytes();
  const int n_chunks = (d_vu + CW - 1) / CW;
  const long long gx = (long long)((W + TC_TW - 1) / TC_TW) * n_chunks;
  const int gy = (H + g.th - 1) / g.th;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        window_attn_tc_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int vec_qk = d_qk % 8 == 0 && aligned(q, 16) && aligned(k, 16);
  const int vec_v = d_vu % 8 == 0 && aligned(v, 16);
  window_attn_tc_kernel<CW><<<dim3((unsigned)gx, gy, B), 32 * TC_KSPLIT * (g.th / 4),
                              (size_t)smem, stream>>>(
      q, k, v, rel, out, g, H, W, d_qk, d_vu, max_dis, n_chunks, scale, vec_qk, vec_v);
  return (int)cudaGetLastError();
}

// C entry point for ctypes: one launch on `stream`.  q, k, v and rel are
// bfloat16, `out` float32; every buffer is the caller's, nothing is
// allocated.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the grid or the card's shared memory
// does not take.
extern "C" int window_attn_tc_launch(const void* q, const void* k, const void* v,
                                     const void* rel, void* out, int B, int H, int W, int d_qk,
                                     int d_vu, int max_dis, float scale, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || d_vu <= 0) return 0;
  if (max_dis < 0 || d_qk <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  int th, cw;
  plan(B, H, W, d_qk, d_vu, max_dis, th, cw);
  if (th == 0) return (int)cudaErrorInvalidValue;
  const TcGeom g(H, W, d_qk, max_dis, th, cw);
  auto run = cw == 128 ? launch<128> : launch<64>;
  return run((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rel, (float*)out, g,
             B, H, W, d_qk, d_vu, max_dis, scale, (cudaStream_t)stream);
}
