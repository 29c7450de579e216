// Flash attention in float32 on the tensor cores for Hopper (sm_90a): the
// "f32" route of the port's flash_attention, for every float32 call.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel) at float32 and computes what it computes: an online
// softmax over key tiles with float32 scores S, running max m and sum l; P
// kept in float32 for the P V product (the TPU kernel's p.astype(float32)
// is the identity), accumulated in float32, l summed from the same P; the
// output acc / max(l, 1e-30); the causal mask at absolute query position
// kv_offset + i; GQA through the flattened (g, i) row index over the
// group's G = H / Hkv query heads. q, k, v and out are given by batch, head
// and position strides in elements with d contiguous, so the model's [B,
// S, H, d] projections and its [B, max_len, Hkv, d] cache are read in
// place. d % 4 == 0, d <= 128, rows on 16-byte boundaries.
//
// Bound on an H100 SXM: both shapes of granite-3-2b's float32 path are
// bound by bytes. A prefill layer at 4 x 128 moves 10.5 MB (0.0031 ms at
// 3.35 TB/s), while its 3 x 4 d flops per visible (query, key) pair take
// 0.0016 ms at the 495 TFLOP/s of TF32 on the tensor cores; a decode step
// reads the K/V rows of the cache (0.0007 ms at 4 x 130 keys x 8 heads).
//
// Products at float32 accuracy (3xTF32). Every product of S = Q K^T and of
// P V runs on mma.sync.m16n8k8 with TF32 operands and a float32
// accumulator, three times: each operand is split as x = hi + lo with hi =
// x rounded to TF32 (as cvt.rna rounds: 10 mantissa bits, to nearest, ties
// away from zero) and lo = the rest rounded the same way, and the product
// is lo*hi + hi*lo + hi*hi, added in that order into the float32
// accumulator. The term lo*lo and the rounding of lo leave about 2^-21 of
// each product out; one TF32 pass would leave 2^-11. Each pass runs over
// all of a k-step's column tiles before the next, so that products into
// one accumulator are as far apart as the k-step has column tiles.
//
// Design (the mma route's, at float32):
//   * Prefill (more than 16 rows per kv head): 4 warps of 16 flattened
//     query rows (an m-tile each), a block of 64 rows, grid (B * Hkv,
//     ceil(G * Sq / 64)), blockIdx.y walked in reverse so the longest causal
//     blocks start first. Key tiles of 64 keys at d <= 64 and 32 at d > 64
//     (two stages of K and V at 64 keys and d = 128 would take 134 KiB, so
//     the tile is halved there and two blocks fit an SM).
//   * Decode (at most 16 rows): one 16-row m-tile holds the kv head's
//     rows, grid (B * Hkv). The block's 8 warps take 24-key slices w, w +
//     8, w + 16, ... of the keys (8-key slices at d > 64: block tiles of
//     192 / 64 keys), each with its own (m, l, acc), and join them through
//     shared memory at the end: one launch, no scratch, no idle warp while
//     there are keys. A decode block is alone on its SM (its ring takes
//     up to 210 KiB), so it takes 8 warps, not 4, to hide its own
//     latencies; a 192-key tile holds a short cache (lm_f32's 130 keys) in
//     one round trip. A long cache is walked by one SM per kv head, so
//     the loads one SM keeps in flight bound it (PERF.md gives the times;
//     a split of the keys over blocks is queued in ROADMAP.md).
//   * K and V pass through a two-stage ring in shared memory filled by
//     16-byte cp.async.cg copies, zero-filled past the block's last visible
//     key and past d: the next tile's copies are in flight while the
//     current one is computed. Tiles past the block's last visible key
//     (causal: kv_offset + max i) are never loaded, and a slice's 8-key
//     column tiles past it are skipped; the per-element mask runs only on
//     slices that reach past the keys every row of the warp sees.
//   * Fragments without ldmatrix (it moves 16-bit elements only). The
//     reduction index of each mma is permuted: fragment column t holds
//     element 2t and column t + 4 element 2t + 1, in A and B alike, which
//     leaves the product unchanged. So a lane reads its two elements of a
//     Q or K row as one 64-bit load, and the float32 C fragment of S (row
//     g, columns 2t and 2t + 1) is, as it stands, the A fragment of the
//     next product: P is split hi/lo in registers, with no shuffle. V's
//     two elements (keys 2t and 2t + 1 of one column) are two 32-bit loads.
//     Q and K rows are padded to d + 8 floats and V rows to d + 4, so the
//     lanes of each load fall on distinct banks.
//   * Q's hi/lo fragments stay in registers at d <= 64 (64 registers); at
//     d > 64 they are split from shared memory at each k-step.
//   * Shared memory: prefill 48 / 88 / 101 KiB at DP = 32 / 64 / 128 (two
//     blocks per SM), decode 117 / 215 / 143 KiB. Inline PTX only.
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;          // rows of one warp's m-tile
constexpr int kPadK = 8;           // floats of padding per Q and K row
constexpr int kPadV = 4;           // floats of padding per V row
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int hkv, group, sq, skv, d;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int causal, kv_offset;
  float sm_scale;
};

// Tile shapes of one kernel: kWarps warps, BK keys per block tile, WK of
// them per warp, BQ rows per block; LDK, LDV the padded row lengths in
// floats.
template <int DP, bool kDecode>
struct Shape {
  static constexpr int kWarps = kDecode ? 8 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int BK = kDecode ? (DP <= 64 ? 192 : 64)
                                    : (DP <= 64 ? 64 : 32);
  static constexpr int WK = kDecode ? BK / kWarps : BK;
  static constexpr int BQ = kDecode ? kRows : kWarps * kRows;
  static constexpr int LDK = DP + kPadK;
  static constexpr int LDV = DP + kPadV;
  static constexpr int kFloats = BQ * LDK + 2 * BK * (LDK + LDV);
  static constexpr size_t kSmem = (size_t)kFloats * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zero-filled unless ``full``
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), the low 13 bits cleared, in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi = x rounded, lo = the rest rounded.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) b (8 x 8, col), TF32 in, float32 accumulate. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy keys k0 .. k0 + BK - 1 of one kv head (rows of ``stride``) into a
// [BK][LD] tile; rows at or past ``n_keys`` and columns at or past d are
// zero-filled.
template <int DP, int BK, int LD, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int k0,
                                          int n_keys, int d, int tid) {
  constexpr int CH = DP / 4;                 // 16-byte chunks per row
  constexpr int IT = BK * CH / THREADS;
  static_assert(BK * CH % THREADS == 0, "tile chunks split evenly");
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * THREADS;
    const int r = e / CH, c = (e % CH) * 4;
    const bool full = k0 + r < n_keys && c < d;
    const float* from = full ? src + (long long)(k0 + r) * stride + c : src;
    cp_async16(smem_addr(dst + r * LD + c), from, full);
  }
}

// The A fragments (hi, lo) of k-step kc of 16 rows of Q at ``qw`` (rows of
// LDK floats): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8,
// 2t + 1) in the permuted reduction order.
template <int LDK>
__device__ __forceinline__ void q_fragment(const float* qw, int kc, int g,
                                           int t, uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(qw + g * LDK + kc * 8 +
                                                     2 * t);
  const float2 x1 = *reinterpret_cast<const float2*>(
      qw + (g + 8) * LDK + kc * 8 + 2 * t);
  split_tf32(x0.x, h[0], l[0]);
  split_tf32(x1.x, h[1], l[1]);
  split_tf32(x0.y, h[2], l[2]);
  split_tf32(x1.y, h[3], l[3]);
}

template <int DP, bool kDecode>
__global__ void __launch_bounds__(Shape<DP, kDecode>::kThreads)
flash_attention_f32_kernel(const Args a) {
  using Sh = Shape<DP, kDecode>;
  constexpr int kWarps = Sh::kWarps, kThreads = Sh::kThreads;
  constexpr int BK = Sh::BK, WK = Sh::WK, BQ = Sh::BQ;
  constexpr int LDK = Sh::LDK, LDV = Sh::LDV;
  constexpr int KS = DP / 8;      // 8-wide k-steps over the head dim
  constexpr int NT = WK / 8;      // 8-key column tiles of a warp's S
  constexpr int DT = DP / 8;      // 8-wide column tiles of the output
  constexpr int CH = DP / 4;      // 16-byte chunks per row
  constexpr bool kQInRegs = DP <= 64;
  constexpr int kPassTiles = DT < 8 ? DT : 8;   // output tiles per pass
  static_assert(!kDecode ||
                kWarps * kRows * (DP + 2) <= Sh::kFloats,
                "the join fits in the ring");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [BQ][LDK]
  float* ks = qs + BQ * LDK;                 // [2][BK][LDK]
  float* vs = ks + 2 * BK * LDK;             // [2][BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int rows = a.group * a.sq;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float* q = a.q + b * a.q_b;
  const float* k = a.k + b * a.k_b + hk * a.k_h;
  const float* v = a.v + b * a.v_b + hk * a.v_h;

  // Keys this block needs: all of Skv, or (causal) up to its last row's
  // position. A block that spans two heads of the group holds row Sq - 1.
  const int last = min(r0 + BQ, rows) - 1;
  const int max_i = (r0 / a.sq == last / a.sq) ? last % a.sq : a.sq - 1;
  const int n_keys = a.causal ? min(a.skv, a.kv_offset + max_i + 1) : a.skv;
  const int n_tiles = (n_keys + BK - 1) / BK;

  // Q (zero past the last row and past d) and tile 0 in the first group
  for (int e = tid; e < BQ * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 4, rf = r0 + r;
    const bool full = rf < rows && c < a.d;
    const float* from = q;
    if (full) {
      const int g = rf / a.sq, i = rf - g * a.sq;
      from = q + (long long)(hk * a.group + g) * a.q_h +
             (long long)i * a.q_s + c;
    }
    cp_async16(smem_addr(qs + r * LDK + c), from, full);
  }
  if (n_tiles > 0) {
    load_tile<DP, BK, LDK, kThreads>(ks, k, a.k_s, 0, n_keys, a.d, tid);
    load_tile<DP, BK, LDV, kThreads>(vs, v, a.v_s, 0, n_keys, a.d, tid);
  }
  cp_async_commit();

  // The warp's m-tile and key slice; this lane's rows are gr and gr + 8
  // of the m-tile (C-fragment layout).
  const int gr = lane >> 2, tq = lane & 3;
  const int wr0 = kDecode ? r0 : r0 + warp * kRows;
  const int wk0 = kDecode ? warp * WK : 0;
  const float* qw = qs + (wr0 - r0) * LDK;
  const int row[2] = {wr0 + gr, wr0 + gr + 8};
  const int pos[2] = {a.kv_offset + row[0] % a.sq,
                      a.kv_offset + row[1] % a.sq};
  // keys every row of the m-tile sees: slices below need no mask
  const int wlast = min(wr0 + kRows - 1, rows - 1);
  const int min_i =
      (wr0 < rows && wr0 / a.sq == wlast / a.sq) ? wr0 % a.sq : 0;
  const int seen_by_all =
      a.causal ? min(n_keys, a.kv_offset + min_i + 1) : n_keys;
  const float scale = a.sm_scale * kLog2e;   // scores in log2 units

  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qh[kQInRegs ? KS : 1][4], ql[kQInRegs ? KS : 1][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK, st = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile<DP, BK, LDK, kThreads>(ks + (st ^ 1) * BK * LDK, k, a.k_s,
                                       k0 + BK, n_keys, a.d, tid);
      load_tile<DP, BK, LDV, kThreads>(vs + (st ^ 1) * BK * LDV, v, a.v_s,
                                       k0 + BK, n_keys, a.d, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();            // this tile's group has landed
    __syncthreads();
    if constexpr (kQInRegs) {
      if (tile == 0) {
#pragma unroll
        for (int kc = 0; kc < KS; ++kc)
          q_fragment<LDK>(qw, kc, gr, tq, qh[kc], ql[kc]);
      }
    }
    const int kw0 = k0 + wk0;      // the warp's first key of this tile
    if (kw0 < n_keys) {            // (decode: a slice past the keys idles)
      const float* kt = ks + st * BK * LDK + wk0 * LDK;
      const float* vt = vs + st * BK * LDV + wk0 * LDV;
      // 8-key column tiles that hold a key: the rest of a slice that
      // reaches past the last key is skipped (its P is 0)
      const int n_live = min(NT, (n_keys - kw0 + 7) / 8);

      // S = Q K^T: b0, b1 = K[key g][2t], K[key g][2t + 1], one 64-bit load
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        uint32_t ah[4], al[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qh[kc][e];
            al[e] = ql[kc][e];
          }
        } else {
          q_fragment<LDK>(qw, kc, gr, tq, ah, al);
        }
        // each pass over the NT column tiles before the next, so that
        // products into one accumulator are NT apart
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < n_live) {
            const float2 kx = *reinterpret_cast<const float2*>(
                kt + (n * 8 + gr) * LDK + kc * 8 + 2 * tq);
            split_tf32(kx.x, bh[n][0], bl[n][0]);
            split_tf32(kx.y, bh[n][1], bl[n][1]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < n_live) mma_tf32(s[n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < n_live) mma_tf32(s[n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < n_live) mma_tf32(s[n], ah, bh[n]);
      }

      // scale, mask, and the slice's row maxima
      const bool masked = kw0 + WK > seen_by_all;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (masked) {
            const int key = kw0 + n * 8 + 2 * tq + (e & 1);
            if (key >= n_keys || (a.causal && key > pos[e >> 1]))
              x = -INFINITY;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      // online softmax: rescale the running state to the new maxima
      float m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= corr;                // this lane's share of the row's sum
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          acc[t][2 * r] *= corr;
          acc[t][2 * r + 1] *= corr;
        }
      }
      // acc += P V over k-steps of 8 keys: P's C fragment of S is its A
      // fragment (a0 = c0, a1 = c2, a2 = c1, a3 = c3); b0, b1 = V[key 2t][g],
      // V[key 2t + 1][g]
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= n_live) break;
        const float p0 = exp2f(s[n][0] - m_use[0]);
        const float p1 = exp2f(s[n][1] - m_use[0]);
        const float p2 = exp2f(s[n][2] - m_use[1]);
        const float p3 = exp2f(s[n][3] - m_use[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        uint32_t ph[4], pl[4];
        split_tf32(p0, ph[0], pl[0]);
        split_tf32(p2, ph[1], pl[1]);
        split_tf32(p1, ph[2], pl[2]);
        split_tf32(p3, ph[3], pl[3]);
        const float* vr = vt + (n * 8 + 2 * tq) * LDV + gr;
        // each pass over up to 8 output tiles before the next
#pragma unroll
        for (int t0 = 0; t0 < DT; t0 += kPassTiles) {
          uint32_t bh[kPassTiles][2], bl[kPassTiles][2];
#pragma unroll
          for (int j = 0; j < kPassTiles; ++j) {
            split_tf32(vr[(t0 + j) * 8], bh[j][0], bl[j][0]);
            split_tf32(vr[LDV + (t0 + j) * 8], bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int j = 0; j < kPassTiles; ++j)
            mma_tf32(acc[t0 + j], pl, bh[j]);
#pragma unroll
          for (int j = 0; j < kPassTiles; ++j)
            mma_tf32(acc[t0 + j], ph, bl[j]);
#pragma unroll
          for (int j = 0; j < kPassTiles; ++j)
            mma_tf32(acc[t0 + j], ph, bh[j]);
        }
      }
    }
    __syncthreads();     // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  float* o = a.o + b * a.o_b;
  if constexpr (!kDecode) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
      if (row[r] >= rows) continue;
      const int g = row[r] / a.sq, i = row[r] - g * a.sq;
      float* dst = o + (long long)(hk * a.group + g) * a.o_h +
                   (long long)i * a.o_s;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const int col = t * 8 + 2 * tq;
        if (col < a.d)
          *reinterpret_cast<float2*>(dst + col) = make_float2(
              acc[t][2 * r] / denom, acc[t][2 * r + 1] / denom);
      }
    }
  } else {
    // Join the warps' slices: m = max m_w, l = sum l_w 2^(m_w - m), out =
    // sum acc_w 2^(m_w - m) / max(l, 1e-30). The ring is free now.
    __syncthreads();
    float* jm = smem;                        // [kWarps][kRows]
    float* jl = jm + kWarps * kRows;         // [kWarps][kRows]
    float* ja = jl + kWarps * kRows;         // [kWarps][kRows][DP]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lsum = quad_sum(l[r]);
      const int jr = warp * kRows + gr + 8 * r;
      if (tq == 0) {
        jm[jr] = m[r];
        jl[jr] = lsum;
      }
#pragma unroll
      for (int t = 0; t < DT; ++t)
        *reinterpret_cast<float2*>(ja + jr * DP + t * 8 + 2 * tq) =
            make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
    }
    __syncthreads();
    constexpr int kPerRow = kThreads / kRows;   // threads per row
    constexpr int kPer = DP / kPerRow;          // columns per thread
    const int jr = tid / kPerRow, c0 = (tid % kPerRow) * kPer;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, jm[w * kRows + jr]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float wt[kWarps], lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wt[w] = exp2f(jm[w * kRows + jr] - mu);
      lsum += jl[w * kRows + jr] * wt[w];
    }
    const float denom = fmaxf(lsum, 1e-30f);
    if (r0 + jr < rows) {
      const int g = (r0 + jr) / a.sq, i = (r0 + jr) - g * a.sq;
      float* dst = o + (long long)(hk * a.group + g) * a.o_h +
                   (long long)i * a.o_s;
#pragma unroll
      for (int c = c0; c < c0 + kPer; c += 2) {
        if (c >= a.d) break;
        float2 y = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float2 x = *reinterpret_cast<const float2*>(
              ja + (w * kRows + jr) * DP + c);
          y.x += x.x * wt[w];
          y.y += x.y * wt[w];
        }
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(y.x / denom, y.y / denom);
      }
    }
  }
}

template <int DP, bool kDecode>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  using Sh = Shape<DP, kDecode>;
  auto kern = flash_attention_f32_kernel<DP, kDecode>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::kSmem);
  if (err != cudaSuccess) return err;
  const int rows = a.group * a.sq;
  const dim3 grid(batch * a.hkv, (rows + Sh::BQ - 1) / Sh::BQ);
  kern<<<grid, Sh::kThreads, Sh::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_rows(const Args& a, int batch, cudaStream_t stream) {
  // at most 16 rows per kv head (decode) fill one m-tile
  if (a.group * a.sq <= kRows) return launch<DP, true>(a, batch, stream);
  return launch<DP, false>(a, batch, stream);
}

}  // namespace

extern "C" {

// float32 only. Returns the CUDA error of the launch.
int flash_attention_f32_launch(const void* q, const void* k, const void* v,
                               void* o, int batch, int h, int hkv, int sq,
                               int skv, int d, long long q_b, long long q_h,
                               long long q_s, long long k_b, long long k_h,
                               long long k_s, long long v_b, long long v_h,
                               long long v_s, long long o_b, long long o_h,
                               long long o_s, int causal, int kv_offset,
                               float sm_scale, void* stream) {
  if (d < 4 || d > 128 || d % 4 != 0 || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o), hkv,
               h / hkv, sq, skv, d, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h,
               v_s, o_b, o_h, o_s, causal, kv_offset, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return (int)launch_rows<32>(a, batch, s);
  if (d <= 64) return (int)launch_rows<64>(a, batch, s);
  return (int)launch_rows<128>(a, batch, s);
}

}  // extern "C"
