// Flash attention on the tensor cores for Hopper (sm_90a): the "mma" route
// of the port's flash_attention, for bfloat16 inputs whose kv head has more
// than 16 query rows (prefill, a cache-free forward, an encoder, a short
// prompt; a block of 64 rows may be partly filled). Decode steps take
// flash_attention_split.cu, float32 inputs flash_attention_f32.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel) and computes what it computes: an online softmax over key
// tiles with float32 scores S, running max m and sum l; P rounded to
// bfloat16 for the P V product, accumulated in float32; l summed from the
// unrounded P; the output acc / max(l, 1e-30) in bfloat16; the causal mask
// at absolute query position kv_offset + i; GQA through the flattened
// (g, i) row index over the group's G = H / Hkv query heads. q, k, v and
// out are given by batch, head and position strides in elements with d
// contiguous, so the model's [B, S, H, d] projections and its [B, max_len,
// Hkv, d] cache are read in place.
// d % 8 == 0, d <= 128, rows on 16-byte boundaries; the head dim is padded
// to DP in {32, 64, 128} with zero-filled columns, 8 at a time.
//
// Bound on an H100 SXM: operations. 4 d flops per visible (query, key)
// pair (two products of 2 d each): ~2.75e11 per granite-3-2b prefill layer
// at 4 x 4096 (0.28 ms at 989 TFLOP/s of bf16 on the tensor cores), where
// the bytes (q, out and the visible K/V rows, ~0.15 GB) take 0.05 ms.
//
// Design (FlashAttention-2's, with mma.sync rather than wgmma):
//   * Block: 4 warps, BQ = 64 flattened query rows (16 per warp), key
//     tiles of BK = 64; templated over the padded head dim DP in
//     {32, 64, 128}. Grid (B * Hkv, ceil(G * Sq / 64)), blockIdx.y walked
//     in reverse so the longest causal blocks start first.
//   * Q is staged once through shared memory into registers as ldmatrix
//     A fragments of mma.sync.m16n8k16 (bf16 in, float32 accumulate).
//   * K and V pass through a two-stage ring in shared memory filled by
//     16-byte cp.async.cg copies: the next tile's copies are in flight
//     while the current tile is computed. Rows are padded to DP + 8 bf16,
//     so the 8 rows an ldmatrix reads fall on distinct banks. Rows past
//     the last key and columns past d are zero-filled (cp.async with
//     src-size 0).
//   * S = Q K^T with K as the col operand (ldmatrix); the row max and sum
//     are reduced over the 4 lanes of a quad; a row with no visible key so
//     far uses 0 as its max (m_use).
//   * P stays in registers: the float32 C fragment of S, converted to
//     bf16 pairs, is the A fragment of the P V product; V comes in through
//     ldmatrix.trans.
//   * The per-element mask runs only on tiles that reach past the keys
//     every row of the warp sees (a row's diagonal, or Skv); tiles past
//     the block's last visible key are never loaded.
//   * Shared memory: (BQ + 4 BK) (DP + 8) bf16: 45 KB at DP = 64, 85 KB
//     at DP = 128. Inline PTX only (no CUTLASS/CuTe), so nvcc takes
//     seconds.
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;   // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kPad = 8;            // bf16 of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int hkv, group, sq, skv, d;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int causal, kv_offset;
  float sm_scale;
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, ``lo`` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy keys k0 .. k0 + kBK - 1 of one kv head (rows of ``stride``) into a
// [kBK][DP + kPad] tile; rows at or past ``n_keys`` and columns at or past
// d are zero-filled.
template <int DP>
__device__ __forceinline__ void load_kv_tile(bf16* dst, const bf16* src,
                                             long long stride, int k0,
                                             int n_keys, int d, int tid) {
  constexpr int CH = DP / 8;                 // 16-byte chunks per row
  constexpr int IT = kBK * CH / kThreads;
  static_assert(kBK * CH % kThreads == 0, "tile chunks split evenly");
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * kThreads;
    const int r = e / CH, c = (e % CH) * 8;
    const bool full = k0 + r < n_keys && c < d;
    const bf16* from = full ? src + (long long)(k0 + r) * stride + c : src;
    cp_async16(smem_addr(dst + r * (DP + kPad) + c), from, full);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const Args a) {
  constexpr int LD = DP + kPad;
  constexpr int KC = DP / 16;     // 16-wide chunks of the head dim
  constexpr int NT = kBK / 8;     // 8-key column tiles of S
  constexpr int DT = DP / 8;      // 8-wide column tiles of the output
  constexpr int CH = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // [kBQ][LD]
  bf16* ks = qs + kBQ * LD;                        // [2][kBK][LD]
  bf16* vs = ks + 2 * kBK * LD;                    // [2][kBK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int rows = a.group * a.sq;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const bf16* q = a.q + b * a.q_b;
  const bf16* k = a.k + b * a.k_b + hk * a.k_h;
  const bf16* v = a.v + b * a.v_b + hk * a.v_h;

  // Keys this block needs: all of Skv, or (causal) up to its last row's
  // position. A block that spans two heads of the group holds row Sq - 1.
  const int last = min(r0 + kBQ, rows) - 1;
  const int max_i = (r0 / a.sq == last / a.sq) ? last % a.sq : a.sq - 1;
  const int n_keys = a.causal ? min(a.skv, a.kv_offset + max_i + 1) : a.skv;
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  // Q (zero past the last row and past d) and tile 0 in the first group
  for (int e = tid; e < kBQ * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 8, rf = r0 + r;
    const bool full = rf < rows && c < a.d;
    const bf16* from = q;
    if (full) {
      const int g = rf / a.sq, i = rf - g * a.sq;
      from = q + (long long)(hk * a.group + g) * a.q_h +
             (long long)i * a.q_s + c;
    }
    cp_async16(smem_addr(qs + r * LD + c), from, full);
  }
  if (n_tiles > 0) {
    load_kv_tile<DP>(ks, k, a.k_s, 0, n_keys, a.d, tid);
    load_kv_tile<DP>(vs, v, a.v_s, 0, n_keys, a.d, tid);
  }
  cp_async_commit();

  // This lane's rows: gr and gr + 8 of the warp's 16 (C-fragment layout).
  const int gr = lane >> 2, tq = lane & 3;
  const int wr0 = r0 + warp * 16;
  const int row[2] = {wr0 + gr, wr0 + gr + 8};
  const int pos[2] = {a.kv_offset + row[0] % a.sq,
                      a.kv_offset + row[1] % a.sq};
  // keys every row of the warp sees: tiles below need no mask
  const int wlast = min(wr0 + 15, rows - 1);
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
  uint32_t qf[KC][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK, st = tile & 1;
    if (tile + 1 < n_tiles) {
      load_kv_tile<DP>(ks + (st ^ 1) * kBK * LD, k, a.k_s, k0 + kBK, n_keys,
                       a.d, tid);
      load_kv_tile<DP>(vs + (st ^ 1) * kBK * LD, v, a.v_s, k0 + kBK, n_keys,
                       a.d, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();            // this tile's group has landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], smem_addr(qs + (warp * 16 + (lane & 15)) * LD +
                                      kc * 16 + (lane >> 4) * 8));
    }
    const bf16* kt = ks + st * kBK * LD;
    const bf16* vt = vs + st * kBK * LD;

    // S = Q K^T: key tiles 2 np and 2 np + 1 from one ldmatrix.x4
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_addr(
            kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
            kc * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kc], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kb[2], kb[3]);
      }
    }

    // scale, mask, and the tile's row maxima
    const bool masked = k0 + kBK > seen_by_all;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale;
        if (masked) {
          const int key = k0 + t * 8 + 2 * tq + (e & 1);
          if (key >= n_keys || (a.causal && key > pos[e >> 1])) x = -INFINITY;
        }
        s[t][e] = x;
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
      l[r] *= corr;                  // this lane's share of the row's sum
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        acc[t][2 * r] *= corr;
        acc[t][2 * r + 1] *= corr;
      }
    }
    // P in float32 for l, rounded to bf16 pairs: the A fragments of P V
    uint32_t pf[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float p0 = exp2f(s[t][0] - m_use[0]);
      const float p1 = exp2f(s[t][1] - m_use[0]);
      const float p2 = exp2f(s[t][2] - m_use[1]);
      const float p3 = exp2f(s[t][3] - m_use[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[t][0] = pack_bf16(p0, p1);
      pf[t][1] = pack_bf16(p2, p3);
    }
    // acc += P V: keys 16 kk .. 16 kk + 15, output tiles 2 dp, 2 dp + 1
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1],
                              pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_addr(
            vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
            dp * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();     // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  bf16* o = a.o + b * a.o_b;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row[r] >= rows) continue;
    const int g = row[r] / a.sq, i = row[r] - g * a.sq;
    bf16* dst = o + (long long)(hk * a.group + g) * a.o_h +
                (long long)i * a.o_s;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int col = t * 8 + 2 * tq;
      if (col < a.d)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[t][2 * r] / denom, acc[t][2 * r + 1] / denom);
    }
  }
}

template <int DP>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ + 4 * kBK) * (DP + kPad) * sizeof(bf16);
  auto kern = flash_attention_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = a.group * a.sq;
  const dim3 grid(batch * a.hkv, (rows + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 only. Returns the CUDA error of the launch.
int flash_attention_mma_launch(const void* q, const void* k, const void* v,
                               void* o, int batch, int h, int hkv, int sq,
                               int skv, int d, long long q_b, long long q_h,
                               long long q_s, long long k_b, long long k_h,
                               long long k_s, long long v_b, long long v_h,
                               long long v_s, long long o_b, long long o_h,
                               long long o_s, int causal, int kv_offset,
                               float sm_scale, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(o), hkv,
               h / hkv, sq, skv, d, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h,
               v_s, o_b, o_h, o_s, causal, kv_offset, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return (int)launch<32>(a, batch, s);
  if (d <= 64) return (int)launch<64>(a, batch, s);
  return (int)launch<128>(a, batch, s);
}

}  // extern "C"
