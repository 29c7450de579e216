// Split-KV flash attention for Hopper (sm_90a): the "split" route of the
// port's flash_attention, for bfloat16 calls with at most 16 query rows per
// kv head (G * Sq <= 16: a decode step), D <= 128 and D % 8 == 0. The
// other bfloat16 calls take flash_attention_mma.cu ("mma"), float32 calls
// flash_attention_f32.cu ("f32").
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel) and computes what it computes: float32 scores, an online
// softmax with running max m and sum l, P rounded to bfloat16 before the
// P V product (p.astype(v.dtype)), accumulated in float32, l summed from
// the unrounded P, the output acc / max(l, 1e-30) in bfloat16, the causal
// mask at absolute query position kv_offset + i, GQA through the flattened
// (g, i) row index over the group's G = H / Hkv query heads. q, k, v and
// out are given by batch, head and position strides in elements with d
// contiguous, so the model's [B, S, H, d] projections and its [B, max_len,
// Hkv, d] cache are read in place; rows start on 16-byte boundaries.
//
// Bound on an H100 SXM: bytes. A decode step reads each visible K/V row
// once (granite-3-2b: 4 x 8 kv heads x 4098 keys x 64 x 2 x 2 B = 33.6 MB
// per layer, 0.0100 ms at 3.35 TB/s) and does 4 d operations per (row,
// key) pair, about 2 per byte: far below the card's ops-per-byte line, so
// the CUDA cores suffice and the design is about keeping bytes in flight.
//
// Design:
//   * Split the keys. Grid (B * Hkv, n_split): a block owns one kv head's
//     R = G * Sq query rows and one contiguous range of split_keys keys (a
//     multiple of 64) of the n_keys visible ones (causal: min(Skv,
//     kv_offset + Sq); else Skv). The wrapper picks the split: n_split =
//     min(tiles, ceil(2 * SMs / (B * Hkv))) with tiles = ceil(n_keys / 64),
//     then split_keys = 64 * ceil(tiles / n_split) and n_split = ceil(tiles
//     / (split_keys / 64)), so the grid has at least 2 blocks per SM where
//     the keys allow it (granite decode: 32 x 9 = 288 blocks of 8 tiles).
//   * Every warp holds every row of the block; the 4 warps split each
//     64-key tile, 16 keys each, so a K/V row is read once per (kv head,
//     split) for all G heads. The kernel is compiled for each row count R
//     in 1..16, so no warp holds an empty row and the rows' independent
//     softmax chains interleave.
//   * Scores: two lanes per key, each over half of the padded head dim DP,
//     joined by one shuffle; Q is staged once as float in shared memory
//     and read as broadcasts. P V: a lane owns DP / 32 output columns and
//     reads the warp's bf16-rounded P from shared memory.
//   * Bytes in flight: K and V tiles pass through a 3-stage ring in shared
//     memory, filled by 16-byte cp.async.cg copies (zero-filled past the
//     split's last key and past d), kept in bf16 and converted at use;
//     rows padded to DP + 8 bf16 so the 8 rows of a quarter-warp's 16-byte
//     loads fall on distinct banks. Two tiles load while one is computed.
//   * Each warp keeps its own (m, l, acc) over its keys; the block joins
//     its 4 warps in shared memory and writes one float32 partial (m, l,
//     acc[d]) per row to scratch the wrapper allocates; a row with no
//     visible key in the split writes m = -inf, l = 0, acc = 0.
//   * Combine: a second small kernel, one warp per row: m = max m_s,
//     l = sum l_s e^(m_s - m), out = sum acc_s e^(m_s - m) / max(l,
//     1e-30), in bfloat16. So a call costs two device launches (one host
//     call). Scores are kept in log2 units (scaled by log2 e, exp2f).
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;              // keys per tile
constexpr int kKW = kBK / kWarps;    // keys per warp per tile
constexpr int kStages = 3;           // K/V ring depth
constexpr int kPad = 8;              // bf16 of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* part_m;      // [n_split][n_rows]
  float* part_l;      // [n_split][n_rows]
  float* part_acc;    // [n_split][n_rows][d]
  int h, hkv, group, sq, d;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int causal, kv_offset, n_keys, split_keys, n_split, n_rows;
  float scale;        // sm_scale * log2 e
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    x[2 * t] = f.x;
    x[2 * t + 1] = f.y;
  }
}

// N consecutive bf16 (N in {1, 2, 4}, aligned to 2 N bytes) as floats
template <int N>
__device__ __forceinline__ void load_cols(const bf16* p, float* x) {
  if constexpr (N == 1) {
    x[0] = __bfloat162float(*p);
  } else if constexpr (N == 2) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = f.x;
    x[1] = f.y;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    x[0] = f0.x;
    x[1] = f0.y;
    x[2] = f1.x;
    x[3] = f1.y;
  }
}

// Copy keys k0 .. k0 + kBK - 1 of one kv head (rows of ``stride``) into a
// [kBK][DP + kPad] tile; keys at or past ``k_hi`` and columns at or past d
// are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int k0, int k_hi,
                                          int d, int tid) {
  constexpr int CH = DP / 8;                 // 16-byte chunks per row
  constexpr int IT = kBK * CH / kThreads;
  static_assert(kBK * CH % kThreads == 0, "tile chunks split evenly");
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * kThreads;
    const int r = e / CH, c = (e % CH) * 8;
    const bool full = k0 + r < k_hi && c < d;
    const bf16* from = full ? src + (long long)(k0 + r) * stride + c : src;
    cp_async16(smem_addr(dst + r * (DP + kPad) + c), from, full);
  }
}

constexpr int kMaxRows = 16;        // query rows per kv head (G * Sq)

template <int DP, int R>
constexpr size_t smem_bytes() {
  return (size_t)kStages * 2 * kBK * (DP + kPad) * sizeof(bf16) +
         (size_t)R * DP * sizeof(float) +
         (size_t)kWarps * R * kKW * sizeof(float);
}

template <int DP, int R>
__global__ void __launch_bounds__(kThreads)
flash_attention_split_kernel(const Args a) {
  constexpr int LD = DP + kPad;
  constexpr int HALF = DP / 2;       // head dims per lane in the scores
  constexpr int CPL = DP / 32;       // output columns per lane
  constexpr int TILE = kBK * LD;     // bf16 per K (or V) tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [kStages][K, V][TILE]
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * TILE);  // [R][DP]
  float* ps = qs + R * DP;                          // [kWarps][R][kKW]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / a.hkv, hk = bh % a.hkv;
  const bf16* q = a.q + b * a.q_b;
  const bf16* k = a.k + b * a.k_b + hk * a.k_h;
  const bf16* v = a.v + b * a.v_b + hk * a.v_h;
  const int k_lo = split * a.split_keys;
  const int k_hi = min(k_lo + a.split_keys, a.n_keys);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  // the first kStages - 1 tiles in flight, one group each
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      bf16* st = ring + t * 2 * TILE;
      load_tile<DP>(st, k, a.k_s, k_lo + t * kBK, k_hi, a.d, tid);
      load_tile<DP>(st + TILE, v, a.v_s, k_lo + t * kBK, k_hi, a.d, tid);
    }
    cp_async_commit();
  }
  // Q as float, zero past d
  for (int e = tid; e < R * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    float x = 0.f;
    if (c < a.d) {
      const int g = r / a.sq, i = r - g * a.sq;
      x = __bfloat162float(q[(long long)(hk * a.group + g) * a.q_h +
                             (long long)i * a.q_s + c]);
    }
    qs[e] = x;
  }

  const int jj = lane & (kKW - 1), hf = lane >> 4;   // key, half of DP
  float m[R], l[R], acc[R][CPL];
  int pos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    pos[r] = a.kv_offset + r % a.sq;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + warp * R * kKW;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();    // tile t has landed (this thread's)
    __syncthreads();                 // ... everyone's; tile t - 1 consumed
    const int nt = t + kStages - 1;  // refill the stage tile t - 1 used
    if (nt < n_tiles) {
      bf16* st = ring + (nt % kStages) * 2 * TILE;
      load_tile<DP>(st, k, a.k_s, k_lo + nt * kBK, k_hi, a.d, tid);
      load_tile<DP>(st + TILE, v, a.v_s, k_lo + nt * kBK, k_hi, a.d, tid);
    }
    cp_async_commit();
    const bf16* kt = ring + (t % kStages) * 2 * TILE;
    const bf16* vt = kt + TILE;
    const int key = k_lo + t * kBK + warp * kKW + jj;

    // scores of this lane's key over its half of DP, joined across halves
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const bf16* krow = kt + (warp * kKW + jj) * LD + hf * HALF;
#pragma unroll
    for (int c = 0; c < HALF; c += 8) {
      float kf[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(krow + c), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* qr = qs + r * DP + hf * HALF + c;
        const float4 q0 = *reinterpret_cast<const float4*>(qr);
        const float4 q1 = *reinterpret_cast<const float4*>(qr + 4);
        s[r] += q0.x * kf[0] + q0.y * kf[1] + q0.z * kf[2] + q0.w * kf[3] +
                q1.x * kf[4] + q1.y * kf[5] + q1.z * kf[6] + q1.w * kf[7];
      }
    }

    // mask, online softmax over the warp's 16 keys, P rounded to bf16
    // (the __syncthreads above ordered the previous tile's reads of pw)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = (s[r] + __shfl_xor_sync(0xffffffffu, s[r], 16)) * a.scale;
      if (key >= k_hi || (a.causal && key > pos[r])) x = -INFINITY;
      float mx = x;
#pragma unroll
      for (int o = kKW / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[r] - m_use);
      const float p = exp2f(x - m_use);
      l[r] = l[r] * corr + (hf == 0 ? p : 0.f);   // each key counted once
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] *= corr;
      if (hf == 0)
        pw[r * kKW + jj] = __bfloat162float(__float2bfloat16_rn(p));
    }
    __syncwarp();

    // acc += P V over the warp's 16 keys; this lane's columns
#pragma unroll
    for (int j4 = 0; j4 < kKW; j4 += 4) {
      float4 pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pr[r] = *reinterpret_cast<const float4*>(pw + r * kKW + j4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPL];
        load_cols<CPL>(vt + (warp * kKW + j4 + u) * LD + lane * CPL, vv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = u == 0 ? pr[r].x : u == 1 ? pr[r].y
                        : u == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[r][c] += p * vv[c];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the join

  // join the 4 warps' (m, l, acc) in shared memory
  float* wm = reinterpret_cast<float*>(smem_raw);   // [kWarps][R]
  float* wl = wm + kWarps * R;                      // [kWarps][R]
  float* wacc = wl + kWarps * R;                    // [kWarps][R][DP]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lsum = warp_sum(l[r]);
    if (lane == 0) {
      wm[warp * R + r] = m[r];
      wl[warp * R + r] = lsum;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      wacc[(warp * R + r) * DP + lane * CPL + c] = acc[r][c];
  }
  __syncthreads();
  for (int e = tid; e < R * DP; e += kThreads) {
    const int r = e / DP, col = e % DP;
    if (col >= a.d) continue;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm[w * R + r]);
    const float mu = mb == -INFINITY ? 0.f : mb;
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * R + r] - mu);
      lb += wl[w * R + r] * f;
      ab += wacc[(w * R + r) * DP + col] * f;
    }
    const long long idx = (long long)split * a.n_rows + (long long)bh * R + r;
    a.part_acc[idx * a.d + col] = ab;
    if (col == 0) {
      a.part_m[idx] = mb;
      a.part_l[idx] = lb;
    }
  }
}

// One warp per query row (b, h, i) in q's flattened order: joins the
// n_split partials and writes the row's output. The lanes read the splits'
// (m, l) side by side, 32 at a time, and pass each split's weight
// e^(m_s - m) to the others by shuffle; a lane's columns then sum
// independent loads.
__global__ void __launch_bounds__(kThreads)
flash_attention_combine_kernel(const Args a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.n_rows) return;
  float m = -INFINITY;
  for (int s = lane; s < a.n_split; s += 32)
    m = fmaxf(m, a.part_m[(long long)s * a.n_rows + row]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float mu = m == -INFINITY ? 0.f : m;
  float l = 0.f;
  for (int s = lane; s < a.n_split; s += 32) {
    const long long idx = (long long)s * a.n_rows + row;
    l += a.part_l[idx] * exp2f(a.part_m[idx] - mu);
  }
  const float denom = fmaxf(warp_sum(l), 1e-30f);
  const int i = row % a.sq, bh = row / a.sq;
  const int hh = bh % a.h, b = bh / a.h;
  bf16* dst = a.o + b * a.o_b + hh * a.o_h + (long long)i * a.o_s;
  constexpr int kCols = 128 / 32;            // columns per lane, d <= 128
  float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < a.n_split; s0 += 32) {
    const int sl = s0 + lane;
    const float w = sl < a.n_split
        ? exp2f(a.part_m[(long long)sl * a.n_rows + row] - mu) : 0.f;
    const int n = min(32, a.n_split - s0);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float wt = __shfl_sync(0xffffffffu, w, t);
      const float* src = a.part_acc +
          ((long long)(s0 + t) * a.n_rows + row) * a.d;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < a.d) acc[c] += src[col] * wt;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = lane + 32 * c;
    if (col < a.d) dst[col] = __float2bfloat16_rn(acc[c] / denom);
  }
}

template <int DP, int R>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP, R>();
  static_assert(2 * kWarps * R + kWarps * R * DP <=
                    kStages * 2 * kBK * (DP + kPad) / 2,
                "the join fits in the ring");
  auto kern = flash_attention_split_kernel<DP, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(batch * a.hkv, a.n_split), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_combine_kernel<<<(a.n_rows + kWarps - 1) / kWarps,
                                   kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// the kernel compiled for exactly this call's G * Sq rows
template <int DP, int R = 1>
cudaError_t launch_rows(const Args& a, int batch, cudaStream_t stream) {
  if constexpr (R < kMaxRows) {
    if (a.group * a.sq > R) return launch_rows<DP, R + 1>(a, batch, stream);
  }
  return launch<DP, R>(a, batch, stream);
}

}  // namespace

extern "C" {

// bfloat16 only; scratch holds n_split * B * H * Sq * (d + 2) floats.
// Returns the CUDA error of the launches.
int flash_attention_split_launch(
    const void* q, const void* k, const void* v, void* o, void* scratch,
    int batch, int h, int hkv, int sq, int skv, int d, long long q_b,
    long long q_h, long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b, long long o_h,
    long long o_s, int causal, int kv_offset, float sm_scale, int n_split,
    int split_keys, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || hkv < 1 || h % hkv != 0 ||
      (h / hkv) * sq > kMaxRows || n_split < 1 || split_keys < kBK ||
      split_keys % kBK != 0)
    return (int)cudaErrorInvalidValue;
  const int n_keys = causal ? min(skv, kv_offset + sq) : skv;
  const int n_rows = batch * h * sq;
  float* part = static_cast<float*>(scratch);
  const long long n_part = (long long)n_split * n_rows;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(o), part,
               part + n_part, part + 2 * n_part, h, hkv, h / hkv, sq, d,
               q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s,
               causal, kv_offset, n_keys, split_keys, n_split, n_rows,
               sm_scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return (int)launch_rows<32>(a, batch, s);
  if (d <= 64) return (int)launch_rows<64>(a, batch, s);
  return (int)launch_rows<128>(a, batch, s);
}

}  // extern "C"
