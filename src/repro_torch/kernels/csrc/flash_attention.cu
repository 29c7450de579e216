// Flash attention for Hopper (sm_90a): online-softmax attention with GQA,
// a causal mask at absolute query position kv_offset + i, and causal tile
// skipping. The port's first K6 kernel ("simt"), on the CUDA cores. No
// route of flash_attention reaches it now: chip_smoke.py launches it only
// as the yardstick of the other routes, on the same inputs.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel). The TPU kernel walks a sequential (head, q block, kv
// block) grid and carries the running max, sum and accumulator in VMEM
// scratch from one kv step to the next; here one thread block owns a block
// of query rows and loops over the kv tiles itself, carrying that state in
// registers.
//
// Layout: q [B, H, Sq, d], k/v [B, Hkv, Skv, d], out [B, H, Sq, d], each
// given by its batch, head and position strides in elements (d contiguous),
// so the model's [B, S, H, d] projections and its [B, max_len, Hkv, d]
// cache are read in place, without a transpose. d <= 128; rows start on a
// 16-byte boundary.
//
// Grid: (B * Hkv, query blocks). The rows of a block are BQ consecutive
// entries of the flattened (g, i) index over the group's G = H / Hkv query
// heads and Sq positions of one kv head: GQA reads kv head h // G once for
// all G heads, and a decode step (Sq = 1) puts its G heads into one block.
// Each of the 4 warps owns RPW rows (RPW = 16 for prefill, 2 when the group
// has at most 8 rows). Per kv tile of kBK = 64 keys the block
//   1. stages K (transposed, padded against bank conflicts) and V in shared
//      memory as float, zero past the last key it needs;
//   2. each lane scores keys lane and lane + 32 against its warp's rows
//      (Q from shared memory as float4 broadcasts);
//   3. masks keys past Skv and, when causal, keys after the row's position
//      with -inf, and updates the row's running max m and sum l; the
//      accumulator is rescaled by exp(m_old - m_new);
//   4. adds P V into the accumulator (d / 32 columns per lane).
// Tiles past the block's last visible key (causal: kv_offset + max i) are
// never loaded, which skips the blocks wholly above the diagonal and the
// unwritten rows of a cache. The output is acc / max(l, 1e-30) in q's
// dtype, as the TPU kernel's finalize step.
//
// Bound on an H100 SXM: prefill is bound by operations (4 d flops per
// visible (query, key) pair; ~2.75e11 per granite-3-2b layer at 4 x 4096,
// 0.28 ms at the bf16 tensor-core rate), decode by bytes (the K/V rows up to
// the cache length, ~34 MB per layer at 4 x 4128 x 8 heads, ~10 us). This
// first kernel computes on the CUDA cores in float32 (no wgmma, no TMA, no
// overlap of loads and compute), so it sits far above the operations bound;
// its design keeps what the bound counts: each K/V row is read once per
// (kv head, query block) and the scores never leave the chip.
#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;            // keys per tile
constexpr int kKP = kBK + 1;       // padded row of the transposed K tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hkv, group, sq, skv, d;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int causal, kv_offset;
  float sm_scale;
};

// 16-byte vectors of the element type: raw load and conversion to float.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static void to_float(const uint4& raw, float* x) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = f[t];
  }
  __device__ static float from_float(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void to_float(const uint4& raw, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      x[2 * t] = f.x;
      x[2 * t + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DP>
constexpr size_t smem_floats(int bq) {
  return (size_t)bq * DP + DP * kKP + kBK * DP + (size_t)bq * kBK;
}

template <typename T, int DP, int RPW>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  constexpr int BQ = kWarps * RPW;
  constexpr int NC = DP / 32;            // output columns per lane
  constexpr int CH = DP / V;             // 16-byte chunks per row
  constexpr int KV_IT = kBK * CH / kThreads;
  static_assert(kBK * CH % kThreads == 0, "tile chunks split evenly");

  extern __shared__ float smem[];
  float* qs = smem;                      // [BQ][DP]
  float* kt = qs + BQ * DP;              // [DP][kKP]: K transposed
  float* vs = kt + DP * kKP;             // [kBK][DP]
  float* ps = vs + kBK * DP;             // [BQ][kBK]: this tile's p

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int rows = a.group * a.sq;
  const int r0 = blockIdx.y * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.q_b;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + hk * a.k_h;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + hk * a.v_h;

  for (int e = tid; e < BQ * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * V, rf = r0 + r;
    float x[V];
    if (rf < rows && c < a.d) {
      const int g = rf / a.sq, i = rf - g * a.sq;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          q + (long long)(hk * a.group + g) * a.q_h + (long long)i * a.q_s +
          c));
      E::to_float(raw, x);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) x[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < V; ++t) qs[r * DP + c + t] = x[t];
  }

  // Keys this block needs: all of Skv, or (causal) up to its last row's
  // position. A block that spans two heads of the group holds row Sq - 1.
  const int last = min(r0 + BQ, rows) - 1;
  const int max_i = (r0 / a.sq == last / a.sq) ? last % a.sq : a.sq - 1;
  const int n_keys = a.causal ? min(a.skv, a.kv_offset + max_i + 1) : a.skv;

  float acc[RPW][NC], m[RPW], l[RPW];
  int pos[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    pos[r] = a.kv_offset + (r0 + warp * RPW + r) % a.sq;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const float* qw = qs + warp * RPW * DP;
  float* pw = ps + warp * RPW * kBK;

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();     // the previous tile is consumed (and Q is staged)
    // 1. stage K (transposed) then V: all of a tensor's loads in flight
    // before the first store
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const T* src = which == 0 ? k : v;
      const long long stride = which == 0 ? a.k_s : a.v_s;
      uint4 raw[KV_IT];
#pragma unroll
      for (int it = 0; it < KV_IT; ++it) {
        const int e = tid + it * kThreads;
        const int j = e / CH, c = (e % CH) * V;
        raw[it] = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + j < n_keys && c < a.d)
          raw[it] = __ldg(reinterpret_cast<const uint4*>(
              src + (long long)(k0 + j) * stride + c));
      }
#pragma unroll
      for (int it = 0; it < KV_IT; ++it) {
        const int e = tid + it * kThreads;
        const int j = e / CH, c = (e % CH) * V;
        float x[V];
        E::to_float(raw[it], x);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          if (which == 0) kt[(c + t) * kKP + j] = x[t];
          else vs[j * DP + c + t] = x[t];
        }
      }
    }
    __syncthreads();

    // 2. scores of keys k0 + lane and k0 + lane + 32
    float s0[RPW], s1[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s0[r] = s1[r] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float ka[4], kb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        ka[t] = kt[(dd + t) * kKP + lane];
        kb[t] = kt[(dd + t) * kKP + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * DP + dd);
        s0[r] += qv.x * ka[0] + qv.y * ka[1] + qv.z * ka[2] + qv.w * ka[3];
        s1[r] += qv.x * kb[0] + qv.y * kb[1] + qv.z * kb[2] + qv.w * kb[3];
      }
    }

    // 3. mask and online softmax
    const int key0 = k0 + lane, key1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float x0 = s0[r] * a.sm_scale, x1 = s1[r] * a.sm_scale;
      if (key0 >= n_keys || (a.causal && key0 > pos[r])) x0 = -INFINITY;
      if (key1 >= n_keys || (a.causal && key1 > pos[r])) x1 = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x0, x1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = __expf(m[r] - m_use);
      const float p0 = __expf(x0 - m_use), p1 = __expf(x1 - m_use);
      l[r] = l[r] * corr + (p0 + p1);     // this lane's share of the sum
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      pw[r * kBK + lane] = p0;
      pw[r * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // 4. acc += P V (masked keys have p = 0 and zero V rows)
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pr[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        pr[r] = *reinterpret_cast<const float4*>(pw + r * kBK + j);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vs[(j + t) * DP + c * 32 + lane];
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float p = t == 0 ? pr[r].x : t == 1 ? pr[r].y
                          : t == 2 ? pr[r].z : pr[r].w;
            acc[r][c] += p * vv;
          }
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o) + b * a.o_b;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    const int rf = r0 + warp * RPW + r;
    if (rf >= rows) continue;
    const int g = rf / a.sq, i = rf - g * a.sq;
    T* dst = o + (long long)(hk * a.group + g) * a.o_h + (long long)i * a.o_s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 32 + lane;
      if (col < a.d) dst[col] = E::from_float(acc[r][c] / denom);
    }
  }
}

template <typename T, int DP, int RPW>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int BQ = kWarps * RPW;
  const size_t smem = smem_floats<DP>(BQ) * sizeof(float);
  auto kern = flash_attention_kernel<T, DP, RPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = a.group * a.sq;
  const dim3 grid(batch * a.hkv, (rows + BQ - 1) / BQ);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_rows(const Args& a, int batch, cudaStream_t stream) {
  // a group of at most 8 rows (decode) fills one block of 2 rows per warp
  if (a.group * a.sq <= kWarps * 2) return launch<T, DP, 2>(a, batch, stream);
  return launch<T, DP, 16>(a, batch, stream);
}

template <typename T>
cudaError_t launch_dtype(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 32) return launch_rows<T, 32>(a, batch, stream);
  if (a.d <= 64) return launch_rows<T, 64>(a, batch, stream);
  return launch_rows<T, 128>(a, batch, stream);
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int batch, int h, int hkv,
                           int sq, int skv, int d, long long q_b,
                           long long q_h, long long q_s, long long k_b,
                           long long k_h, long long k_s, long long v_b,
                           long long v_h, long long v_s, long long o_b,
                           long long o_h, long long o_s, int causal,
                           int kv_offset, float sm_scale, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, hkv, h / hkv, sq, skv, d, q_b, q_h, q_s, k_b,
               k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s, causal, kv_offset,
               sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_dtype<float>(a, batch, s)
                 : launch_dtype<__nv_bfloat16>(a, batch, s);
  return (int)err;
}

}  // extern "C"
