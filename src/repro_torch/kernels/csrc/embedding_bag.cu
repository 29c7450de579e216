// Embedding bag for Hopper (sm_90a): out[b, f] = sum_j w[b, f, j] *
// table[f, idx[b, f, j]], summed in j order.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py::embedding_bag
// (body _kernel), which keeps a table shard in VMEM and adds each bag's
// weighted rows into its output row in a fori_loop over (bag, j). Here the
// table stays in device memory.
//
// Stacked fields: a [F, V, D] table with [B, F, L] indices serves all F
// fields of a model in one launch (bag b * F + f reads table f); a [V, D]
// table is F = 1.
//
// Rounding: each product and each sum is rounded to the table's dtype
// (float32: explicit round-to-nearest intrinsics, and the library is built
// with -fmad=false; bfloat16: computed in float and rounded to bfloat16, as
// PyTorch's bfloat16 multiply and add do), and each column adds in j
// order, so the result is bit-equal to the plain version that adds in the
// same order.
//
// Out-of-range index: the TPU kernel assumes every index is in [0, V). Here
// a slot whose index is outside [0, V) adds nothing to its bag (the kernel
// reads no memory outside its table row), as the plain version does.
//
// Bound on an H100 SXM: bytes. The gathered rows (L * D elements per bag),
// the indices and weights are read once and the output written once; at
// dlrm-rm2's serve_p99 (512 x 26 bags of one 64-wide f32 row) that is
// ~6.9 MB, ~2 us; at two-tower's (512 bags of 16 256-wide f32 rows) ~8.9
// MB, ~2.7 us. A bag's work is a chain: its indices, then its rows, then
// its sums.
//
// Design:
//   * A group of lanes per bag (a power of two, up to a warp), each lane
//     owning 16-byte vectors of the row: float32 D = 64 takes 16 lanes (2
//     bags per warp), D = 256 a warp with 2 vectors per lane; bfloat16 8
//     elements per vector. A row wider than the group's vectors is done in
//     passes.
//   * The bag's indices and weights are loaded once, one slot per lane,
//     and handed to the group's lanes by __shfl_sync.
//   * The row loads of up to 8 slots are all issued before the first add,
//     so a lane has up to 16 loads in flight instead of one chain per slot.
//   * A D or table pointer that does not allow 16-byte vectors takes the
//     same kernel with one element per vector (the scalar path).
//   * Blocks of 64 threads, so that a batch of 512 bags of a warp each is
//     256 blocks on the 132 SMs.
// The earlier kernel (one thread per output element, each re-reading the
// bag's indices and weights, a dependent row load per slot) stays as
// embedding_bag_prev_launch, a yardstick that only chip_smoke.py launches.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 64;       // block of the kernel
constexpr int kPrevThreads = 256;  // block of the earlier kernel
constexpr int kBatch = 8;          // slots whose row loads go out together

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float madd(float acc, float row, float w) {
  return __fadd_rn(acc, __fmul_rn(row, w));
}

__device__ __forceinline__ __nv_bfloat16 madd(__nv_bfloat16 acc,
                                              __nv_bfloat16 row, float w) {
  const __nv_bfloat16 prod =
      __float2bfloat16_rn(__fmul_rn(__bfloat162float(row), w));
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(acc), __bfloat162float(prod)));
}

// The raw type of one load of BYTES bytes.
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// E elements of T per vector, at most NV vectors per lane in one pass; a
// group of 2^lpb_log2 lanes per bag.
template <typename T, int E, int NV>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const T* __restrict__ w, T* __restrict__ out,
                     unsigned n_bags, unsigned n_fields, int bag_len,
                     long long vocab, int d, int lpb_log2) {
  using R = typename Raw<sizeof(T) * E>::type;
  const int lpb = 1 << lpb_log2;
  const unsigned bag = (blockIdx.x * kThreads + threadIdx.x) >> lpb_log2;
  // the lanes that go on: every group of the warp runs the same loops
  const unsigned mask = __ballot_sync(0xffffffffu, bag < n_bags);
  if (bag >= n_bags) return;             // the whole group returns
  const int sub = (threadIdx.x & 31) & (lpb - 1);   // place in the group
  const int n_vec = d / E;               // vectors per row
  const T* tab = table + (long long)(bag % n_fields) * vocab * d;
  const int* ib = idx + (long long)bag * bag_len;
  const T* wb = w + (long long)bag * bag_len;
  T* ob = out + (long long)bag * d;

  for (int v0 = 0; v0 < n_vec; v0 += lpb * NV) {
    T acc[NV][E];
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[n][e] = T(0.f);
    for (int j0 = 0; j0 < bag_len; j0 += lpb) {
      // this chunk's slots, one index and weight per lane
      const int jn = min(lpb, bag_len - j0);
      int my_i = -1;
      float my_w = 0.f;
      if (sub < jn) {
        my_i = __ldg(ib + j0 + sub);
        my_w = to_float(__ldg(wb + j0 + sub));
      }
      for (int jb = 0; jb < jn; jb += kBatch) {
        const int nb = min(kBatch, jn - jb);   // the same in every group
        R raw[kBatch][NV];
        float wt[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u >= nb) break;
          const int i = __shfl_sync(mask, my_i, jb + u, lpb);
          wt[u] = __shfl_sync(mask, my_w, jb + u, lpb);
          ok[u] = i >= 0 && i < vocab;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const int vi = v0 + sub + n * lpb;
            raw[u][n] = R{};
            if (ok[u] && vi < n_vec)
              raw[u][n] = __ldg(reinterpret_cast<const R*>(
                  tab + (long long)i * d + vi * E));
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u >= nb) break;
          if (!ok[u]) continue;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const T* x = reinterpret_cast<const T*>(&raw[u][n]);
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[n][e] = madd(acc[n][e], x[e], wt[u]);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int vi = v0 + sub + n * lpb;
      if (vi < n_vec) {
        R r;
        T* y = reinterpret_cast<T*>(&r);
#pragma unroll
        for (int e = 0; e < E; ++e) y[e] = acc[n][e];
        *reinterpret_cast<R*>(ob + vi * E) = r;
      }
    }
  }
}

// The earlier kernel: one thread per output element (bag, column).
template <typename T>
__global__ void __launch_bounds__(kPrevThreads)
embedding_bag_prev_kernel(const T* __restrict__ table,
                          const int* __restrict__ idx,
                          const T* __restrict__ w, T* __restrict__ out,
                          long long n_out, int n_fields, int bag_len,
                          long long vocab, int d) {
  const long long t = (long long)blockIdx.x * kPrevThreads + threadIdx.x;
  if (t >= n_out) return;
  const long long bag = t / d;
  const int col = (int)(t - bag * d);
  const T* tab = table + (bag % n_fields) * vocab * d + col;
  const int* ib = idx + bag * bag_len;
  const T* wb = w + bag * bag_len;
  T acc = T(0.f);
  for (int j = 0; j < bag_len; ++j) {
    const int i = __ldg(ib + j);
    if (i >= 0 && i < vocab)
      acc = madd(acc, __ldg(tab + (long long)i * d), to_float(__ldg(wb + j)));
  }
  out[t] = acc;
}

template <typename T, int E, int NV>
cudaError_t launch_groups(const T* table, const int* idx, const T* w, T* out,
                          long long n_bags, int n_fields, int bag_len,
                          long long vocab, int d, int lpb_log2,
                          cudaStream_t stream) {
  const long long threads = n_bags << lpb_log2;
  if (threads > 0xffffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  embedding_bag_kernel<T, E, NV><<<blocks, kThreads, 0, stream>>>(
      table, idx, w, out, (unsigned)n_bags, (unsigned)n_fields, bag_len,
      vocab, d, lpb_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* table, const int* idx, const void* w,
                   void* out, long long n_bags, int n_fields, int bag_len,
                   long long vocab, int d, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte vector
  const T* tab = static_cast<const T*>(table);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<unsigned long long>(table) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(out) % 16 == 0;
  const int n_vec = vec ? d / kVec : d;
  int lpb_log2 = 0;                      // the smallest group of >= n_vec
  while (lpb_log2 < 5 && (1 << lpb_log2) < n_vec) ++lpb_log2;
  const bool two = n_vec > (1 << lpb_log2);
  if (vec)
    return two ? launch_groups<T, kVec, 2>(tab, idx, wt, o, n_bags, n_fields,
                                           bag_len, vocab, d, lpb_log2, stream)
               : launch_groups<T, kVec, 1>(tab, idx, wt, o, n_bags, n_fields,
                                           bag_len, vocab, d, lpb_log2,
                                           stream);
  return two ? launch_groups<T, 1, 2>(tab, idx, wt, o, n_bags, n_fields,
                                      bag_len, vocab, d, lpb_log2, stream)
             : launch_groups<T, 1, 1>(tab, idx, wt, o, n_bags, n_fields,
                                      bag_len, vocab, d, lpb_log2, stream);
}

template <typename T>
cudaError_t launch_prev(const void* table, const int* idx, const void* w,
                        void* out, long long n_bags, int n_fields,
                        int bag_len, long long vocab, int d,
                        cudaStream_t stream) {
  const long long n_out = n_bags * d;
  const long long blocks = (n_out + kPrevThreads - 1) / kPrevThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  embedding_bag_prev_kernel<T><<<(unsigned)blocks, kPrevThreads, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<const T*>(w),
      static_cast<T*>(out), n_out, n_fields, bag_len, vocab, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (table, weights and output). n_bags =
// B * F. Returns the CUDA error of the launch.
int embedding_bag_launch(const void* table, const void* idx, const void* w,
                         void* out, int dtype, long long n_bags, int n_fields,
                         int bag_len, long long vocab, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const cudaError_t err =
      dtype == 0 ? launch<float>(table, ix, w, out, n_bags, n_fields,
                                 bag_len, vocab, d, s)
                 : launch<__nv_bfloat16>(table, ix, w, out, n_bags,
                                         n_fields, bag_len, vocab, d, s);
  return (int)err;
}

// The earlier kernel on the same arguments (a yardstick, uncounted).
int embedding_bag_prev_launch(const void* table, const void* idx,
                              const void* w, void* out, int dtype,
                              long long n_bags, int n_fields, int bag_len,
                              long long vocab, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const cudaError_t err =
      dtype == 0 ? launch_prev<float>(table, ix, w, out, n_bags, n_fields,
                                      bag_len, vocab, d, s)
                 : launch_prev<__nv_bfloat16>(table, ix, w, out, n_bags,
                                              n_fields, bag_len, vocab, d, s);
  return (int)err;
}

}  // extern "C"
