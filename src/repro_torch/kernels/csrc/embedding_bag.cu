// Embedding bag for Hopper (sm_90a): out[b, f] = sum_j w[b, f, j] *
// table[f, idx[b, f, j]], summed in j order.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py::embedding_bag
// (body _kernel), which keeps a table shard in VMEM and adds each bag's
// weighted rows into its output row in a fori_loop over (bag, j). Here the
// table stays in device memory and each thread owns one output element
// (bag, column): it reads the bag's indices and weights (the same for every
// thread of the bag, served by L1) and adds w * row[column] for j = 0..L-1
// in order, into an accumulator of the table's dtype, as the Pallas loop
// adds into its output block. Neighbouring threads own neighbouring columns
// of one row, so each gathered row is read with coalesced loads.
//
// Stacked fields: a [F, V, D] table with [B, F, L] indices serves all F
// fields of a model in one launch (bag b * F + f reads table f); a [V, D]
// table is F = 1.
//
// Rounding: each product and each sum is rounded to the table's dtype
// (float32: explicit round-to-nearest intrinsics, and the library is built
// with -fmad=false; bfloat16: computed in float and rounded to bfloat16, as
// PyTorch's bfloat16 multiply and add do), so the result is bit-equal to the
// plain version that adds in the same order.
//
// Out-of-range index: the TPU kernel assumes every index is in [0, V). Here
// a slot whose index is outside [0, V) adds nothing to its bag (the kernel
// reads no memory outside its table row), as the plain version does.
//
// Bound on an H100 SXM: bytes. The gathered rows (L * D elements per bag),
// the indices and weights are read once and the output written once; at
// dlrm-rm2's serve_p99 (512 x 26 bags of one 64-wide f32 row) that is
// ~6.8 MB, ~2 us. The kernel moves exactly those bytes (a repeated row
// again, from L2).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float madd(float acc, float row, float w) {
  return __fadd_rn(acc, __fmul_rn(row, w));
}

__device__ __forceinline__ __nv_bfloat16 madd(__nv_bfloat16 acc,
                                              __nv_bfloat16 row,
                                              __nv_bfloat16 w) {
  const __nv_bfloat16 prod = __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(row), __bfloat162float(w)));
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(acc), __bfloat162float(prod)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const T* __restrict__ w, T* __restrict__ out,
                     long long n_out, int n_fields, int bag_len,
                     long long vocab, int d) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
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
      acc = madd(acc, __ldg(tab + (long long)i * d), __ldg(wb + j));
  }
  out[t] = acc;
}

template <typename T>
cudaError_t launch(const void* table, const int* idx, const void* w,
                   void* out, long long n_bags, int n_fields, int bag_len,
                   long long vocab, int d, cudaStream_t stream) {
  const long long n_out = n_bags * d;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
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

}  // extern "C"
