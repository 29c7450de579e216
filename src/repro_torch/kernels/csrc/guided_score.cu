// Guided chunk scoring for Hopper (sm_90a): the 2GTI scatter / essential-
// presence / descending-freeze / combine passes of each (query, tile) of a
// chunk of C tiles per query, with a per-tile skip flag.
//
// Replaces the TPU kernel repro/kernels/guided_score.py::guided_score_chunk
// (_chunk_kernel). The one-tile form (guided_score_tile) is
// guided_score_tile.cu; this template's kHasSkip = false form is not
// instantiated.
//
// Grid: (lane blocks of block_s slots, C tiles, B queries); one block of
// kThreads threads per cell. A block
//   1. returns five zero rows at once when its tile is skipped;
//   2. zeroes Nq x block_s dense rows for both weights in shared memory;
//   3. strides over each term's padded run and stores the postings that fall
//      in its lane block. Within a (term, tile) run the offsets strictly
//      increase, so each (term, slot) receives at most one posting and plain
//      stores are exact (no atomics). The run is a prefix followed by -1
//      padding, so a thread stops at its first padding entry;
//   4. gives each slot to one thread, which runs the descending freeze loop
//      and writes the five output rows (coalesced).
// Memory-bound: the postings are read once per lane block (L2 serves the
// repeats), the dense rows never leave shared memory, and every output
// element is written once.
//
// Rounding: every product and sum is an explicit round-to-nearest intrinsic
// (and the library is built with -fmad=false), so no multiply-add is
// contracted. The freeze test's operand, and with it both masks, equals the
// plain PyTorch version's bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 5;

__device__ __forceinline__ float combine(float coef, float one_minus,
                                         float b, float l) {
  return __fadd_rn(__fmul_rn(coef, b), __fmul_rn(one_minus, l));
}

template <bool kHasSkip>
__global__ void __launch_bounds__(kThreads)
guided_score_kernel(const int* __restrict__ offs,
                    const float* __restrict__ wb,
                    const float* __restrict__ wl,
                    const float* __restrict__ essential,
                    const float* __restrict__ prefix_beta,
                    const int* __restrict__ skip,
                    const float* __restrict__ th_lo,
                    float alpha, float beta, float gamma,
                    float* __restrict__ out,
                    int n_chunk, int nq, int p, int tile_size, int block_s) {
  const int b = blockIdx.z;
  const long long tile = (long long)b * n_chunk + blockIdx.y;
  const int base = blockIdx.x * block_s;
  const int width = min(block_s, tile_size - base);
  float* out_t = out + tile * kRows * tile_size + base;

  if (kHasSkip && skip[tile] != 0) {
    for (int s = threadIdx.x; s < width; s += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) out_t[r * tile_size + s] = 0.f;
    }
    return;
  }

  extern __shared__ float smem[];
  float* dense_b = smem;                          // [nq][block_s]
  float* dense_l = dense_b + nq * block_s;        // [nq][block_s]
  int* surv = reinterpret_cast<int*>(dense_l + nq * block_s);  // [block_s]
  for (int j = threadIdx.x; j < nq * block_s; j += blockDim.x) {
    dense_b[j] = 0.f;
    dense_l[j] = 0.f;
  }
  for (int s = threadIdx.x; s < block_s; s += blockDim.x) surv[s] = 0;
  __syncthreads();

  const long long row0 = tile * nq;
  const float* ess_t = essential + row0;
  const float* pb_t = prefix_beta + row0;
  for (int i = 0; i < nq; ++i) {
    const long long r = (row0 + i) * p;
    const bool ess_i = ess_t[i] > 0.f;
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
      const int o = offs[r + j];
      if (o < 0) break;                  // padding: the rest of the run is too
      const int s = o - base;
      if (s >= 0 && s < width) {
        dense_b[i * block_s + s] = wb[r + j];
        dense_l[i * block_s + s] = wl[r + j];
        if (ess_i) surv[s] = 1;          // benign race: every writer stores 1
      }
    }
  }
  __syncthreads();

  const float th = th_lo[b];
  const float one_m_alpha = __fsub_rn(1.f, alpha);
  const float one_m_beta = __fsub_rn(1.f, beta);
  const float one_m_gamma = __fsub_rn(1.f, gamma);
  for (int s = threadIdx.x; s < width; s += blockDim.x) {
    const bool survive = surv[s] != 0;
    float sb = 0.f, sl = 0.f;
    bool alive = true;
    for (int i = nq - 1; i >= 0; --i) {
      const float l_part = combine(beta, one_m_beta, sb, sl);
      const bool ok = ess_t[i] > 0.f || __fadd_rn(l_part, pb_t[i]) > th;
      alive = alive && ok;
      if (survive && alive) {
        sb = __fadd_rn(sb, dense_b[i * block_s + s]);
        sl = __fadd_rn(sl, dense_l[i * block_s + s]);
      }
    }
    out_t[0 * tile_size + s] = combine(alpha, one_m_alpha, sb, sl);
    out_t[1 * tile_size + s] = combine(beta, one_m_beta, sb, sl);
    out_t[2 * tile_size + s] = combine(gamma, one_m_gamma, sb, sl);
    out_t[3 * tile_size + s] = (survive && alive) ? 1.f : 0.f;
    out_t[4 * tile_size + s] = survive ? 1.f : 0.f;
  }
}

size_t smem_bytes(int nq, int block_s) {
  return (2 * (size_t)nq * block_s) * sizeof(float) + block_s * sizeof(int);
}

template <bool kHasSkip>
int launch(const int* offs, const float* wb, const float* wl,
           const float* essential, const float* prefix_beta, const int* skip,
           const float* th_lo, float alpha, float beta, float gamma,
           float* out, int B, int C, int nq, int p, int tile_size,
           int block_s, void* stream) {
  if (B < 1 || C < 1 || nq < 1 || p < 1 || tile_size < 1 || block_s < 1 ||
      B > 65535 || C > 65535)
    return cudaErrorInvalidValue;
  // The opt-in shared-memory limit and the kernel's attribute are set up
  // once per process (one device) and raised only when a launch needs more.
  static int max_smem = 0;
  static size_t attr_smem[2] = {0, 0};
  cudaError_t err;
  if (max_smem == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  block_s = block_s < tile_size ? block_s : tile_size;
  while (block_s > 32 && smem_bytes(nq, block_s) > (size_t)max_smem)
    block_s = (block_s + 1) / 2;
  const size_t smem = smem_bytes(nq, block_s);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  if (smem > attr_smem[kHasSkip]) {
    err = cudaFuncSetAttribute(guided_score_kernel<kHasSkip>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attr_smem[kHasSkip] = smem;
  }
  const dim3 grid((tile_size + block_s - 1) / block_s, C, B);
  guided_score_kernel<kHasSkip><<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      offs, wb, wl, essential, prefix_beta, skip, th_lo, alpha, beta, gamma,
      out, C, nq, p, tile_size, block_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// [B, C, Nq, P] -> [B, C, 5, S]; skip [B, C] nonzero = zero rows.
int guided_score_chunk_launch(const int* offs, const float* wb,
                              const float* wl, const float* essential,
                              const float* prefix_beta, const int* skip,
                              const float* th_lo, float alpha, float beta,
                              float gamma, float* out, int B, int C, int nq,
                              int p, int tile_size, int block_s,
                              void* stream) {
  if (skip == nullptr) return cudaErrorInvalidValue;
  return launch<true>(offs, wb, wl, essential, prefix_beta, skip, th_lo,
                      alpha, beta, gamma, out, B, C, nq, p, tile_size,
                      block_s, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
