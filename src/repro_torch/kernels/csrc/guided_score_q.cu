// Decode-in-kernel guided chunk scoring for Hopper (sm_90a) on the
// compressed (q8) index: the delta/bit-pack and int8 decode of a tile's
// posting runs, then the 2GTI scatter / essential-presence / descending-
// freeze / combine passes of guided_score.cu, plus a 6th output row, the
// valid postings per doc slot (the executor's presence and postings stats),
// for each tile of a chunk of C tiles per query, with a per-tile skip flag.
//
// Replaces the TPU kernel repro/kernels/guided_score.py::guided_score_chunk_q
// (_chunk_kernel_q + _decode_rows). The one-tile form (guided_score_tile_q)
// is guided_score_tile.cu; this template's kHasSkip = false form is not
// instantiated.
//
// Inputs are the raw rows of repro_torch.index.compressed.gather_tile_q_raw,
// batched: per (query b, tile c, term i) `words` [Wp] int32 packed gaps,
// `qb`/`ql` [P] uint8 codes, `meta_i` rows (cnt, first, width), `meta_f`
// rows (zero_b, scale_b, zero_l, scale_l); per (b, i) the query weights.
//
// Grid: (lane blocks of block_s slots, C tiles, B queries); kThreads threads
// per block. The TPU kernels decode a tile once, at lane block 0, into VMEM
// that later grid cells reuse; CUDA blocks run concurrently, so here every
// block decodes its tile's runs itself and keeps only the postings that
// fall in its lane block (the decoded rows of a tile, Nq x P x 12 B, would
// not fit in shared memory anyway). A block
//   1. returns six zero rows at once when its tile is skipped (no decode);
//   2. zeroes Nq x block_s dense rows for both weights, and the per-slot
//      survive flag and posting count, in shared memory;
//   3. walks the terms one at a time. For term i it loads kThreads postings
//      per step: thread t takes posting j = j0 + t (valid while j < cnt),
//      whose contribution is `first` (j = 0) or gap + 1, the gap read with
//      one word load, an unsigned shift and a mask at bitpos (j - 1) * w
//      (widths divide 32, so no gap spans two words). A block-wide
//      inclusive scan (__shfl_up_sync within warps, then the warp totals
//      through shared memory) plus the running total of earlier steps gives
//      each posting's tile-local offset. A posting in this lane block stores
//      its dequantized weights (zero + scale * q) * qw, counts itself in its
//      slot, and marks the slot surviving when term i is essential.
//      Offsets strictly increase within a run, so each (term, slot) gets at
//      most one posting, and the barriers of each step order the terms: the
//      plain shared-memory stores and increments are exact, without atomics.
//      Once the running total (the last decoded offset) reaches the end of
//      the lane block, the rest of the run lies beyond it and the block
//      moves to the next term;
//   4. gives each slot to one thread, which runs the descending freeze loop
//      and writes the six output rows (coalesced).
// Validity comes from j < cnt alone, never from a nonzero weight: a posting
// of a padded query term (qw = 0), or one whose dequantized impact is 0,
// still counts and still makes its slot present.
//
// Bound: memory. Per live (query, tile) the work needs the words of each
// run, 2 B of codes per valid posting, the run metadata and planner rows,
// and writes 24 * S B of output. A lane block re-decodes its tile's runs up
// to its own end (lane block k of n decodes about (k + 1) / n of each run;
// at S = 2048 and block_s = 512 the four blocks decode 2.5 runs' worth);
// the repeats hit L2. (guided_score_tile.cu skips whole words instead.)
//
// Rounding: every product and sum is an explicit round-to-nearest intrinsic
// and the library is built with -fmad=false. The dequantization
// __fmul_rn(__fadd_rn(zero, __fmul_rn(scale, q)), qw) equals the
// reference's (zero + scale * q) * vmask * qw bit for bit (scale * q is
// exact: an fp16 significand times an 8-bit code), and keeps the codec's
// fl(zero + scale * q) <= tile max bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 6;

__device__ __forceinline__ float combine(float coef, float one_minus,
                                         float b, float l) {
  return __fadd_rn(__fmul_rn(coef, b), __fmul_rn(one_minus, l));
}

__device__ __forceinline__ float dequant(float zero, float scale,
                                         uint8_t code, float qw) {
  return __fmul_rn(__fadd_rn(zero, __fmul_rn(scale, (float)code)), qw);
}

template <bool kHasSkip>
__global__ void __launch_bounds__(kThreads)
guided_score_q_kernel(const int* __restrict__ words,
                      const uint8_t* __restrict__ qb,
                      const uint8_t* __restrict__ ql,
                      const int* __restrict__ meta_i,
                      const float* __restrict__ meta_f,
                      const float* __restrict__ qw_b,
                      const float* __restrict__ qw_l,
                      const float* __restrict__ essential,
                      const float* __restrict__ prefix_beta,
                      const int* __restrict__ skip,
                      const float* __restrict__ th_lo,
                      float alpha, float beta, float gamma,
                      float* __restrict__ out,
                      int n_chunk, int nq, int wp, int p, int tile_size,
                      int block_s) {
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
  int* slot_cnt = surv + block_s;                 // [block_s]
  __shared__ int warp_tot[kWarps];
  for (int j = threadIdx.x; j < nq * block_s; j += blockDim.x) {
    dense_b[j] = 0.f;
    dense_l[j] = 0.f;
  }
  for (int s = threadIdx.x; s < block_s; s += blockDim.x) {
    surv[s] = 0;
    slot_cnt[s] = 0;
  }
  __syncthreads();

  const long long row0 = tile * nq;               // (tile, term 0) row
  const int* mi = meta_i + tile * 3 * nq;         // [3][nq]
  const float* mf = meta_f + tile * 4 * nq;       // [4][nq]
  const float* ess_t = essential + row0;
  const float* pb_t = prefix_beta + row0;
  const float* qwb_q = qw_b + (long long)b * nq;
  const float* qwl_q = qw_l + (long long)b * nq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane_end = base + width;

  for (int i = 0; i < nq; ++i) {
    const int cnt = min(mi[i], p);
    const int first = mi[nq + i];
    const int w = mi[2 * nq + i];
    const unsigned mask = (1u << w) - 1u;
    const float zero_b = mf[i], scale_b = mf[nq + i];
    const float zero_l = mf[2 * nq + i], scale_l = mf[3 * nq + i];
    const float qwb = qwb_q[i], qwl = qwl_q[i];
    const bool ess_i = ess_t[i] > 0.f;
    const int* words_r = words + (row0 + i) * wp;
    const uint8_t* qb_r = qb + (row0 + i) * p;
    const uint8_t* ql_r = ql + (row0 + i) * p;
    int carry = 0;                 // offset of the last decoded posting
    for (int j0 = 0; j0 < cnt; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      int x = 0;
      if (j < cnt) {
        if (j == 0) {
          x = first;
        } else {
          const int bitpos = (j - 1) * w;
          const unsigned word =
              static_cast<unsigned>(words_r[min(bitpos >> 5, wp - 1)]);
          x = static_cast<int>((word >> (bitpos & 31)) & mask) + 1;
        }
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {        // inclusive warp scan
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) warp_tot[warp] = x;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int t = warp_tot[k];
        if (k < warp) before += t;
        total += t;
      }
      const int s = carry + before + x - base;
      if (j < cnt && s >= 0 && s < width) {
        dense_b[i * block_s + s] = dequant(zero_b, scale_b, qb_r[j], qwb);
        dense_l[i * block_s + s] = dequant(zero_l, scale_l, ql_r[j], qwl);
        slot_cnt[s] += 1;
        if (ess_i) surv[s] = 1;
      }
      carry += total;
      __syncthreads();             // warp_tot is rewritten by the next step
      if (carry >= lane_end) break;   // uniform: the rest lies past the block
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
    out_t[5 * tile_size + s] = static_cast<float>(slot_cnt[s]);
  }
}

size_t smem_bytes(int nq, int block_s) {
  return (2 * (size_t)nq * block_s) * sizeof(float) +
         2 * (size_t)block_s * sizeof(int);
}

template <bool kHasSkip>
int launch(const int* words, const uint8_t* qb, const uint8_t* ql,
           const int* meta_i, const float* meta_f, const float* qw_b,
           const float* qw_l, const float* essential,
           const float* prefix_beta, const int* skip, const float* th_lo,
           float alpha, float beta, float gamma, float* out, int B, int C,
           int nq, int wp, int p, int tile_size, int block_s, void* stream) {
  if (B < 1 || C < 1 || nq < 1 || wp < 1 || p < 1 || tile_size < 1 ||
      block_s < 1 || B > 65535 || C > 65535)
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
    err = cudaFuncSetAttribute(guided_score_q_kernel<kHasSkip>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attr_smem[kHasSkip] = smem;
  }
  const dim3 grid((tile_size + block_s - 1) / block_s, C, B);
  guided_score_q_kernel<kHasSkip><<<grid, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      words, qb, ql, meta_i, meta_f, qw_b, qw_l, essential, prefix_beta,
      skip, th_lo, alpha, beta, gamma, out, C, nq, wp, p, tile_size,
      block_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// [B, C, Nq, ...] raw rows -> [B, C, 6, S]; skip [B, C] nonzero = zero rows.
int guided_score_chunk_q_launch(const int* words, const uint8_t* qb,
                                const uint8_t* ql, const int* meta_i,
                                const float* meta_f, const float* qw_b,
                                const float* qw_l, const float* essential,
                                const float* prefix_beta, const int* skip,
                                const float* th_lo, float alpha, float beta,
                                float gamma, float* out, int B, int C,
                                int nq, int wp, int p, int tile_size,
                                int block_s, void* stream) {
  if (skip == nullptr) return cudaErrorInvalidValue;
  return launch<true>(words, qb, ql, meta_i, meta_f, qw_b, qw_l, essential,
                      prefix_beta, skip, th_lo, alpha, beta, gamma, out, B,
                      C, nq, wp, p, tile_size, block_s, stream);
}

}  // extern "C"
