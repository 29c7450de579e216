// Guided scoring for Hopper (sm_90a) on both indexes, one tile per query
// or a chunk of C tiles per query with a per-tile skip flag: the fp32 form
// and the q8 form, which decodes the bit-packed gaps and int8 impacts in
// the kernel. Both write six output rows per doc slot, the last the valid
// postings there, which the executor sums into its present-slot and
// posting counters.
//
// Replaces the TPU kernels repro/kernels/guided_score.py::guided_score_tile
// (_kernel), ::guided_score_chunk (_chunk_kernel), ::guided_score_tile_q
// (_kernel_q + _decode_rows) and ::guided_score_chunk_q (_chunk_kernel_q +
// _decode_rows). One kernel per index serves both forms: a tile is a chunk
// of one tile with no skip flag.
//
// Bound: latency, not bytes. At the main path's shapes (16 queries x 16
// runs of about 7 postings over S = 2048 slots, per tile) a tile's work
// needs about 50 KB, most of it the output rows; a chunk of 8 tiles per
// query (128 tiles) needs 6.5-7.7 MB, 1.9-2.3 us at the card's memory rate,
// less than a launch and one dependent round trip cost together. The time
// goes to dependent memory round trips and block barriers on each block's
// critical path, and to waves of blocks. So a block's path is about two
// round trips and two barriers long (three round trips in the chunk form,
// which reads its skip flag first), and a grid runs in one wave (the main
// path's tiles) or about two (its chunk):
//   * Grid (lane blocks of block_s slots, C tiles, B queries), kThreads
//     threads per block; tile = b * C + c. block_s comes from
//     guided_score.tile_lane_width for one tile per query (128 up to
//     Nq = 64: 256 blocks of about 18 KB of shared memory at [16, 16,
//     2048]) and from guided_score.chunk_lane_width for a chunk, which
//     widens the lane block while the grid keeps at least two blocks per
//     SM (512 at [16, 8, 16] x 2048: 512 blocks of about 67 KB, two
//     resident per SM by registers, so two waves; 128 would give 2048
//     blocks, eight waves). A run of ~7 postings fits one step whatever
//     the width, and fewer lane blocks read each run.
//   * Chunk form: the block reads its tile's skip flag before any other
//     load; a skipped tile's block writes its zero rows and returns.
//   * Prologue: one coalesced pass puts every run's scalars in shared
//     memory (essential as flags and as a bitmask, prefix_beta; q8 also
//     cnt, first, width, the zero/scale pairs and the query weights) and
//     zeroes the presence masks, then one barrier. Each warp issues its
//     first run's first loads, and every thread the query's th_lo, before
//     that barrier, so they overlap it.
//   * A warp per run: warp w takes terms w, w + kWarps, ... and walks a run
//     32 postings per step, one per lane. A step's loads issue together:
//     offsets and weights, or (q8) 32 packed words from the first its gaps
//     need, shared by shuffles, and the codes. A run's first two steps are
//     loaded at once (q8: words 0..31 hold every gap of postings 1..63), so
//     a run of up to 64 postings costs one round trip. A posting that lands
//     in the lane block stores its two weights in the term's dense row and
//     sets bit i of its slot's presence mask (a shared atomicOr: runs of
//     different terms may share a slot). The walk stops, warp-uniformly, at
//     the run's end or once an offset passes the lane block's end. No block
//     barrier inside the term loop: runs of different terms write different
//     dense rows, and a (term, slot) pair receives at most one posting
//     (offsets strictly increase within a run).
//   * A lane block far into a long run reaches its first posting without
//     walking the run from posting 0. An fp32 run (offsets, then -1
//     padding) still before the lane block after two steps is searched with
//     32 probes per round. A q8 run of more than 96 postings whose lane
//     block starts more than 64 past `first` skips whole packed words: a
//     round sums the gaps of 32 words (each word's fields by popcount) and
//     keeps the words whose last posting lies before the lane block. So a
//     lane block reads each run's words up to its own end (block k of n
//     about (k + 1) / n of them, 32 words a round) but decodes postings one
//     by one only from the word that reaches it: about 32 + its own share.
//   * No dense zeroing: a slot's presence mask (ceil(Nq / 32) words) says
//     which dense entries hold a posting. Survive = mask & essential != 0;
//     the 6th row = popcount(mask), exact because a (term, slot) pair
//     holds at most one posting. A posting with a zero weight (a padded
//     query term, a code that dequantizes to 0) still sets its bit.
//   * A second barrier, then one thread per slot runs the descending freeze
//     loop, reading the run scalars from shared memory and adding a term's
//     weights only where its bit is set, and writes the output rows once,
//     coalesced.
// Indexing: essential, prefix_beta, offs / wb / wl, words / qb / ql,
// meta_i and meta_f are per tile (row0 = tile * Nq); qw_b / qw_l and th_lo
// are per query; the output is [B, C, kRows, S].
//
// Rounding: every product and sum is an explicit round-to-nearest
// intrinsic and the library is built with -fmad=false. Skipping the add
// where a bit is clear equals adding the +0.0 that a zeroed dense row
// held: the sums start at +0.0 and a round-to-nearest sum is -0.0 only
// when both operands are, so they never become -0.0. The dequantization
// __fmul_rn(__fadd_rn(zero, __fmul_rn(scale, q)), qw) is the reference's.
// Outputs equal the plain versions (guided_score_tile_plain,
// guided_score_chunk_plain and their q8 twins) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Global, Local, Rank, eval mask, rank mask, postings per slot
constexpr int kRows = 6;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float combine(float coef, float one_minus,
                                         float b, float l) {
  return __fadd_rn(__fmul_rn(coef, b), __fmul_rn(one_minus, l));
}

__device__ __forceinline__ float dequant(float zero, float scale,
                                         uint8_t code, float qw) {
  return __fmul_rn(__fadd_rn(zero, __fmul_rn(scale, (float)code)), qw);
}

__device__ __forceinline__ int warp_scan(int x, int lane) {  // inclusive
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Shared memory of one lane block, in 4-byte words (guided_score.py's
// tile_smem_bytes counts the same):
//   dense_b, dense_l  [nq][block_s]  weights of the postings that landed
//   mask              [nw][block_s]  presence bits, term i in word i / 32
//   emask             [nw]           the essential terms' bits
//   ess, pb           [nq]           essential flags, prefix_beta
//   q8 only: meta     [3][nq] ints (cnt, first, width), then [6][nq]
//                     floats (zero_b, scale_b, zero_l, scale_l, qw_b, qw_l)
size_t smem_bytes(int nq, int block_s, bool q8) {
  const size_t nw = (nq + 31) / 32;
  return 4 * (2 * (size_t)nq * block_s + nw * block_s + nw +
              (q8 ? 11 : 2) * (size_t)nq);
}

struct Lane {
  float* dense_b;
  float* dense_l;
  unsigned* mask;
  unsigned* emask;
  int* ess;
  float* pb;
  int base, width, block_s;

  __device__ Lane(unsigned* smem, int nq, int bs, int tile_size)
      : base(blockIdx.x * bs), block_s(bs) {
    width = min(bs, tile_size - base);
    dense_b = reinterpret_cast<float*>(smem);
    dense_l = dense_b + nq * bs;
    mask = reinterpret_cast<unsigned*>(dense_l + nq * bs);
    emask = mask + ((nq + 31) >> 5) * bs;
    ess = reinterpret_cast<int*>(emask + ((nq + 31) >> 5));
    pb = reinterpret_cast<float*>(ess + nq);
  }
  __device__ void* end(int nq) const { return pb + nq; }

  // Posting of term i at slot s: its weights and its presence bit.
  __device__ void set(int i, int s, float b, float l) const {
    dense_b[i * block_s + s] = b;
    dense_l[i * block_s + s] = l;
    atomicOr(mask + (i >> 5) * block_s + s, 1u << (i & 31));
  }
};

// Zero the presence masks; essential flags, their bitmask and prefix_beta
// into shared memory, by warps 0 .. ceil(nq / 32) - 1, each thread's two
// loads issued before the ballot waits on one. The caller takes the
// barrier.
__device__ void prologue(const Lane& L, const float* ess_t,
                         const float* pb_t, int nq) {
  const int nw = (nq + 31) >> 5;
  for (int k = threadIdx.x; k < nw * L.block_s; k += kThreads) L.mask[k] = 0u;
  const int lane = threadIdx.x & 31;
  for (int i0 = (threadIdx.x >> 5) * 32; i0 < nq; i0 += kThreads) {
    const int i = i0 + lane;
    const float ev = i < nq ? ess_t[i] : 0.f;
    const float pv = i < nq ? pb_t[i] : 0.f;
    const bool e = ev > 0.f;
    const unsigned bits = __ballot_sync(kAll, e);
    if (i < nq) {
      L.ess[i] = e;
      L.pb[i] = pv;
    }
    if (lane == 0) L.emask[i0 >> 5] = bits;
  }
}

// A skipped tile of a chunk: its zero rows for the lane block.
__device__ void write_zeros(const Lane& L, float* out_t, int tile_size) {
  for (int s = threadIdx.x; s < L.width; s += kThreads) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) out_t[r * tile_size + s] = 0.f;
  }
}

// One thread per slot: the descending freeze loop and the output rows.
__device__ void freeze_and_write(const Lane& L, int nq, float th,
                                 float alpha, float beta, float gamma,
                                 float* out_t, int tile_size) {
  const int nw = (nq + 31) >> 5;
  const float one_m_alpha = __fsub_rn(1.f, alpha);
  const float one_m_beta = __fsub_rn(1.f, beta);
  const float one_m_gamma = __fsub_rn(1.f, gamma);
  for (int s = threadIdx.x; s < L.width; s += kThreads) {
    unsigned ess_hit = 0u;
    int count = 0;
    for (int k = 0; k < nw; ++k) {
      const unsigned m = L.mask[k * L.block_s + s];
      ess_hit |= m & L.emask[k];
      count += __popc(m);
    }
    const bool survive = ess_hit != 0u;
    float sb = 0.f, sl = 0.f;
    bool alive = true;
    if (survive) {
      for (int i = nq - 1; i >= 0; --i) {
        const float l_part = combine(beta, one_m_beta, sb, sl);
        if (!(L.ess[i] || __fadd_rn(l_part, L.pb[i]) > th)) {
          alive = false;          // frozen: nothing more is added
          break;
        }
        if ((L.mask[(i >> 5) * L.block_s + s] >> (i & 31)) & 1u) {
          sb = __fadd_rn(sb, L.dense_b[i * L.block_s + s]);
          sl = __fadd_rn(sl, L.dense_l[i * L.block_s + s]);
        }
      }
    }
    out_t[0 * tile_size + s] = combine(alpha, one_m_alpha, sb, sl);
    out_t[1 * tile_size + s] = combine(beta, one_m_beta, sb, sl);
    out_t[2 * tile_size + s] = combine(gamma, one_m_gamma, sb, sl);
    out_t[3 * tile_size + s] = (survive && alive) ? 1.f : 0.f;
    out_t[4 * tile_size + s] = survive ? 1.f : 0.f;
    out_t[5 * tile_size + s] = static_cast<float>(count);
  }
}

// ---------------------------------------------------------------- fp32

struct StepF {
  int o;        // offset, -1 = padding or past P
  float b, l;
};

__device__ __forceinline__ StepF load_f(const int* offs_r, const float* wb_r,
                                        const float* wl_r, int j, int p) {
  StepF st{-1, 0.f, 0.f};
  if (j < p) {
    st.o = offs_r[j];
    st.b = wb_r[j];
    st.l = wl_r[j];
  }
  return st;
}

// A run's first two steps (postings lane and 32 + lane), loaded together:
// a run of up to 64 postings costs one round trip.
struct FirstF {
  StepF a, b;
};

__device__ __forceinline__ FirstF load_first_f(const int* offs_r,
                                               const float* wb_r,
                                               const float* wl_r, int p,
                                               int lane) {
  return {load_f(offs_r, wb_r, wl_r, lane, p),
          load_f(offs_r, wb_r, wl_r, 32 + lane, p)};
}

// Given offs_r[lo - 1] < base, narrows [lo, hi) with 32 probes a round
// while more than 32 entries remain; returns an index before which every
// offset is below base and from which the first one at or past base (or
// the padding) lies within 32 entries. Offsets increase, then padding, so
// the probes below base are a prefix of the lanes.
__device__ int seek_f(const int* offs_r, int lo, int hi, int base, int lane) {
  while (hi - lo > 32) {
    const int stride = (hi - lo + 31) >> 5;
    const int j = lo + lane * stride;
    const int o = j < hi ? offs_r[j] : -1;
    const int c = __popc(__ballot_sync(kAll, o >= 0 && o < base));
    if (c == 0) break;
    hi = min(lo + c * stride, hi);
    lo += (c - 1) * stride + 1;
  }
  return lo;
}

__device__ void run_f(const Lane& L, int i, const FirstF& first,
                      const int* offs_r, const float* wb_r,
                      const float* wl_r, int p, int lane) {
  const int lane_end = L.base + L.width;
  StepF st = first.a;
  int j0 = 0;
  for (;;) {
    const int s = st.o - L.base;
    if (st.o >= 0 && s >= 0 && s < L.width) L.set(i, s, st.b, st.l);
    if (__any_sync(kAll, st.o < 0 || st.o >= lane_end)) return;
    j0 += 32;
    if (j0 >= p) return;
    if (j0 == 32) {
      st = first.b;
      continue;
    }
    // two steps walked and still before the lane block: search the rest
    if (__shfl_sync(kAll, st.o, 31) < L.base)
      j0 = seek_f(offs_r, j0, p, L.base, lane);
    st = load_f(offs_r, wb_r, wl_r, j0 + lane, p);
  }
}

// skip == nullptr: one tile per query (n_chunk = 1), nothing skipped.
__global__ void __launch_bounds__(kThreads, 2)
guided_score_tile_kernel(const int* __restrict__ offs,
                         const float* __restrict__ wb,
                         const float* __restrict__ wl,
                         const float* __restrict__ essential,
                         const float* __restrict__ prefix_beta,
                         const int* __restrict__ skip,
                         const float* __restrict__ th_lo, float alpha,
                         float beta, float gamma, float* __restrict__ out,
                         int n_chunk, int nq, int p, int tile_size,
                         int block_s) {
  extern __shared__ unsigned smem[];
  const int b = blockIdx.z;
  const long long tile = (long long)b * n_chunk + blockIdx.y;
  const Lane L(smem, nq, block_s, tile_size);
  float* out_t = out + tile * kRows * tile_size + L.base;
  if (skip != nullptr && skip[tile] != 0) {
    write_zeros(L, out_t, tile_size);
    return;
  }
  // th_lo issues with the first loads and reaches shared memory at the
  // first barrier, not as a round trip after the second
  __shared__ float th;
  const float th_b = threadIdx.x == 0 ? th_lo[b] : 0.f;
  const long long row0 = tile * nq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  FirstF first{};
  if (warp < nq) {
    const long long r = (row0 + warp) * p;
    first = load_first_f(offs + r, wb + r, wl + r, p, lane);
  }
  prologue(L, essential + row0, prefix_beta + row0, nq);
  if (threadIdx.x == 0) th = th_b;
  __syncthreads();

  for (int i = warp; i < nq; i += kWarps) {
    const long long r = (row0 + i) * p;
    if (i != warp) first = load_first_f(offs + r, wb + r, wl + r, p, lane);
    run_f(L, i, first, offs + r, wb + r, wl + r, p, lane);
  }
  __syncthreads();
  freeze_and_write(L, nq, th, alpha, beta, gamma, out_t, tile_size);
}

// ------------------------------------------------------------------ q8

struct StepQ {
  unsigned word;  // lane k: words_r[min(fw + k, wp - 1)]
  uint8_t cb, cl; // the codes of posting j0 + lane
};

__device__ __forceinline__ StepQ load_q(const int* words_r,
                                        const uint8_t* qb_r,
                                        const uint8_t* ql_r, int fw, int j,
                                        int wp, int p, int lane) {
  StepQ st{static_cast<unsigned>(words_r[min(fw + lane, wp - 1)]), 0, 0};
  if (j < p) {
    st.cb = qb_r[j];
    st.cl = ql_r[j];
  }
  return st;
}

// A run's first two steps, loaded together: words 0..31, which hold every
// gap of postings 1..63 at widths up to 16 bits, and the codes of
// postings lane and 32 + lane.
struct FirstQ {
  StepQ a;
  uint8_t cb, cl;
};

__device__ __forceinline__ FirstQ load_first_q(const int* words_r,
                                               const uint8_t* qb_r,
                                               const uint8_t* ql_r, int wp,
                                               int p, int lane) {
  FirstQ f{load_q(words_r, qb_r, ql_r, 0, lane, wp, p, lane), 0, 0};
  if (32 + lane < p) {
    f.cb = qb_r[32 + lane];
    f.cl = ql_r[32 + lane];
  }
  return f;
}

// The sum of the 32 / w fields of w bits of a word (w in 1, 2, 4, 8, 16).
__device__ __forceinline__ int field_sum(unsigned x, int w) {
  const unsigned low = kAll / ((1u << w) - 1u);   // bit 0 of every field
  int sum = 0;
  for (int k = 0; k < w; ++k) sum += __popc(x & (low << k)) << k;
  return sum;
}

// Skips whole packed words of a q8 run whose postings all lie before
// `base`, 32 words a round. Word k holds the gaps of postings k * per + 1
// .. (k + 1) * per (per = 32 / w); only words whose every gap is the run's
// are skipped. Returns the words skipped and sets `carry` to the offset of
// their last posting (`first` when none).
__device__ int skip_words(const int* words_r, int wp, int cnt, int first,
                          int w, int base, int lane, int* carry) {
  const int per = 32 / w;
  const int n_full = (cnt - 1) / per;
  int k0 = 0, acc = first;
  while (k0 < n_full) {
    const int k = k0 + lane;
    const int sum = k < n_full ? field_sum(static_cast<unsigned>(
                                     words_r[min(k, wp - 1)]), w) + per
                               : 0;
    const int cum = warp_scan(sum, lane);
    const int m = __popc(__ballot_sync(kAll, k < n_full && acc + cum < base));
    if (m > 0) acc += __shfl_sync(kAll, cum, m - 1);
    k0 += m;
    if (m < 32) break;
  }
  *carry = acc;
  return k0;
}

// Run scalars of the q8 form, from shared memory.
struct RunQ {
  int cnt, first, w;
  float zero_b, scale_b, zero_l, scale_l, qw_b, qw_l;
};

__device__ void run_q(const Lane& L, int i, const RunQ& q,
                      const FirstQ& first, const int* words_r,
                      const uint8_t* qb_r, const uint8_t* ql_r, int wp,
                      int p, int lane) {
  if (q.cnt <= 0) return;
  const int lane_end = L.base + L.width;
  const unsigned fmask = (1u << q.w) - 1u;
  StepQ st = first.a;
  int j0 = 0, carry = 0;
  int fw = 0;                      // lane k's word is words_r[fw + k]
  // skip only where walking from posting 0 would take three steps more:
  // offsets grow by >= 1 a posting, so a lane block within 64 of `first`
  // starts within the first 64 postings
  if (q.cnt > 96 && L.base - q.first > 64) {
    int acc;
    const int k0 = skip_words(words_r, wp, q.cnt, q.first, q.w, L.base, lane,
                              &acc);
    if (k0 > 0) {
      j0 = k0 * (32 / q.w) + 1;    // the first posting past the skipped words
      carry = acc;
      fw = k0;
      st = load_q(words_r, qb_r, ql_r, fw, j0 + lane, wp, p, lane);
    }
  }
  bool second = j0 == 0;          // the next step's codes are first.cb/cl
  for (;;) {
    // posting j's gap (j >= 1) sits at bit (j - 1) * w of word
    // min(bitpos / 32, wp - 1), which lane bitpos / 32 - fw loaded
    const int j = j0 + lane;
    const int bitpos = (j > 0 ? j - 1 : 0) * q.w;
    const unsigned word = __shfl_sync(kAll, st.word,
                                      min((bitpos >> 5) - fw, 31));
    int x = 0;
    if (j < q.cnt)
      x = j == 0 ? q.first
                 : static_cast<int>((word >> (bitpos & 31)) & fmask) + 1;
    const int off = carry + warp_scan(x, lane);
    const int s = off - L.base;
    if (j < q.cnt && s >= 0 && s < L.width)
      L.set(i, s, dequant(q.zero_b, q.scale_b, st.cb, q.qw_b),
            dequant(q.zero_l, q.scale_l, st.cl, q.qw_l));
    carry = __shfl_sync(kAll, off, 31);   // the last valid posting's offset
    j0 += 32;
    if (j0 >= q.cnt || carry >= lane_end) return;
    if (second) {
      st.cb = first.cb;
      st.cl = first.cl;
      second = false;
    } else {
      fw = ((j0 - 1) * q.w) >> 5;
      st = load_q(words_r, qb_r, ql_r, fw, j0 + lane, wp, p, lane);
    }
  }
}

// skip == nullptr: one tile per query (n_chunk = 1), nothing skipped.
__global__ void __launch_bounds__(kThreads, 2)
guided_score_tile_q_kernel(const int* __restrict__ words,
                           const uint8_t* __restrict__ qb,
                           const uint8_t* __restrict__ ql,
                           const int* __restrict__ meta_i,
                           const float* __restrict__ meta_f,
                           const float* __restrict__ qw_b,
                           const float* __restrict__ qw_l,
                           const float* __restrict__ essential,
                           const float* __restrict__ prefix_beta,
                           const int* __restrict__ skip,
                           const float* __restrict__ th_lo, float alpha,
                           float beta, float gamma, float* __restrict__ out,
                           int n_chunk, int nq, int wp, int p, int tile_size,
                           int block_s) {
  extern __shared__ unsigned smem[];
  const int b = blockIdx.z;
  const long long tile = (long long)b * n_chunk + blockIdx.y;
  const Lane L(smem, nq, block_s, tile_size);
  float* out_t = out + tile * kRows * tile_size + L.base;
  if (skip != nullptr && skip[tile] != 0) {
    write_zeros(L, out_t, tile_size);
    return;
  }
  // th_lo issues with the first loads and reaches shared memory at the
  // first barrier, not as a round trip after the second
  __shared__ float th;
  const float th_b = threadIdx.x == 0 ? th_lo[b] : 0.f;
  int* mi_s = static_cast<int*>(L.end(nq));          // [3][nq]
  float* mf_s = reinterpret_cast<float*>(mi_s + 3 * nq);  // [6][nq]
  const long long row0 = tile * nq;
  const float* qwb_q = qw_b + (long long)b * nq;     // per query
  const float* qwl_q = qw_l + (long long)b * nq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  FirstQ first{};
  if (warp < nq)
    first = load_first_q(words + (row0 + warp) * wp, qb + (row0 + warp) * p,
                         ql + (row0 + warp) * p, wp, p, lane);
  prologue(L, essential + row0, prefix_beta + row0, nq);
  // cnt/first/width, the zero/scale pairs and the query weights, 9 words a
  // term ([3][nq] ints, then [6][nq] floats), by the threads past the
  // prologue's warps: one load and its store each (two from Nq = 54 up),
  // so the copy costs one round trip beside the prologue's
  const int* mi = meta_i + row0 * 3;
  const float* mf = meta_f + row0 * 4;
  unsigned* meta_s = reinterpret_cast<unsigned*>(mi_s);
  for (int k = (int)threadIdx.x - 32 * ((nq + 31) >> 5); k < 9 * nq;
       k += kThreads) {
    if (k < 0) continue;
    meta_s[k] = k < 3 * nq ? static_cast<unsigned>(mi[k])
              : k < 7 * nq ? __float_as_uint(mf[k - 3 * nq])
              : k < 8 * nq ? __float_as_uint(qwb_q[k - 7 * nq])
                           : __float_as_uint(qwl_q[k - 8 * nq]);
  }
  if (threadIdx.x == 0) th = th_b;
  __syncthreads();

  for (int i = warp; i < nq; i += kWarps) {
    const RunQ q{min(mi_s[i], p), mi_s[nq + i], mi_s[2 * nq + i],
                 mf_s[i], mf_s[nq + i], mf_s[2 * nq + i], mf_s[3 * nq + i],
                 mf_s[4 * nq + i], mf_s[5 * nq + i]};
    const long long r = row0 + i;
    if (i != warp)
      first = load_first_q(words + r * wp, qb + r * p, ql + r * p, wp, p,
                           lane);
    run_q(L, i, q, first, words + r * wp, qb + r * p, ql + r * p, wp, p,
          lane);
  }
  __syncthreads();
  freeze_and_write(L, nq, th, alpha, beta, gamma, out_t, tile_size);
}

// The opt-in shared-memory limit is read once per process (one device); a
// kernel's attribute is raised only when a launch needs more.
cudaError_t fit_smem(const void* kernel, size_t smem, size_t* attr) {
  static int max_smem = 0;
  cudaError_t err;
  if (max_smem == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  if (smem > *attr) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    *attr = smem;
  }
  return cudaSuccess;
}

bool bad_sizes(int B, int C, int nq, int p, int tile_size, int block_s) {
  return B < 1 || B > 65535 || C < 1 || C > 65535 || nq < 1 || p < 1 ||
         tile_size < 1 || block_s < 1;
}

// One launcher per kernel, shared by its tile and chunk forms, so that the
// kernel's shared-memory attribute is tracked once.
int launch_f(const int* offs, const float* wb, const float* wl,
             const float* essential, const float* prefix_beta,
             const int* skip, const float* th_lo, float alpha, float beta,
             float gamma, float* out, int B, int C, int nq, int p,
             int tile_size, int block_s, void* stream) {
  if (bad_sizes(B, C, nq, p, tile_size, block_s)) return cudaErrorInvalidValue;
  static size_t attr = 0;
  const size_t smem = smem_bytes(nq, block_s, false);
  const cudaError_t err =
      fit_smem((const void*)guided_score_tile_kernel, smem, &attr);
  if (err != cudaSuccess) return err;
  const dim3 grid((tile_size + block_s - 1) / block_s, C, B);
  guided_score_tile_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      offs, wb, wl, essential, prefix_beta, skip, th_lo, alpha, beta, gamma,
      out, C, nq, p, tile_size, block_s);
  return cudaGetLastError();
}

int launch_q(const int* words, const uint8_t* qb, const uint8_t* ql,
             const int* meta_i, const float* meta_f, const float* qw_b,
             const float* qw_l, const float* essential,
             const float* prefix_beta, const int* skip, const float* th_lo,
             float alpha, float beta, float gamma, float* out, int B, int C,
             int nq, int wp, int p, int tile_size, int block_s,
             void* stream) {
  if (bad_sizes(B, C, nq, p, tile_size, block_s) || wp < 1)
    return cudaErrorInvalidValue;
  static size_t attr = 0;
  const size_t smem = smem_bytes(nq, block_s, true);
  const cudaError_t err =
      fit_smem((const void*)guided_score_tile_q_kernel, smem, &attr);
  if (err != cudaSuccess) return err;
  const dim3 grid((tile_size + block_s - 1) / block_s, C, B);
  guided_score_tile_q_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      words, qb, ql, meta_i, meta_f, qw_b, qw_l, essential, prefix_beta,
      skip, th_lo, alpha, beta, gamma, out, C, nq, wp, p, tile_size,
      block_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// [B, Nq, P] -> [B, 6, S]; `skip` and `C` are ignored (C = 1, no skip);
// block_s = guided_score.tile_lane_width(Nq, S).
int guided_score_tile_launch(const int* offs, const float* wb,
                             const float* wl, const float* essential,
                             const float* prefix_beta, const int* skip,
                             const float* th_lo, float alpha, float beta,
                             float gamma, float* out, int B, int C, int nq,
                             int p, int tile_size, int block_s,
                             void* stream) {
  (void)skip;
  (void)C;
  return launch_f(offs, wb, wl, essential, prefix_beta, nullptr, th_lo,
                  alpha, beta, gamma, out, B, 1, nq, p, tile_size, block_s,
                  stream);
}

// [B, C, Nq, P] -> [B, C, 6, S]; skip [B, C] nonzero = zero rows;
// block_s = guided_score.chunk_lane_width(Nq, S, B * C).
int guided_score_chunk_launch(const int* offs, const float* wb,
                              const float* wl, const float* essential,
                              const float* prefix_beta, const int* skip,
                              const float* th_lo, float alpha, float beta,
                              float gamma, float* out, int B, int C, int nq,
                              int p, int tile_size, int block_s,
                              void* stream) {
  if (skip == nullptr) return cudaErrorInvalidValue;
  return launch_f(offs, wb, wl, essential, prefix_beta, skip, th_lo, alpha,
                  beta, gamma, out, B, C, nq, p, tile_size, block_s, stream);
}

// [B, Nq, ...] raw q8 rows -> [B, 6, S]; `skip` and `C` are ignored.
int guided_score_tile_q_launch(const int* words, const uint8_t* qb,
                               const uint8_t* ql, const int* meta_i,
                               const float* meta_f, const float* qw_b,
                               const float* qw_l, const float* essential,
                               const float* prefix_beta, const int* skip,
                               const float* th_lo, float alpha, float beta,
                               float gamma, float* out, int B, int C, int nq,
                               int wp, int p, int tile_size, int block_s,
                               void* stream) {
  (void)skip;
  (void)C;
  return launch_q(words, qb, ql, meta_i, meta_f, qw_b, qw_l, essential,
                  prefix_beta, nullptr, th_lo, alpha, beta, gamma, out, B, 1,
                  nq, wp, p, tile_size, block_s, stream);
}

// [B, C, Nq, ...] raw q8 rows, qw_b / qw_l [B, Nq] -> [B, C, 6, S]; skip
// [B, C] nonzero = zero rows.
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
  return launch_q(words, qb, ql, meta_i, meta_f, qw_b, qw_l, essential,
                  prefix_beta, skip, th_lo, alpha, beta, gamma, out, B, C,
                  nq, wp, p, tile_size, block_s, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
