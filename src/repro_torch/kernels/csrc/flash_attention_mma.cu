// Flash attention on the tensor cores for Hopper (sm_90a): the "mma" route
// of the port's flash_attention, for bfloat16 inputs whose kv head has more
// than 16 query rows (prefill, a cache-free forward, an encoder, a short
// prompt; a block's rows may be partly filled). Decode steps take
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
// Design: both products on wgmma (Hopper's warpgroup MMA, the only way to
// the tensor cores' full rate) out of swizzled shared memory, fed by a
// two-stage cp.async ring.
//   * Block: one warpgroup (4 warps) per 64 flattened query rows, wgmma's
//     M; warp w holds rows 16 w .. 16 w + 15 of its warpgroup's 64. Two
//     warpgroups (128 rows) share each K/V stage at DP = 64, one at DP =
//     32 and 128 (``warpgroups``). Key tiles of BK = 64; templated over
//     the padded head dim DP in {32, 64, 128}. Grid (B * Hkv, ceil(G * Sq
//     / rows per block)), blockIdx.y walked in reverse so the longest
//     causal blocks start first.
//   * S = Q K^T: DP / 16 wgmma.m64n64k16 (bf16 in, float32 accumulate), A
//     (Q) and B (the K stage) both from shared memory, K-major (d
//     contiguous). Q stays in shared memory: with Q as register fragments
//     held across the key loop, ptxas (CUDA 12.9) gave P's fragments the
//     same registers at DP = 64 (its PTX kept them apart), and on the card
//     register Q was no faster.
//   * O += P V: 4 wgmma.m64n{DP}k16 over the tile's 64 keys. A is P from
//     registers: wgmma's float32 accumulator gives each thread, in every
//     8-column group, the (row, column pair) positions of mma.sync's C
//     fragment, so the bf16 pairs of P are the A fragments (mma.sync's
//     m16n8k16 A layout, per warp) with no shuffle. B is the V stage,
//     MN-major (d contiguous): transpose bit 1.
//   * Shared memory in wgmma's canonical swizzled layout (``Tile``): the
//     head dim in atoms of 64 columns (128-byte rows, the 128-byte
//     swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)); at DP = 128
//     two atoms, 8 KB apart (V's leading byte offset); at DP = 32 one atom
//     of 32 columns (64-byte rows, the 64-byte swizzle: chunk c ^ (r / 2 %
//     4)). Each tile starts on a 1024-byte boundary; cp.async writes each
//     16-byte chunk at its swizzled address, zero-filled past the last key
//     and past d. The matrix descriptors (start address >> 4, leading and
//     stride byte offsets, swizzle mode in bits 62-63) are built once; a
//     stage or k-step adds its offset to the start address.
//   * Per tile: cp.async.wait_group 0 and fence.proxy.async (cp.async
//     writes through the generic proxy, wgmma reads through the async
//     proxy), one __syncthreads (the tile has landed everywhere, and every
//     warpgroup is done with the stage the next tile's copies then
//     refill), S (wgmma.fence, commit_group, wait_group 0), the softmax in
//     registers, P V (the same), so the next tile's copies overlap both
//     products and the softmax.
//   * Softmax: the row max and sum over the 4 lanes of a quad; a row with
//     no visible key so far uses 0 as its max (m_use); each score scaled
//     once to log2 units (any sign of the scale: the max is taken on the
//     scaled scores), exp2 as one ex2.approx.ftz; acc is rescaled only
//     where a row's max moved (else the factor is exactly 1). The
//     per-element mask runs only on tiles that reach past the keys every
//     row of the warp sees (a row's diagonal, or Skv); tiles past the
//     block's last visible key are never loaded.
//   * Shared memory: (4 + warpgroups) tiles of 64 DP bf16 (the ring, then
//     a Q tile per warpgroup) + 1 KB of alignment: 21 KB at DP = 32, 49 KB
//     at 64, 81 KB at 128. Registers (-Xptxas -v, CUDA 12.9): 127 at DP =
//     32, 128 at 64 (the cap of two 256-thread blocks an SM), 190 at 128; no
//     spills. Inline PTX only (no CUTLASS/CuTe), so nvcc takes seconds.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // a warpgroup
constexpr int kBQ = 64;             // query rows per warpgroup: wgmma's M
constexpr int kStages = 2;          // the K/V ring
constexpr int kBK = 64;             // keys per tile
constexpr int kAlign = 1024;        // period of the 128-byte swizzle
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

// A K, V or Q tile in shared memory: kBK rows (keys, or a warpgroup's
// kBQ query rows) of DP bf16 in wgmma's canonical swizzled layout. The head dim is cut into atoms of kAtom
// columns, each a [kBK][kAtom] block of kRowBytes rows; within an atom the
// byte offset's bits 7.. (its 128-byte line, mod 8 or 4) are XORed into
// its bits 4.. (the 16-byte chunk), as the 128- and 64-byte swizzles do.
template <int DP>
struct Tile {
  static_assert(DP == 32 || DP == 64 || DP == 128, "padded head dim");
  static_assert(kBQ == kBK, "Q tiles have the rows of K/V tiles");
  static constexpr int kAtom = DP < 64 ? DP : 64;          // columns
  static constexpr int kRowBytes = kAtom * 2;              // 64 or 128
  static constexpr int kChunks = kRowBytes / 16;           // per atom row
  static constexpr int kAtomBytes = kBK * kRowBytes;
  static constexpr int kBytes = kBK * DP * 2;
  static constexpr uint32_t kLines = kRowBytes == 128 ? 7 : 3;
  // swizzle mode of a matrix descriptor: 1 = 128-byte, 2 = 64-byte
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;   // 8 rows

  // byte offset of chunk c (columns 8 c .. 8 c + 7) of row r
  __device__ __forceinline__ static uint32_t offset(int r, int c) {
    const uint32_t lin = (c / kChunks) * kAtomBytes + r * kRowBytes +
                         (c % kChunks) * 16;
    return lin ^ (((lin >> 7) & kLines) << 4);
  }
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

// this thread's shared-memory writes (cp.async's included) made visible
// to the async proxy, which wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (each >> 4) and the swizzle mode (bits 62-63).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | mode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x with subnormal results flushed to zero: one MUFU.EX2
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_registers(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}

// d (64 x 64, float32) += a (64 x 16) b (16 x 64), both bf16 in shared
// memory through their descriptors, both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N, float32) += a (64 x 16, bf16 from registers: per warp the A
// fragment of mma.sync.m16n8k16) b (16 x N, bf16 in shared memory through
// ``desc``, MN-major: the transpose bit set), N = 2 x the length of d;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
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

// Warpgroups (of 64 query rows) per block: two at DP = 64, which share
// each K/V stage (half the copies and barriers per row), one at DP = 32
// (short sequences: fewer idle rows) and DP = 128 (its registers).
constexpr int warpgroups(int dp) { return dp == 64 ? 2 : 1; }

template <int DP, int WG>
__global__ void __launch_bounds__(WG * kThreads, DP == 128 ? 1 : 4 / WG)
flash_attention_mma_kernel(const Args a) {
  using T = Tile<DP>;
  constexpr int NTH = WG * kThreads;
  constexpr int BQ = WG * kBQ;    // query rows per block
  constexpr int KC = DP / 16;     // 16-wide k-steps of S = Q K^T
  constexpr int NT = kBK / 8;     // 8-key column groups of S
  constexpr int DT = DP / 8;      // 8-wide column groups of the output
  constexpr int CH = DP / 8;      // 16-byte chunks of a row

  // the ring (K stages, then V stages), then Q (a tile per warpgroup),
  // each tile on a 1024-byte boundary
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ks = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t vs = ks + kStages * T::kBytes;
  const uint32_t qs = ks + 2 * kStages * T::kBytes;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int rows = a.group * a.sq;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* q = a.q + b * a.q_b;
  const bf16* k = a.k + b * a.k_b + hk * a.k_h;
  const bf16* v = a.v + b * a.v_b + hk * a.v_h;

  // Keys this block needs: all of Skv, or (causal) up to its last row's
  // position. A block that spans two heads of the group holds row Sq - 1.
  const int last = min(r0 + BQ, rows) - 1;
  const int max_i = (r0 / a.sq == last / a.sq) ? last % a.sq : a.sq - 1;
  const int n_keys = a.causal ? min(a.skv, a.kv_offset + max_i + 1) : a.skv;
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  // This lane's rows: gr and gr + 8 of the warp's 16 (the accumulator's
  // layout, as mma.sync's C fragment).
  const int gr = lane >> 2, tq = lane & 3;
  const int wr0 = r0 + wg * kBQ + warp * 16;
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

  // Q's and stage 0's descriptors; stage 1 is T::kBytes further. Q and K:
  // K-major, rows of kRowBytes, 8-row groups kGroupBytes apart (the
  // leading offset is unused). V: MN-major, 8-key groups kGroupBytes
  // apart, atoms of the head dim kAtomBytes apart.
  const uint64_t qdesc = descriptor(qs + wg * T::kBytes, 16, T::kGroupBytes,
                                    T::kMode);
  const uint64_t kdesc = descriptor(ks, 16, T::kGroupBytes, T::kMode);
  const uint64_t vdesc = descriptor(vs, T::kAtomBytes, T::kGroupBytes,
                                    T::kMode);
  constexpr uint64_t kStage = T::kBytes >> 4;      // in 16-byte units

  // This thread's IT 16-byte chunks of a K or V tile: row, swizzled
  // offset, whether the chunk lies inside d, and its first key's address.
  constexpr int IT = kBK * CH / NTH;
  static_assert(kBK * CH % NTH == 0, "tile chunks split evenly");
  int lrow[IT];
  uint32_t loff[IT];
  bool lcol[IT];
  const bf16* kp[IT];
  const bf16* vp[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * NTH, r = e / CH, c = e % CH;
    lrow[it] = r;
    loff[it] = T::offset(r, c);
    lcol[it] = c * 8 < a.d;
    kp[it] = k + (long long)r * a.k_s + c * 8;
    vp[it] = v + (long long)r * a.v_s + c * 8;
  }
  // tile j's K and V into stage j % 2, as one cp.async group (empty past
  // the last tile); rows at or past n_keys and columns at or past d are
  // zero-filled
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      const int k0 = j * kBK;
      const uint32_t kst = ks + (j % kStages) * T::kBytes;
      const uint32_t vst = vs + (j % kStages) * T::kBytes;
      const long long ko = (long long)k0 * a.k_s, vo = (long long)k0 * a.v_s;
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const bool full = lcol[it] && k0 + lrow[it] < n_keys;
        cp_async16(kst + loff[it], full ? kp[it] + ko : k, full);
        cp_async16(vst + loff[it], full ? vp[it] + vo : v, full);
      }
    }
    cp_async_commit();
  };

  // Q (zero past the last row and past d) and tile 0 in the first group
  for (int e = tid; e < BQ * CH; e += NTH) {
    const int r = e / CH, c = e % CH, rf = r0 + r;
    const bool full = rf < rows && c * 8 < a.d;
    const bf16* from = q;
    if (full) {
      const int g = rf / a.sq, i = rf - g * a.sq;
      from = q + (long long)(hk * a.group + g) * a.q_h +
             (long long)i * a.q_s + c * 8;
    }
    cp_async16(qs + (r / kBQ) * T::kBytes + T::offset(r % kBQ, c), from,
               full);
  }
  load_tile(0);

  float acc[DP / 2];   // acc[4 t + e]: column group t, as mma.sync's C
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kBK / 2];    // S of the tile, laid out as acc
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK, st = j % kStages;
    cp_async_wait<0>();            // this thread's part of tile j landed
    fence_proxy_async();
    // every thread's part of tile j is visible, and every warpgroup is done
    // with tile j - 1, whose stage the next load refills
    __syncthreads();
    load_tile(j + 1);

    // S = Q K^T: k-step kc reads columns 16 kc .. 16 kc + 15 of Q and K
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      constexpr int per_atom = T::kAtom / 16;
      const uint32_t off = (kc / per_atom) * T::kAtomBytes +
                           (kc % per_atom) * 32;
      wgmma_ss(s, qdesc + (off >> 4), kdesc + st * kStage + (off >> 4),
               kc > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(s);

    // The online softmax. Only tiles that reach past the keys every row
    // of the warp sees are masked.
    float corr[2];
    uint32_t pf[NT][2];      // P rounded to bf16 pairs: the A fragments
    auto softmax = [&](auto mask_tag) {
      constexpr bool kMask = decltype(mask_tag)::value;
      auto hidden = [&](int t, int e) {
        const int key = k0 + t * 8 + 2 * tq + (e & 1);
        return kMask && (key >= n_keys || (a.causal && key > pos[e >> 1]));
      };
      // the scores scaled (log2 units), and the tile's row maxima. Each
      // scaled score is rounded before the max is subtracted (__fmul_rn:
      // nvcc may not fuse the two into a multiply-add, which rounds once).
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * t + e] = __fmul_rn(s[4 * t + e], scale);
          mx[e >> 1] = fmaxf(mx[e >> 1],
                             hidden(t, e) ? -INFINITY : s[4 * t + e]);
        }
      }
      // the new maxima (0 for a row with no visible key so far: m_use),
      // and the factor on the running state
      float m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = exp2_ftz(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= corr[r];             // this lane's share of the row's sum
      }
      // P in float32 for l, rounded to bf16 pairs
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = hidden(t, e) ? 0.f
                              : exp2_ftz(s[4 * t + e] - m_use[e >> 1]);
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        pf[t][0] = pack_bf16(p[0], p[1]);
        pf[t][1] = pack_bf16(p[2], p[3]);
      }
    };
    if (k0 + kBK > seen_by_all)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
    // rescale acc where a row's maximum moved (a factor of exactly 1
    // leaves it as it is)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    }

    // acc += P V: k-step kk takes keys 16 kk .. 16 kk + 15 (rows of the V
    // stage), all DP columns
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1],
                              pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
      wgmma_rs(acc, pa, vdesc + st * kStage +
                                 ((kk * 2 * T::kGroupBytes) >> 4), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(acc);
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
            acc[4 * t + 2 * r] / denom, acc[4 * t + 2 * r + 1] / denom);
    }
  }
}

template <int DP>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int WG = warpgroups(DP);
  const size_t smem = kAlign + (2 * kStages + WG) * Tile<DP>::kBytes;
  auto kern = flash_attention_mma_kernel<DP, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = a.group * a.sq;
  const dim3 grid(batch * a.hkv, (rows + WG * kBQ - 1) / (WG * kBQ));
  kern<<<grid, WG * kThreads, smem, stream>>>(a);
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
