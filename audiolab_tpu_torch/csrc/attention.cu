// Attention kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// K1  k1_attention_nk1_sm90  replaces audiolab_tpu/kernels/attention.py
//                            ::_flash_kernel_nk1 (single-KV-block, non-causal)
//                            at d = 64 and tk <= 768: TMA, wgmma, warp
//                            specialisation.
//     k1_attention_nk1       the same function on the WMMA core, for
//                            every other shape.
// K2  k2_flash_attention_sm90 replaces audiolab_tpu/kernels/attention.py
//                            ::_flash_kernel (online softmax over KV tiles,
//                            key-length mask, optional causal mask) for 16-bit
//                            inputs at d = 64 and 128: TMA, wgmma, warp
//                            specialisation.
//     k2_flash_attention     the same function for fp32 inputs (register-tiled
//                            fp32 products) and for every other 16-bit shape.
// K3  k3_attention_nk1_rope_sm90 replaces audiolab_tpu/kernels/attention.py
//                            ::_flash_kernel_nk1_rope (K1 with half-split rope
//                            fused onto the q and k tiles) at d = 64 and
//                            tk <= 768: K1's Hopper time route, K roped once a
//                            slice in shared memory.
//     k3_attention_nk1_rope  the same function on the WMMA core, for every
//                            other shape.
// K6  k6_attention_slim_sm90 replaces tools/probe_freq_bh128.py::_nk1_slim
//                            (K1 with the row sum as a separate fp32 reduction
//                            and no ones-widened v) at d = 64, tq <= 64 and
//                            tk <= 64: K1's Hopper band route.
//     k6_attention_slim      the same function on the WMMA core, for every
//                            other shape.
// K7  k7_attention_packed_sm90 replaces tools/probe_packed_attn.py
//                            ::_packed_kernel (K1 reading q/k/v from the packed
//                            (b, t, h*d) layout and writing the output in it)
//                            at d = 64, t <= 768 and rows TMA can address:
//                            K1's Hopper time route over 4-D tensor maps.
//     k7_attention_packed    the same function on the WMMA core, for every
//                            other shape and stride.
//
// Every entry point takes device pointers and a CUDA stream, launches on
// that stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// K1, K2, K3 and K6 take contiguous (slices, t, d) tensors; K7 takes
// (b, t, row stride) rows, see below.  The times behind the choices named
// here were taken on an NVIDIA H100 80GB HBM3 at a 700.00 W limit by
// chip_smoke.py's kernels phase.
//
// K1 — bound.
//   Work at the RoFormer shapes (bf16): time axis 3968 slices x 690 x 64,
//   4*3968*690^2*64 = 4.84e11 FLOP over 1.40e9 bytes and 1.89e9
//   exponentials (one per query-key pair): tensor cores 0.489 ms at
//   989 TFLOP/s, exponentials 0.485 ms at about 3.9e12/s (the MUFU rate the
//   FlashAttention-3 paper gives for H100 SXM), bytes 0.418 ms; so it is
//   bound by operations, and the exponentials weigh as much as the products.
//   Band axis 44,160 slices x 62 x 64: 4.35e10 FLOP, 1.70e8 exponentials
//   (0.044 ms) over 1.40e9 bytes, bound by bytes (0.418 ms at 3.35 TB/s).
//
// K1 — the Hopper design (k1_attention_nk1_sm90: d = 64, 16-bit, tk <= 768).
//   Q, K and V arrive by TMA from 3-D tensor maps (slice, t, d) in
//   (1, 64, 64) boxes, 128-byte swizzled (a d = 64 row is 128 bytes); a box
//   past t is zero-filled and never reads the next slice.  Both products are
//   wgmma with fp32 accumulators and A from registers: q.k^T (m64n64k16)
//   with q's fragments (scaled and rounded to the input type as they are
//   read from shared memory) and K-major keys; p.v (m64n72k16) with the
//   rounded p straight from the score accumulators and V MN-major (the
//   transpose bit), widened by an all-ones atom that the descriptor's
//   leading offset reaches, so columns 64..71 carry the row sum of the same
//   rounded p on the tensor cores.  A CTA is persistent (one per SM, walking
//   the slices) and warp-specialised: one thread of warpgroup 2 issues the
//   loads and gives its registers away (setmaxnreg 40, the consumers take
//   232), warpgroups 0 and 1 compute, each on its own 64-row query tile;
//   mbarriers carry every hand-off.  Padded keys (key >= tk) are masked
//   before the max: TMA's zero fill gives them score 0, not -inf.  Only the
//   last chunk of a row is masked; the others take an unmasked path.
//   Time route (every other tk): the slice's K and V stay resident in
//   shared memory (2 x 12 x 8 KB at most) for all its query tiles, so they
//   come from device memory once per slice; K is loaded before V and each
//   64-key chunk has its own barrier, so pass 1 starts on the first chunk.
//   Within a warpgroup the products are asynchronous: pass 1 reduces chunk
//   c while chunk c + 1's scores run; pass 2 issues chunk c + 1's scores
//   before chunk c's softmax, and chunk c's p.v runs under chunk c + 1's
//   softmax (two score and two p register sets).
//   Band route (tq <= 64 and tk <= 64): one slice is one tile and one chunk,
//   one pass; the producer keeps 8 slices (q, k, v: 24 KB each) in flight.
//   Why two passes: p is rounded to the input type against the FINAL row
//   max, so the max must be known before any p exists.  Pass 1 runs q.k^T
//   for the max only; pass 2 runs q.k^T again, then exp, rounding, the row
//   sum and p.v per 64-key chunk.  One pass would hold a whole 64 x 704
//   score row (352 registers a thread) in a warpgroup.  Pass 1 has no
//   exponentials, so one warpgroup's pass 1 can overlap the other's pass 2
//   on the MUFU (the two warpgroups run free; nothing forces the pairing).
//
// K3, K6 and K7 — on the Hopper design.
//   No kernel's own function held it back on the WMMA core; the core
//   did: it stages each 64-key chunk by plain loads once per 64-row query
//   tile (a time-axis slice reads its keys 11 times in each of two passes),
//   sends scores and p through shared memory and keeps four warps a CTA.
//   All three run K1's Hopper kernels with one compile-time parameter each,
//   so K1's own instances are unchanged.
//   K3 (k1h_time_kernel<T, false, ROPE = true>): the core roped every key
//     chunk again for every query tile (11 x 11 chunk ropes a slice at
//     t = 690).  Here a slice's K is resident, so it is roped once, in place
//     in its swizzled tiles: the two consumer warpgroups take alternate
//     chunks as they land (k_full), rope them (k1h_rope_tile: both halves of
//     a 128-byte row to registers, then both back; the same rounding points
//     as the core's k1_stage_rope), fence the writes for the async proxy and
//     arrive on a barrier per chunk (k_roped) that every product waits for.
//     A q tile is roped by its own warpgroup with the tables times the scale,
//     behind a warpgroup barrier, and read with scale 1.  The fp32 tables
//     (2 x t x 64) are read from global memory; all slices share them in L2.
//     A band-shaped call (one chunk) takes the same kernel.  Bound: K1's on
//     the time axis; the rope adds 2 x 353 KB of L2 reads a slice.
//   K7 (k1h_time_kernel<T, PACKED = true>): a slice is (batch, head).  The
//     tensor maps are 4-D, (64, heads, t, b) with byte strides (128, 2 ld,
//     2 t ld) and (64, 1, 64, 1) boxes, so a box is the same swizzled 8 KB
//     tile; t is a dimension of its own, so a box past t is zero-filled and
//     never reads the next batch, and so is heads, so a view of a fused qkv
//     activation never reads its neighbour's columns.  K and V stay resident
//     for the slice's 11 query tiles; no transpose or copy runs on either
//     side.  The store writes row i of slice (bi, hi) at bi*t*heads*64 +
//     i*heads*64 + hi*64 with the same quad pattern; rows at or past t of the
//     ragged last tile are not written (they would be the next batch's).
//     CTAs walk s = batch*heads + head, so the heads of a batch run on
//     neighbouring SMs at about the same time and share the DRAM pages of
//     the same rows.  TMA needs 16-byte aligned bases and a row stride of a
//     multiple of 16 bytes; other callers stay on the WMMA core (the wrapper
//     chooses before the launch; nothing falls back after a failure).
//     Bound: K1's on the time axis (operations: products and exponentials).
//   K6 (k1h_band_kernel<T, SLIM = true>): p.v is the plain m64n64k16
//     product, without the ones atom; the row sum is an fp32 reduction over
//     the rounded p in registers (the packed A fragments, unpacked and
//     summed, then over the quad by shuffles), taken while p.v runs; no 2 KB
//     of ones in shared memory.  What the TPU probe asked (a deeper fold per
//     grid step) is here the number of slices the producer keeps in flight:
//     4, 6, 8 and 9 stages of 24 KB measured the same within 1 % (the kernel
//     is bound by bytes and 4 stages already cover the latency), so K6 keeps
//     K1's K1H_STAGES and only that depth is built.  Bound: bytes, like K1's
//     band axis.
//
// K1 — the WMMA core (k1_attention_nk1: every other shape, K3, and the shapes
// of K6 and K7 that the Hopper design does not take).
//   The kernel reproduces the TPU kernel's rounding: q*scale rounded to the
//   input type, fp32 scores, p = exp(s - rowmax) rounded to the input type,
//   numerator and row sum both from the rounded p, out = acc / l.  Rounding
//   p against the FINAL row max needs that max first, so the kernel makes
//   two passes over the keys: pass 1 finds the row max, pass 2 recomputes
//   the scores, rounds p and accumulates p.v.  The last key chunk of pass 1
//   stays in shared memory and opens pass 2, so a slice with one chunk (the
//   band axis, t = 62) computes its scores once.
//   One CTA = 4 warps = a 64-row query tile; each warp owns 16 rows and
//   runs q.k^T and p.v on the tensor cores with WMMA (m16n16k16, fp32
//   accumulate).  Keys stream through shared memory in 64-row chunks, so
//   any t fits.  The band axis packs `slices_per_cta` slices into one CTA
//   (the TPU path folded 64 slices per grid step for the same reason).
//   Not done yet: wgmma, TMA, cp.async pipelining, and keeping the score
//   row in registers instead of a shared-memory round trip.
//
// K3, K6 and K7 off the Hopper shapes are K1's core (k1_kernel) with one
// thing changed, chosen at compile time by its variant, so K1's own instance
// is unchanged:
//   K3 (K1_ROPE): q and k pass through half-split rope as they are staged
//     into shared memory: round_T(x*cos + rot(x)*sin) in fp32, with rot the
//     exact sign-and-swap of the two halves and no contracted multiply-add,
//     as on the TPU.  The scale is folded into the q tables (cos*scale and
//     sin*scale in fp32), so q is rounded once and never again by q*scale.
//     Only table rows below tq (q) and tk (k) are read; padded keys are
//     masked as in K1.  Same bound as K1: the rope adds 8 fp32 operations per
//     staged element and reads the (t, d) fp32 tables through the cache.
//   K6 (K1_SCALED, own entry): the TPU's K1 took its row sum from the p.v
//     product with a ones-widened v; K6 took it as a separate fp32
//     reduction over the rounded p.  The core already sums the rounded p
//     that way (WMMA has no idle lanes to fill), so K6's function runs in
//     K1's scaled instance, with twice K1's slices_per_cta.
//   K7 (K1_PACKED): slice (batch, head) of q/k/v lives at rows of stride
//     ld_in elements (heads*d for a packed tensor, 3*heads*d for a view of a
//     fused qkv activation), starting at batch*t*ld_in + head*d; the output
//     is written at stride heads*d in the same layout, so no transpose pass
//     runs on either side.  A d = 64 bf16 row is 128 contiguous bytes, so
//     the staging loads stay coalesced.  One CTA per (batch, head, 64-row
//     query tile); the ragged query tail is masked (the TPU needed bq | t).
//
// K2 — bound and design.
//   HuBERT (fp32): 96 slices x 399 x 64: 4*96*399^2*64 = 3.9e9 FLOP over
//   3.9e7 bytes; in fp32 outside the tensor cores (67 TFLOP/s) that is
//   0.058 ms, bound by operations.
//   Online softmax as on the TPU: m, l and acc in fp32; keys at or past
//   kv_len masked to -1e30; causal mask key <= query + (tk - tq); KV tiles
//   entirely above the diagonal skipped; l <= 0 -> 1.  As in the TPU kernel
//   the row sum takes the unrounded p and the numerator takes p rounded to
//   v's type.
//   fp32 inputs (k2f_kernel): fp32 inputs must keep fp32 products, so no
//   tensor cores.  One CTA of 256 threads per (slice, 64-query tile); 64-key
//   tiles of K and V (32 for d > 128) double-buffered in shared memory by
//   16-byte cp.async; q.k^T and p.v as register-blocked 4 x 4 micro-tiles,
//   so every value read from shared memory feeds 4 FMAs; the row state
//   (m, l) is reduced over the 16 threads of a row group by shuffles, and p
//   goes through shared memory transposed, in fp32.
//   bf16/fp16 inputs at d = 64 and 128 (k2h_kernel).  Bound: products on
//   the tensor cores and exponentials for long sequences (a causal
//   16 x 2048 x 128 prefill: 1.7e10 FLOP, 0.017 ms), bytes and the launch for
//   short ones (HuBERT's 96 x 399 x 64: 0.006 ms).  One CTA per (slice, 128
//   query rows), last rows first so the longest causal tiles start first.
//   Warp-specialised like K1: one producer thread sends TMA loads of 64-key
//   K and V tiles (d / 64 swizzled 8 KB boxes each) through a ring of 4
//   stages with full barriers for K and for V and one empty barrier; two
//   consumer warpgroups take 64 query rows each and share every tile.  q
//   stays in its swizzled tile and q.k^T is m64n64k16 with both operands from
//   shared memory (the SS form) over d / 16 steps: K2 scales the fp32 scores,
//   not q, so q needs no pass through registers, and ptxas keeps a consumer
//   within the 168 registers of the launch whatever setmaxnreg grants, so
//   registers are what d = 128 runs out of (64 for o, 2 x 32 for scores,
//   2 x 16 for p).  scale * log2 e >= 0 is folded into one fused
//   multiply-add ahead of exp2; the max is taken over the raw scores; keys
//   >= tk or above the diagonal are masked only on tiles that cross either
//   edge; the row sum is an fp32 register reduction of the unrounded p and
//   p.v takes p rounded to T straight from registers (one m64n64k16 a key
//   step at d = 64, one m64n128k16 at d = 128).  Tile j + 1's scores are
//   issued before tile j's softmax and tile j's p.v runs under tile j + 1's
//   softmax; the accumulator is rescaled by alpha only with no product in
//   flight (a write to accumulator registers under one makes ptxas serialise
//   every product, C7515).  Under causal the two warpgroups may stop one tile
//   apart: the one that stops first still releases the other's last tile,
//   after waiting for it to land.  On a long sequence every CTA pulls the
//   slice's whole K and V from L2 again for its 128 rows (64 slices x 4096 x
//   4096 x 64: 2.1 GB through TMA); nothing shares a tile between CTAs yet
//   (no cluster, no multicast), and such shapes run behind the library's
//   attention (PERF.md).
//   Other 16-bit shapes (k2_kernel): TPR threads share one query row,
//   each holding 16 of its dims, and reduce the q.k dot product with warp
//   shuffles.  64-key tiles of K and V are staged in shared memory as fp32.

#include <cuda.h>  // CUtensorMap and its enums only; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// ------------------------------------------------------------------ K1 core

constexpr int K1_BQ = 64;      // query rows per CTA, 16 per warp
constexpr int K1_BK = 64;      // keys per staged chunk
constexpr int K1_WARPS = 4;
constexpr int K1_THREADS = 32 * K1_WARPS;

enum K1Variant { K1_SCALED = 0, K1_ROPE = 1, K1_PACKED = 2 };

struct K1Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* cos;  // K1_ROPE: (>= max(tq, tk), d) fp32 tables
  const float* sin;
  int bh, tq, tk;
  float scale;       // K1_ROPE: folded into the q tables
  int spc;           // slices per CTA
  int heads;         // K1_PACKED: slice = batch * heads + head
  int ld_in;         // K1_PACKED: q/k/v row stride (elements)
  int ld_out;        // K1_PACKED: output row stride (elements)
};

template <typename T, int D>
struct K1Layout {
  static constexpr int LDT = D + 8;          // q/k/v row stride (elements)
  static constexpr int LDP = K1_BK + 8;      // rounded-p row stride
  static constexpr int LDS = K1_BK + 4;      // fp32 score row stride
  static constexpr int LDO = D + 4;          // fp32 output row stride
  static constexpr int LDW = LDS > LDO ? LDS : LDO;
  static constexpr size_t Q_BYTES = size_t(K1_BQ) * LDT * sizeof(T);
  static constexpr size_t KV_BYTES = size_t(K1_BK) * LDT * sizeof(T);
  static constexpr size_t S_BYTES = size_t(K1_WARPS) * 16 * LDW * sizeof(float);
  static constexpr size_t P_BYTES = size_t(K1_WARPS) * 16 * LDP * sizeof(T);
  static constexpr size_t BYTES = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES;
};

// rows [r0, r0 + K1_BK) of a (t, D) slice with row stride lds into shared
// memory with stride ld; rows at or past t are zero
template <typename T, int D>
__device__ __forceinline__ void k1_stage(T* dst, const T* __restrict__ src, int r0, int t, int ld,
                                         int lds) {
  const T zero = from_f<T>(0.f);
  for (int i = threadIdx.x; i < K1_BK * D; i += K1_THREADS) {
    const int r = i / D, c = i - r * D;
    const int g = r0 + r;
    dst[r * ld + c] = g < t ? src[(size_t)g * lds + c] : zero;
  }
}

// rows [r0, r0 + rows) of a contiguous (t, D) slice, half-split roped with
// the (t, D) tables times tscale: round_T(x*cos + rot(x)*sin), fp32, each
// product and the sum rounded on its own as on the TPU; rows at or past t
// are zero and their table rows are never read
template <typename T, int D>
__device__ __forceinline__ void k1_stage_rope(T* dst, const T* __restrict__ src,
                                              const float* __restrict__ cosv,
                                              const float* __restrict__ sinv, int r0, int rows,
                                              int t, int ld, float tscale) {
  constexpr int H = D / 2;
  const T zero = from_f<T>(0.f);
  for (int i = threadIdx.x; i < rows * D; i += K1_THREADS) {
    const int r = i / D, c = i - r * D;
    const int g = r0 + r;
    T val = zero;
    if (g < t) {
      const T* row = src + (size_t)g * D;
      const float x = to_f<T>(row[c]);
      const float xr = c < H ? -to_f<T>(row[c + H]) : to_f<T>(row[c - H]);
      const float cs = __fmul_rn(cosv[(size_t)g * D + c], tscale);
      const float sn = __fmul_rn(sinv[(size_t)g * D + c], tscale);
      val = from_f<T>(__fadd_rn(__fmul_rn(x, cs), __fmul_rn(xr, sn)));
    }
    dst[r * ld + c] = val;
  }
}

// S(16 x 64) = Q_w(16 x D) . K_chunk(64 x D)^T into sw (fp32, stride LDW)
template <typename T, int D>
__device__ __forceinline__ void k1_scores(
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> (&qa)[D / 16],
    const T* ks, float* sw) {
  using L = K1Layout<T, D>;
#pragma unroll
  for (int n = 0; n < K1_BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
      wmma::load_matrix_sync(b, ks + n * 16 * L::LDT + kk * 16, L::LDT);
      wmma::mma_sync(c, qa[kk], b, c);
    }
    wmma::store_matrix_sync(sw + n * 16, c, L::LDW, wmma::mem_row_major);
  }
}

template <typename T, int D, int V>
__global__ void __launch_bounds__(K1_THREADS) k1_kernel(const K1Params prm) {
  using L = K1Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::Q_BYTES);
  T* vs = reinterpret_cast<T*>(smem + L::Q_BYTES + L::KV_BYTES);
  float* ss = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES);
  T* ps = reinterpret_cast<T*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES);

  const T* __restrict__ q = static_cast<const T*>(prm.q);
  const T* __restrict__ k = static_cast<const T*>(prm.k);
  const T* __restrict__ v = static_cast<const T*>(prm.v);
  T* __restrict__ o = static_cast<T*>(prm.o);
  const int tq = prm.tq, tk = prm.tk;
  const float scale = prm.scale;
  // row strides of the inputs and the output, in elements
  const int ld = V == K1_PACKED ? prm.ld_in : D;
  const int ldo = V == K1_PACKED ? prm.ld_out : D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sw = ss + warp * 16 * L::LDW;
  T* pw = ps + warp * 16 * L::LDP;
  const int r = lane >> 1;      // the row of the warp tile this lane reduces
  const int half = lane & 1;    // it takes the columns of this parity
  const int q0 = blockIdx.y * K1_BQ;
  const int qrow = q0 + warp * 16 + r;
  const int nchunks = (tk + K1_BK - 1) / K1_BK;
  const int s_begin = blockIdx.x * prm.spc;
  const int s_end = min(s_begin + prm.spc, prm.bh);

  for (int sl = s_begin; sl < s_end; ++sl) {
    size_t qoff, koff, ooff;
    if constexpr (V == K1_PACKED) {
      const int bi = sl / prm.heads, hi = sl - bi * prm.heads;
      qoff = (size_t)bi * tq * ld + (size_t)hi * D;
      koff = (size_t)bi * tk * ld + (size_t)hi * D;
      ooff = (size_t)bi * tq * ldo + (size_t)hi * D;
    } else {
      qoff = ooff = (size_t)sl * tq * D;
      koff = (size_t)sl * tk * D;
    }
    const T* qg = q + qoff;
    const T* kg = k + koff;
    const T* vg = v + koff;
    auto stage_keys = [&](int k0) {
      if constexpr (V == K1_ROPE)
        k1_stage_rope<T, D>(ks, kg, prm.cos, prm.sin, k0, K1_BK, tk, L::LDT, 1.f);
      else
        k1_stage<T, D>(ks, kg, k0, tk, L::LDT, ld);
    };

    __syncthreads();  // the previous slice is done with every buffer
    if constexpr (V == K1_ROPE) {
      // the scale lives in the q tables: q is rounded once, after rope
      k1_stage_rope<T, D>(qs, qg, prm.cos, prm.sin, q0, K1_BQ, tq, L::LDT, scale);
    } else {
      // q * scale, rounded to T as the TPU kernel does (q_ref * scale in dt)
      for (int i = threadIdx.x; i < K1_BQ * D; i += K1_THREADS) {
        const int rr = i / D, cc = i - rr * D;
        const int g = q0 + rr;
        const float x = g < tq ? to_f<T>(qg[(size_t)g * ld + cc]) * scale : 0.f;
        qs[rr * L::LDT + cc] = from_f<T>(x);
      }
    }
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qa[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], qs + warp * 16 * L::LDT + kk * 16, L::LDT);

    // pass 1: row max over the valid keys
    float m = -INFINITY;
    for (int c = 0; c < nchunks; ++c) {
      const int k0 = c * K1_BK;
      __syncthreads();
      stage_keys(k0);
      __syncthreads();
      k1_scores<T, D>(qa, ks, sw);
      __syncwarp();
      float mx = -INFINITY;
#pragma unroll 8
      for (int j = 0; j < K1_BK / 2; ++j) {
        const int col = 2 * j + half;
        if (k0 + col < tk) mx = fmaxf(mx, sw[r * L::LDW + col]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      m = fmaxf(m, mx);
      __syncwarp();
    }

    // pass 2: p = round(exp(s - m)); acc += p.v; l += p.  The last chunk's
    // keys and scores are still resident, so it goes first.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) wmma::fill_fragment(acc[nd], 0.f);
    float l = 0.f;
    for (int it = 0; it < nchunks; ++it) {
      const int c = it == 0 ? nchunks - 1 : it - 1;
      const int k0 = c * K1_BK;
      __syncthreads();
      if (it > 0) stage_keys(k0);
      k1_stage<T, D>(vs, vg, k0, tk, L::LDT, ld);
      __syncthreads();
      if (it > 0) {
        k1_scores<T, D>(qa, ks, sw);
        __syncwarp();
      }
#pragma unroll 8
      for (int j = 0; j < K1_BK / 2; ++j) {
        const int col = 2 * j + half;
        const float p = k0 + col < tk ? expf(sw[r * L::LDW + col] - m) : 0.f;
        const T pt = from_f<T>(p);
        l += to_f<T>(pt);
        pw[r * L::LDP + col] = pt;
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < K1_BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, pw + kk * 16, L::LDP);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
          wmma::load_matrix_sync(b, vs + kk * 16 * L::LDT + nd * 16, L::LDT);
          wmma::mma_sync(acc[nd], a, b, acc[nd]);
        }
      }
      __syncwarp();
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);

    // epilogue: acc through shared memory, divided by the row sum
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd)
      wmma::store_matrix_sync(sw + nd * 16, acc[nd], L::LDW, wmma::mem_row_major);
    __syncwarp();
    if (qrow < tq) {
      const float den = l > 0.f ? l : 1.f;
      T* og = o + ooff + (size_t)qrow * ldo;
      for (int cc = half; cc < D; cc += 2) og[cc] = from_f<T>(sw[r * L::LDW + cc] / den);
    }
  }
}

template <typename T, int D, int V>
cudaError_t k1_launch(const K1Params& prm, cudaStream_t stream) {
  const size_t bytes = K1Layout<T, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(k1_kernel<T, D, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((prm.bh + prm.spc - 1) / prm.spc, (prm.tq + K1_BQ - 1) / K1_BQ);
  k1_kernel<T, D, V><<<grid, K1_THREADS, bytes, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t k1_dispatch(const K1Params& prm, int d, cudaStream_t s) {
  switch (d) {
    case 16: return k1_launch<T, 16, V>(prm, s);
    case 32: return k1_launch<T, 32, V>(prm, s);
    case 64: return k1_launch<T, 64, V>(prm, s);
    case 128: return k1_launch<T, 128, V>(prm, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ K1 on Hopper

// Shared by both routes: a 64 x 64 16-bit tile is one TMA box of 8 KB,
// 128-byte swizzled, at a 1024-byte aligned address.
constexpr int K1H_CONS = 2;                        // consumer warpgroups 0 and 1
constexpr int K1H_THREADS = 128 * (K1H_CONS + 1);  // and the producer warpgroup
// setmaxnreg moves registers from the producer warpgroup to the consumers:
// 168 a thread at launch (65536 / 384), 40 and 232 after
constexpr int K1H_PRODUCER_REGS = 40;
constexpr int K1H_CONSUMER_REGS = 232;
constexpr int K1H_TILE = 8192;
constexpr int K1H_MAX_CHUNKS = 12; // 768 keys
constexpr int K1H_STAGES = 8;      // band route: slices in flight per CTA
constexpr float K1H_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// returns once the phase of this parity has completed; a wait of more than
// about 2^32 cycles (2 s) is a pipeline fault and traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// one (64 d, 64 rows, 1 slice) box at (col, row, slice); rows past the map's t
// arrive as zeros.  col is 0 for d = 64; a d = 128 row is two boxes.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int slice, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(slice)
      : "memory");
}

// the packed layout's (64 d, 1 head, 64 rows, 1 batch) box at
// (0, head, row, batch): the same 8 KB tile; rows past t arrive as zeros and
// never come from the next batch, columns never from the next head
__device__ __forceinline__ void tma_load_tile4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// One tile of slice s.  PACKED = false: s indexes a contiguous (slices, t, 64)
// tensor.  PACKED = true: s = batch * heads + head of (b, t, row stride) rows.
template <bool PACKED>
__device__ __forceinline__ void k1h_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int s, int heads) {
  if constexpr (PACKED) {
    const int bi = s / heads;
    tma_load_tile4(dst, map, bar, s - bi * heads, row, bi);
  } else {
    tma_load_tile(dst, map, bar, row, s);
  }
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keep the compiler from moving register traffic across an async product
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) |
         (1ull << 62);
}

#define K1H_WGMMA_RS(TY)                                                                      \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "     \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
        "+f"(d[31])                                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(scale_d))

// D(64 x 64, fp32) (+)= A(64 x 16, registers) . B(16 x 64, shared memory);
// TB = 0: B's rows are K-major (q.k^T), TB = 1: MN-major (p.v)
template <typename T, int TB> struct Wgmma;
template <int TB> struct Wgmma<__nv_bfloat16, TB> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    K1H_WGMMA_RS("bf16");
  }
};
template <int TB> struct Wgmma<__half, TB> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    K1H_WGMMA_RS("f16");
  }
};
#undef K1H_WGMMA_RS

// the same product with A from shared memory too (the SS form): A is 64 rows
// K-major in a swizzled tile, described like B
#define K1H_WGMMA_SS(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %34;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
               : "l"(da), "l"(db), "n"(TB), "r"(scale_d))
// D(64 x 128) (+)= A(64 x 16, registers) . B(16 x 128, MN-major): columns
// 0..63 from one swizzled sub-tile, 64..127 from the next, LBO bytes on
#define K1H_WGMMA_RS_N128(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <typename T, int TB> struct WgmmaSS;
template <int TB> struct WgmmaSS<__nv_bfloat16, TB> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    K1H_WGMMA_SS("bf16");
  }
};
template <int TB> struct WgmmaSS<__half, TB> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    K1H_WGMMA_SS("f16");
  }
};
template <typename T> struct WgmmaN128;
template <> struct WgmmaN128<__nv_bfloat16> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    K1H_WGMMA_RS_N128("bf16");
  }
};
template <> struct WgmmaN128<__half> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    K1H_WGMMA_RS_N128("f16");
  }
};
#undef K1H_WGMMA_SS
#undef K1H_WGMMA_RS_N128


// D(64 x 72) (+)= A(64 x 16, registers) . B(16 x 72, MN-major): columns
// 0..63 from one 128-byte swizzle atom, 64..71 from the next, LBO bytes on
template <typename T> struct WgmmaN72;
#define K1H_WGMMA_RS_N72(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n72k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <> struct WgmmaN72<__nv_bfloat16> {
  static __device__ __forceinline__ void rs(float (&d)[36], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    K1H_WGMMA_RS_N72("bf16");
  }
};
template <> struct WgmmaN72<__half> {
  static __device__ __forceinline__ void rs(float (&d)[36], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    K1H_WGMMA_RS_N72("f16");
  }
};
#undef K1H_WGMMA_RS_N72

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t x);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Register layouts (per warp wi of a warpgroup, lane = 4g + t): accumulator
// element d[4j + e] is row 16wi + g + 8(e >> 1), column 8j + 2t + (e & 1);
// an A fragment a[kk][i] holds row 16wi + g + 8(i & 1), columns
// 16kk + 8(i >> 1) + 2t and +1.

// q's A fragments from a swizzled tile, times the scale rounded to T: the
// TPU kernel's q_ref * scale in the input type
template <typename T>
__device__ __forceinline__ void k1h_load_q(uint32_t (&qa)[4][4], uint32_t tile, int wi, int lane,
                                           float scale) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * wi + g + 8 * (i & 1);
      const int c = 16 * kk + 8 * (i >> 1) + 2 * t;
      const uint32_t addr = tile + r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
      uint32_t raw;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(raw) : "r"(addr));
      const float2 x = unpack2<T>(raw);
      qa[kk][i] = pack2<T>(x.x * scale, x.y * scale);
    }
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Asynchronous products, one commit group each; the caller waits.  A
// register array an in-flight product reads or writes is fenced after the
// wait that completes it, so the compiler keeps it intact until then.

// s = q . k^T over one 64-key chunk (keys K-major in a swizzled tile)
template <typename T>
__device__ __forceinline__ void k1h_issue_scores(float (&s)[32], const uint32_t (&qa)[4][4],
                                                 uint32_t ktile) {
  reg_fence(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<T, 0>::rs(s, qa[kk], sw128_desc(ktile + kk * 32, 1, 64), kk > 0);
  wg_commit();
}

// o += p . [v | ones] over one 64-key chunk: v MN-major in a swizzled tile
// (the transpose bit), columns 64..71 from an all-ones atom LBO bytes
// further on, so o[32..35] carry the row sum of the rounded p, the same p
// the numerator takes, summed in fp32 on the tensor cores
template <typename T>
__device__ __forceinline__ void k1h_issue_pv(float (&o)[36], const uint32_t (&pa)[4][4],
                                               uint32_t vtile, uint32_t ones_mn) {
  reg_fence(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t b = vtile + kk * 2048;
    WgmmaN72<T>::rs(o, pa[kk], sw128_desc(b, (ones_mn - b) >> 4, 64), 1);
  }
  wg_commit();
}

// o += p . v over one 64-key chunk as the plain m64n64k16 product (K6): no
// ones atom; the caller takes the row sum from p itself
template <typename T>
__device__ __forceinline__ void k1h_issue_pv(float (&o)[32], const uint32_t (&pa)[4][4],
                                             uint32_t vtile) {
  reg_fence(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<T, 1>::rs(o, pa[kk], sw128_desc(vtile + kk * 2048, 1, 64), 1);
  wg_commit();
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// l = the row sums of the rounded p held in A fragments (K6): a separate
// fp32 reduction, each lane over its 16 keys of a row, then over the quad
template <typename T>
__device__ __forceinline__ void k1h_row_sum(float (&l)[2], const uint32_t (&pa)[4][4]) {
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack2<T>(pa[kk][i]);
      part[i & 1] += x.x + x.y;
    }
  l[0] = quad_sum(part[0]);
  l[1] = quad_sum(part[1]);
}

// m = max(m, s) over the chunk's keys below tk (padded keys masked, never 0);
// MASK = false for a chunk wholly below tk
template <bool MASK>
__device__ __forceinline__ void k1h_row_max(float (&m)[2], const float (&s)[32], int k0, int tk,
                                            int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      if (!MASK || key < tk) m[e >> 1] = fmaxf(m[e >> 1], s[4 * j + e]);
    }
}

__device__ __forceinline__ void k1h_max(float (&m)[2], const float (&s)[32], int k0, int tk,
                                        int t) {
  if (k0 + 64 <= tk)
    k1h_row_max<false>(m, s, k0, tk, t);
  else
    k1h_row_max<true>(m, s, k0, tk, t);
}

// p = round_T(exp(s - m)) into A fragments (ml = m * log2 e)
template <typename T, bool MASK>
__device__ __forceinline__ void k1h_probs_m(uint32_t (&pa)[4][4], const float (&s)[32],
                                            const float (&ml)[2], int k0, int tk, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = 8 * kk + 2 * i;
      const int key = k0 + 16 * kk + 8 * (i >> 1) + 2 * t;
      const int h = i & 1;
      const float p0 = !MASK || key < tk ? ex2(fmaf(s[idx], K1H_LOG2E, -ml[h])) : 0.f;
      const float p1 = !MASK || key + 1 < tk ? ex2(fmaf(s[idx + 1], K1H_LOG2E, -ml[h])) : 0.f;
      pa[kk][i] = pack2<T>(p0, p1);
    }
}

template <typename T>
__device__ __forceinline__ void k1h_probs(uint32_t (&pa)[4][4], const float (&s)[32],
                                          const float (&ml)[2], int k0, int tk, int t) {
  if (k0 + 64 <= tk)
    k1h_probs_m<T, false>(pa, s, ml, k0, tk, t);
  else
    k1h_probs_m<T, true>(pa, s, ml, k0, tk, t);
}

// out = o / l for the warp's rows below tq; `out` is the slice's row 0 and ld
// its row stride in elements.  Rows at or past tq are never written: in the
// packed layout they are the next batch's.
template <typename T, int N>
__device__ __forceinline__ void k1h_store(T* __restrict__ out, int ld, const float (&o)[N],
                                          const float (&l)[2], int row0, int tq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= tq) continue;
    const float den = l[h] > 0.f ? l[h] : 1.f;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)row * ld + 2 * t);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[4 * j] = pack2<T>(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
  }
}

struct K1HParams {
  void* o;
  int bh, tq, tk;
  int nch;  // 64-key chunks (time route)
  float scale;
  int heads;  // packed layout: slice = batch * heads + head
  int ldo;    // packed layout: the output's row stride (elements)
  const float* cos;  // rope variant: (>= max(tq, tk), 64) fp32 tables, 16-byte aligned
  const float* sin;
};

// row 0 of slice s in the output, and the output's row stride
template <typename T, bool PACKED>
__device__ __forceinline__ T* k1h_out(const K1HParams& prm, int s, int& ld) {
  T* o = static_cast<T*>(prm.o);
  if constexpr (PACKED) {
    const int bi = s / prm.heads, hi = s - bi * prm.heads;
    ld = prm.ldo;
    return o + (size_t)bi * prm.tq * prm.ldo + hi * 64;
  } else {
    ld = 64;
    return o + (size_t)s * prm.tq * 64;
  }
}

__device__ __forceinline__ uint32_t k1h_align(const unsigned char* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

// 2 KB of ones in T (two 8-key swizzle atoms) for the row-sum columns,
// made visible to wgmma (the async proxy) before the CTA's first barrier
template <typename T>
__device__ __forceinline__ void k1h_fill_ones(uint32_t ones) {
  const uint32_t two = pack2<T>(1.f, 1.f);
  for (int i = threadIdx.x; i < 512; i += K1H_THREADS)
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(ones + 4 * i), "r"(two) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one element of half-split rope, the table entry times tscale first; each
// product and the sum rounded on its own, as on the TPU (no contraction)
__device__ __forceinline__ float k1h_rope1(float x, float xr, float c, float s, float tscale) {
  return __fadd_rn(__fmul_rn(x, __fmul_rn(c, tscale)), __fmul_rn(xr, __fmul_rn(s, tscale)));
}

// Half-split rope, in place, of rows [row0, row0 + 64) of a slice in a
// swizzled 64 x 64 tile, by the 128 threads of one warpgroup (tid 0..127):
// round_T(x * cos + rot(x) * sin) with the table rows of those positions.  A
// row is 128 bytes; the swizzle moves its 16-byte pieces by row mod 8, and a
// column's partner (32 on) lies four pieces on in the same row: a thread
// reads piece p and piece p + 4 of a row, then writes both.  Rows at or
// past t are left alone (TMA zero-filled them and rope keeps zeros; their
// table rows are never read).  Ends with the fence that makes the writes
// visible to wgmma and orders them before the next TMA load into the tile.
template <typename T>
__device__ __forceinline__ void k1h_rope_tile(uint32_t tile, const float* __restrict__ cosv,
                                              const float* __restrict__ sinv, int row0, int t,
                                              float tscale, int tid) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int item = tid + 128 * it;
    const int r = item >> 2, p = item & 3;
    const int g = row0 + r;
    if (g >= t) continue;
    const uint32_t lo = tile + r * 128 + ((p ^ (r & 7)) << 4);
    const uint32_t hi = tile + r * 128 + (((p + 4) ^ (r & 7)) << 4);
    uint32_t xl[4], xh[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(xl[0]), "=r"(xl[1]), "=r"(xl[2]), "=r"(xl[3])
                 : "r"(lo));
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(xh[0]), "=r"(xh[1]), "=r"(xh[2]), "=r"(xh[3])
                 : "r"(hi));
    // columns 8p..8p+7 are float4 0 and 1 of the row's piece; their partners
    // 32 floats (8 float4) on
    const float4* cr = reinterpret_cast<const float4*>(cosv + (size_t)g * 64 + 8 * p);
    const float4* sr = reinterpret_cast<const float4*>(sinv + (size_t)g * 64 + 8 * p);
    const float4 c4[4] = {__ldg(cr), __ldg(cr + 1), __ldg(cr + 8), __ldg(cr + 9)};
    const float4 s4[4] = {__ldg(sr), __ldg(sr + 1), __ldg(sr + 8), __ldg(sr + 9)};
    const float cl[8] = {c4[0].x, c4[0].y, c4[0].z, c4[0].w, c4[1].x, c4[1].y, c4[1].z, c4[1].w};
    const float ch[8] = {c4[2].x, c4[2].y, c4[2].z, c4[2].w, c4[3].x, c4[3].y, c4[3].z, c4[3].w};
    const float sl[8] = {s4[0].x, s4[0].y, s4[0].z, s4[0].w, s4[1].x, s4[1].y, s4[1].z, s4[1].w};
    const float sh[8] = {s4[2].x, s4[2].y, s4[2].z, s4[2].w, s4[3].x, s4[3].y, s4[3].z, s4[3].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = unpack2<T>(xl[e]), b = unpack2<T>(xh[e]);
      // first half: rot(x) = -x[c + 32]; second half: rot(x) = x[c - 32]
      xl[e] = pack2<T>(k1h_rope1(a.x, -b.x, cl[2 * e], sl[2 * e], tscale),
                       k1h_rope1(a.y, -b.y, cl[2 * e + 1], sl[2 * e + 1], tscale));
      xh[e] = pack2<T>(k1h_rope1(b.x, a.x, ch[2 * e], sh[2 * e], tscale),
                       k1h_rope1(b.y, a.y, ch[2 * e + 1], sh[2 * e + 1], tscale));
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo), "r"(xl[0]), "r"(xl[1]),
                 "r"(xl[2]), "r"(xl[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi), "r"(xh[0]), "r"(xh[1]),
                 "r"(xh[2]), "r"(xh[3])
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Time route: K and V of a slice stay resident; the two consumer
// warpgroups take alternate 64-row query tiles of it.  PACKED (K7): the
// slices are the (batch, head) pairs of (b, t, row stride) rows, read through
// 4-D tensor maps, and the output goes back in the packed layout; the
// pipeline and the arithmetic are K1's.  ROPE (K3): q and k pass through
// half-split rope in shared memory before any product reads them.  K is
// resident, so it is roped once a slice: the consumer warpgroups take
// alternate chunks as they land and announce each on its own barrier
// (k_roped), which every product on that chunk waits for in place of k_full.
// A q tile is roped by the warpgroup that owns it, with the scale folded
// into the tables, and then read with scale 1, so q is rounded once.  The
// tables come from global memory: 2 x t x 64 fp32 do not fit beside K and V,
// and every slice shares them in L2.
template <typename T, bool PACKED, bool ROPE = false>
__global__ void __launch_bounds__(K1H_THREADS, 1)
k1h_time_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const K1HParams prm) {
  extern __shared__ unsigned char k1h_smem[];
  const int nch = prm.nch;
  const uint32_t qbuf = k1h_align(k1h_smem);          // a tile per consumer
  const uint32_t kbuf = qbuf + K1H_CONS * K1H_TILE;   // nch tiles
  const uint32_t vbuf = kbuf + nch * K1H_TILE;        // nch tiles
  const uint32_t ones = vbuf + nch * K1H_TILE;       // 2 KB of ones, past every v tile
  const uint32_t bars = ones + 2048;
  // barriers: q full[CONS], q empty[CONS], kv empty, k full[nch], v full[nch]
  auto q_full = [&](int w) { return bars + 8 * w; };
  auto q_empty = [&](int w) { return bars + 8 * (K1H_CONS + w); };
  const uint32_t kv_empty = bars + 16 * K1H_CONS;
  auto k_full = [&](int c) { return kv_empty + 8 + 8 * c; };
  auto v_full = [&](int c) { return kv_empty + 8 + 8 * (nch + c); };
  auto k_roped = [&](int c) { return kv_empty + 8 + 8 * (2 * nch + c); };  // ROPE only
  // what a product on chunk c waits for
  auto k_ready = [&](int c) { return ROPE ? k_roped(c) : k_full(c); };
  const int nqt = (prm.tq + 63) / 64;

  k1h_fill_ones<T>(ones);
  if (threadIdx.x == 0) {
    for (int w = 0; w < K1H_CONS; ++w) {
      mbar_init(q_full(w), 1);
      mbar_init(q_empty(w), 128);
    }
    mbar_init(kv_empty, 128 * K1H_CONS);
    for (int c = 0; c < nch; ++c) {
      mbar_init(k_full(c), 1);
      mbar_init(v_full(c), 1);
      if constexpr (ROPE) mbar_init(k_roped(c), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == K1H_CONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(K1H_PRODUCER_REGS) : "memory");
    if (threadIdx.x == 128 * K1H_CONS) {
      int n = 0, used[K1H_CONS] = {};
      for (int s = blockIdx.x; s < prm.bh; s += gridDim.x, ++n) {
        if (n > 0) mbar_wait(kv_empty, (n - 1) & 1);
        for (int c = 0; c < nch; ++c) {  // every K chunk before V: pass 1 needs K only
          mbar_expect_tx(k_full(c), K1H_TILE);
          k1h_load_tile<PACKED>(kbuf + c * K1H_TILE, &mk, k_full(c), 64 * c, s, prm.heads);
        }
        for (int c = 0; c < nch; ++c) {
          mbar_expect_tx(v_full(c), K1H_TILE);
          k1h_load_tile<PACKED>(vbuf + c * K1H_TILE, &mv, v_full(c), 64 * c, s, prm.heads);
        }
        for (int j = 0; j < nqt; ++j) {
          const int w = j % K1H_CONS;
          if (used[w] > 0) mbar_wait(q_empty(w), (used[w] - 1) & 1);
          mbar_expect_tx(q_full(w), K1H_TILE);
          k1h_load_tile<PACKED>(qbuf + w * K1H_TILE, &mq, q_full(w), 64 * j, s, prm.heads);
          ++used[w];
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(K1H_CONSUMER_REGS) : "memory");
    const int wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t = lane & 3;
    int n = 0, used = 0;
    for (int s = blockIdx.x; s < prm.bh; s += gridDim.x, ++n) {
      const uint32_t par = n & 1;
      if constexpr (ROPE) {
        // this warpgroup's share of the slice's key chunks, whether or not it
        // has a query tile here
        for (int c = wg; c < nch; c += K1H_CONS) {
          mbar_wait(k_full(c), par);
          k1h_rope_tile<T>(kbuf + c * K1H_TILE, prm.cos, prm.sin, 64 * c, prm.tk, 1.f,
                           threadIdx.x & 127);
          mbar_arrive(k_roped(c));
        }
      }
      for (int j = wg; j < nqt; j += K1H_CONS, ++used) {
        uint32_t qa[4][4];
        mbar_wait(q_full(wg), used & 1);
        if constexpr (ROPE) {
          k1h_rope_tile<T>(qbuf + wg * K1H_TILE, prm.cos, prm.sin, 64 * j, prm.tq, prm.scale,
                           threadIdx.x & 127);
          asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");  // the warpgroup's own
          k1h_load_q<T>(qa, qbuf + wg * K1H_TILE, wi, lane, 1.f);
        } else {
          k1h_load_q<T>(qa, qbuf + wg * K1H_TILE, wi, lane, prm.scale);
        }
        mbar_arrive(q_empty(wg));

        // pass 1: the row max over the valid keys; chunk c + 1's product
        // runs while chunk c is reduced
        float sa[32], sb[32];
        float m[2] = {-INFINITY, -INFINITY};
        mbar_wait(k_ready(0), par);
        k1h_issue_scores<T>(sa, qa, kbuf);
        for (int c = 0; c < nch; c += 2) {
          if (c + 1 < nch) {
            mbar_wait(k_ready(c + 1), par);
            k1h_issue_scores<T>(sb, qa, kbuf + (c + 1) * K1H_TILE);
            wg_wait<1>();
          } else {
            wg_wait<0>();
          }
          reg_fence(sa);
          k1h_max(m, sa, 64 * c, prm.tk, t);
          if (c + 1 >= nch) break;
          if (c + 2 < nch) {
            mbar_wait(k_ready(c + 2), par);
            k1h_issue_scores<T>(sa, qa, kbuf + (c + 2) * K1H_TILE);
            wg_wait<1>();
          } else {
            wg_wait<0>();
          }
          reg_fence(sb);
          k1h_max(m, sb, 64 * (c + 1), prm.tk, t);
        }
        const float ml[2] = {quad_max(m[0]) * K1H_LOG2E, quad_max(m[1]) * K1H_LOG2E};

        // pass 2: scores again, p rounded against the final max, p.v.
        // Chunk c + 1's scores are issued before chunk c's softmax, and
        // chunk c's p.v runs while chunk c + 1's softmax does: scores and p
        // alternate between two register sets each.
        float acc[36];  // o, then the row sum in columns 64..71
#pragma unroll
        for (int i = 0; i < 36; ++i) acc[i] = 0.f;
        uint32_t pa[4][4], pb[4][4];
        k1h_issue_scores<T>(sa, qa, kbuf);
        wg_wait<0>();
        reg_fence(sa);
        for (int c = 0; c < nch; c += 2) {
          if (c + 1 < nch) k1h_issue_scores<T>(sb, qa, kbuf + (c + 1) * K1H_TILE);
          k1h_probs<T>(pa, sa, ml, 64 * c, prm.tk, t);
          mbar_wait(v_full(c), par);
          k1h_issue_pv<T>(acc, pa, vbuf + c * K1H_TILE, ones);
          if (c + 1 >= nch) break;
          wg_wait<1>();  // scores c + 1, and p.v of chunk c - 1
          reg_fence(sb);
          reg_fence(pb);
          if (c + 2 < nch) k1h_issue_scores<T>(sa, qa, kbuf + (c + 2) * K1H_TILE);
          k1h_probs<T>(pb, sb, ml, 64 * (c + 1), prm.tk, t);
          mbar_wait(v_full(c + 1), par);
          k1h_issue_pv<T>(acc, pb, vbuf + (c + 1) * K1H_TILE, ones);
          if (c + 2 >= nch) break;
          wg_wait<1>();  // scores c + 2, and p.v of chunk c
          reg_fence(sa);
          reg_fence(pa);
        }
        wg_wait<0>();
        reg_fence(acc);
        reg_fence(pa);
        reg_fence(pb);
        reg_fence(qa);
        const float l[2] = {acc[32], acc[34]};
        int ld;
        T* out = k1h_out<T, PACKED>(prm, s, ld);
        k1h_store<T>(out, ld, acc, l, 64 * j + 16 * wi, prm.tq, lane);
      }
      // a warpgroup without a tile here must not arrive for this slice
      // before the previous slice's release has completed
      mbar_wait(k_full(0), par);
      mbar_arrive(kv_empty);
    }
  }
}

// Band route: one slice is one query tile and one key chunk; the producer
// keeps K1H_STAGES slices (q, k, v) in flight, the consumer warpgroups take
// alternate slices.  SLIM (K6): p.v is the plain m64n64k16 product, the row
// sum a separate fp32 reduction over the rounded p in registers, taken while
// that product runs, and there is no ones block in shared memory.
template <typename T, bool SLIM>
__global__ void __launch_bounds__(K1H_THREADS, 1)
k1h_band_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const K1HParams prm) {
  extern __shared__ unsigned char k1h_smem[];
  const uint32_t ring = k1h_align(k1h_smem);  // stage st: q, k, v tiles at 3 * st
  const uint32_t ones = ring + 3 * K1H_STAGES * K1H_TILE;  // 2 KB, past every v tile
  const uint32_t bars = ones + (SLIM ? 0 : 2048);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (K1H_STAGES + st); };

  if constexpr (!SLIM) k1h_fill_ones<T>(ones);
  if (threadIdx.x == 0) {
    for (int st = 0; st < K1H_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == K1H_CONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(K1H_PRODUCER_REGS) : "memory");
    if (threadIdx.x == 128 * K1H_CONS) {
      int i = 0;
      for (int s = blockIdx.x; s < prm.bh; s += gridDim.x, ++i) {
        const int st = i % K1H_STAGES, r = i / K1H_STAGES;
        if (r > 0) mbar_wait(empty(st), (r - 1) & 1);
        const uint32_t tile = ring + 3 * st * K1H_TILE;
        mbar_expect_tx(full(st), 3 * K1H_TILE);
        tma_load_tile(tile, &mq, full(st), 0, s);
        tma_load_tile(tile + K1H_TILE, &mk, full(st), 0, s);
        tma_load_tile(tile + 2 * K1H_TILE, &mv, full(st), 0, s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(K1H_CONSUMER_REGS) : "memory");
    const int wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t = lane & 3;
    T* __restrict__ o = static_cast<T*>(prm.o);
    int i = wg;
    for (int s = blockIdx.x + wg * gridDim.x; s < prm.bh;
         s += K1H_CONS * gridDim.x, i += K1H_CONS) {
      const int st = i % K1H_STAGES;
      const uint32_t tile = ring + 3 * st * K1H_TILE;
      mbar_wait(full(st), (i / K1H_STAGES) & 1);
      uint32_t qa[4][4];
      k1h_load_q<T>(qa, tile, wi, lane, prm.scale);
      float s_acc[32];
      k1h_issue_scores<T>(s_acc, qa, tile + K1H_TILE);
      wg_wait<0>();
      reg_fence(s_acc);
      float m[2] = {-INFINITY, -INFINITY};
      k1h_max(m, s_acc, 0, prm.tk, t);
      const float ml[2] = {quad_max(m[0]) * K1H_LOG2E, quad_max(m[1]) * K1H_LOG2E};
      float acc[SLIM ? 32 : 36];
#pragma unroll
      for (int e = 0; e < (SLIM ? 32 : 36); ++e) acc[e] = 0.f;
      uint32_t pa[4][4];
      k1h_probs<T>(pa, s_acc, ml, 0, prm.tk, t);
      float l[2];
      if constexpr (SLIM) {
        k1h_issue_pv<T>(acc, pa, tile + 2 * K1H_TILE);
        k1h_row_sum<T>(l, pa);
      } else {
        k1h_issue_pv<T>(acc, pa, tile + 2 * K1H_TILE, ones);
      }
      wg_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      reg_fence(qa);
      mbar_arrive(empty(st));
      if constexpr (!SLIM) {
        l[0] = acc[32];
        l[1] = acc[34];
      }
      k1h_store<T>(o + (size_t)s * prm.tq * 64, 64, acc, l, 16 * wi, prm.tq, lane);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's encoder, found through the runtime so the build needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (bh, t, d) contiguous 16-bit rows as a 3-D map with (64, 64, 1) boxes; a
// d = 128 row is two boxes, each a swizzled 8 KB tile
bool k1h_map(CUtensorMap* map, const void* ptr, int t, int bh, CUtensorMapDataType dt,
             int d = 64) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (b, t, ld) 16-bit rows holding `heads` blocks of 64 columns each, as a 4-D
// map (64, heads, t, b) with (64, 1, 64, 1) boxes: the same 8 KB tile.  t is
// a dimension of its own, so a box past t is zero-filled and never reads the
// next batch; so is heads, so a view of a fused qkv activation (ld = 3 *
// heads * 64) never reads its neighbour's columns.  ld * 2 bytes must be a
// multiple of 16, as the base address must.
bool k1h_map_packed(CUtensorMap* map, const void* ptr, int t, int b, int heads, int ld,
                    CUtensorMapDataType dt) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)heads, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {128, (cuuint64_t)ld * 2, (cuuint64_t)t * ld * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct K1HMaps {
  CUtensorMap q, k, v;
};

// one persistent CTA per SM (fewer when there are fewer slices)
template <typename Kernel>
cudaError_t k1h_launch(Kernel kernel, size_t smem_bytes, const K1HMaps& maps,
                       const K1HParams& prm, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = prm.bh < sms ? prm.bh : sms;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, K1H_THREADS, smem_bytes, stream>>>(maps.q, maps.k, maps.v, prm);
  return cudaGetLastError();
}

// shared memory of the time route: alignment slack, a q tile per consumer,
// nch k and v tiles, 2 KB of ones, the barriers (one more a chunk with rope)
size_t k1h_time_bytes(int nch, bool rope = false) {
  return 1024 + (K1H_CONS + 2 * (size_t)nch) * K1H_TILE + 2048 +
         8 * (2 * K1H_CONS + 1 + (rope ? 3 : 2) * (size_t)nch);
}

// of the band route: alignment slack, the ring, 2 KB of ones unless SLIM, the
// barriers
template <bool SLIM>
constexpr size_t k1h_band_bytes() {
  return 1024 + 3 * (size_t)K1H_STAGES * K1H_TILE + (SLIM ? 0 : 2048) + 16 * K1H_STAGES;
}

// contiguous (bh, t, 64) tensors: K1's two routes, and K6 (slim) on the band
// route
template <typename T>
cudaError_t k1h_run(const void* q, const void* k, const void* v, const K1HParams& prm, bool band,
                    bool slim, CUtensorMapDataType dt, cudaStream_t stream) {
  K1HMaps maps;
  if (!k1h_map(&maps.q, q, prm.tq, prm.bh, dt) || !k1h_map(&maps.k, k, prm.tk, prm.bh, dt) ||
      !k1h_map(&maps.v, v, prm.tk, prm.bh, dt))
    return cudaErrorInvalidValue;
  if (!band)
    return k1h_launch(k1h_time_kernel<T, false>, k1h_time_bytes(prm.nch), maps, prm, stream);
  if (slim)
    return k1h_launch(k1h_band_kernel<T, true>, k1h_band_bytes<true>(), maps, prm, stream);
  return k1h_launch(k1h_band_kernel<T, false>, k1h_band_bytes<false>(), maps, prm, stream);
}

// contiguous (bh, t, 64) tensors through rope: K3 on the time route
template <typename T>
cudaError_t k1h_run_rope(const void* q, const void* k, const void* v, const K1HParams& prm,
                         CUtensorMapDataType dt, cudaStream_t stream) {
  K1HMaps maps;
  if (!k1h_map(&maps.q, q, prm.tq, prm.bh, dt) || !k1h_map(&maps.k, k, prm.tk, prm.bh, dt) ||
      !k1h_map(&maps.v, v, prm.tk, prm.bh, dt))
    return cudaErrorInvalidValue;
  return k1h_launch(k1h_time_kernel<T, false, true>, k1h_time_bytes(prm.nch, true), maps, prm,
                    stream);
}

// packed (b, t, ld) rows: K7 on the time route
template <typename T>
cudaError_t k1h_run_packed(const void* q, const void* k, const void* v, const K1HParams& prm,
                           int b, int ld, CUtensorMapDataType dt, cudaStream_t stream) {
  K1HMaps maps;
  if (!k1h_map_packed(&maps.q, q, prm.tq, b, prm.heads, ld, dt) ||
      !k1h_map_packed(&maps.k, k, prm.tk, b, prm.heads, ld, dt) ||
      !k1h_map_packed(&maps.v, v, prm.tk, b, prm.heads, ld, dt))
    return cudaErrorInvalidValue;
  return k1h_launch(k1h_time_kernel<T, true>, k1h_time_bytes(prm.nch), maps, prm, stream);
}

// ------------------------------------------------------------------ K2

constexpr int K2_THREADS = 128;
constexpr int K2_BK = 64;        // keys per staged tile
constexpr int K2_DPT = 16;       // head dims held by one thread
constexpr float K2_NEG = -1e30f; // the TPU kernel's mask value

template <int TPR>
__host__ __device__ constexpr int k2_rows() { return K2_THREADS / TPR; }

template <int TPR>
size_t k2_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)K2_BK * d + (size_t)k2_rows<TPR>() * (K2_BK + 1));
}

template <typename T, int TPR>
__global__ void __launch_bounds__(K2_THREADS)
k2_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int tq, int tk, int d, float scale, int causal) {
  constexpr int ROWS = k2_rows<TPR>();
  extern __shared__ __align__(16) float sm2[];
  float* ks = sm2;
  float* vs = ks + K2_BK * d;
  float* ss = vs + K2_BK * d;  // (ROWS, K2_BK + 1) scores

  const int sl = blockIdx.x;
  const int row = threadIdx.x / TPR, part = threadIdx.x - row * TPR;
  const int qi = blockIdx.y * ROWS + row;
  const int d0 = part * K2_DPT;
  const T* qg = q + (size_t)sl * tq * d;
  const T* kg = k + (size_t)sl * tk * d;
  const T* vg = v + (size_t)sl * tk * d;

  float qr[K2_DPT], acc[K2_DPT];
#pragma unroll
  for (int c = 0; c < K2_DPT; ++c) {
    const bool ok = qi < tq && d0 + c < d;
    qr[c] = ok ? to_f<T>(qg[(size_t)qi * d + d0 + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = K2_NEG, l = 0.f;
  const int offset = tk - tq;
  int kend = tk;
  if (causal) {  // tiles wholly above the diagonal of this CTA's last row are skipped
    const int last = (blockIdx.y + 1) * ROWS - 1 + offset;
    kend = min(tk, max(last + 1, 0));
  }

  for (int k0 = 0; k0 < kend; k0 += K2_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < K2_BK * d; i += K2_THREADS) {
      const int j = i / d, c = i - j * d;
      const bool ok = k0 + j < tk;
      ks[i] = ok ? to_f<T>(kg[(size_t)(k0 + j) * d + c]) : 0.f;
      vs[i] = ok ? to_f<T>(vg[(size_t)(k0 + j) * d + c]) : 0.f;
    }
    __syncthreads();

    float mt = K2_NEG;
    for (int j = 0; j < K2_BK; ++j) {
      const float* kr = ks + j * d + d0;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < K2_DPT; ++c)
        if (d0 + c < d) s = fmaf(qr[c], kr[c], s);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      const int key = k0 + j;
      const bool valid = key < tk && (!causal || key <= qi + offset);
      s = valid ? s : K2_NEG;
      if (part == 0) ss[row * (K2_BK + 1) + j] = s;
      mt = fmaxf(mt, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < K2_DPT; ++c) acc[c] *= alpha;
    for (int j = 0; j < K2_BK; ++j) {
      const float p = expf(ss[row * (K2_BK + 1) + j] - m_new);
      l += p;
      const float pr = to_f<T>(from_f<T>(p));  // p.astype(v.dtype)
      const float* vr = vs + j * d + d0;
#pragma unroll
      for (int c = 0; c < K2_DPT; ++c)
        if (d0 + c < d) acc[c] = fmaf(pr, vr[c], acc[c]);
    }
    m = m_new;
    __syncwarp();
  }

  if (qi < tq) {
    const float den = l > 0.f ? l : 1.f;
    T* og = o + ((size_t)sl * tq + qi) * d;
#pragma unroll
    for (int c = 0; c < K2_DPT; ++c)
      if (d0 + c < d) og[d0 + c] = from_f<T>(acc[c] / den);
  }
}

template <typename T, int TPR>
cudaError_t k2_launch(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                      int tk, int d, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = k2_smem_bytes<TPR>(d);
  cudaError_t err = cudaFuncSetAttribute(k2_kernel<T, TPR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  constexpr int ROWS = k2_rows<TPR>();
  dim3 grid(bh, (tq + ROWS - 1) / ROWS);
  k2_kernel<T, TPR><<<grid, K2_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), tq, tk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t k2_dispatch(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                        int tk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 16) return k2_launch<T, 1>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (d <= 32) return k2_launch<T, 2>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (d <= 64) return k2_launch<T, 4>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (d <= 128) return k2_launch<T, 8>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (d <= 256) return k2_launch<T, 16>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ K2 on Hopper

// One CTA per (slice, 128 query rows): the producer thread streams 64-key K
// and V tiles through a ring of K2H_STAGES stages, the two consumer
// warpgroups take 64 query rows each and share every tile.
constexpr int K2H_STAGES = 4;
constexpr int K2H_BQ = 64 * K1H_CONS;

struct K2HParams {
  void* o;
  int tq, tk;
  float scale_log2;  // scale * log2 e: one fp32 multiply ahead of exp2
  int causal;
};

// a 64-row tile of d columns: d / 64 swizzled 8 KB sub-tiles, one TMA box each
template <int D>
__host__ __device__ constexpr int k2h_tile_bytes() { return (D / 64) * K1H_TILE; }

// alignment slack, a q tile per consumer, the ring (k and v tile a stage),
// the barriers: q full[CONS], k full, v full and empty per stage
template <int D> constexpr size_t k2h_smem_bytes() {
  return 1024 + (K1H_CONS + 2 * K2H_STAGES) * (size_t)k2h_tile_bytes<D>() +
         8 * (K1H_CONS + 3 * K2H_STAGES);
}

__device__ __forceinline__ uint32_t k2h_k_full(uint32_t bars, int st) {
  return bars + 8 * (K1H_CONS + st);
}
__device__ __forceinline__ uint32_t k2h_v_full(uint32_t bars, int st) {
  return bars + 8 * (K1H_CONS + K2H_STAGES + st);
}
__device__ __forceinline__ uint32_t k2h_empty(uint32_t bars, int st) {
  return bars + 8 * (K1H_CONS + 2 * K2H_STAGES + st);
}

// rows [row, row + 64) of slice s, all d columns, into the tile at dst
template <int D>
__device__ __forceinline__ void k2h_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int s) {
#pragma unroll
  for (int sub = 0; sub < D / 64; ++sub)
    tma_load_tile(dst + sub * K1H_TILE, map, bar, row, s, 64 * sub);
}

// the 64 columns from 64 * sub on of a flat 64 x D accumulator
template <int N>
__device__ __forceinline__ float (&k2h_half(float (&o)[N], int sub))[32] {
  return *reinterpret_cast<float(*)[32]>(&o[32 * sub]);
}

// o += p . v over one 64-key tile, v MN-major in D / 64 swizzled sub-tiles of
// 64 columns: one m64n64k16 (d = 64) or m64n128k16 (d = 128, the second
// sub-tile found through the descriptor's leading offset) a key step
template <typename T, int N>
__device__ __forceinline__ void k2h_issue_pv(float (&o)[N], const uint32_t (&pa)[4][4],
                                             uint32_t vtile) {
  reg_fence(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 32)
      Wgmma<T, 1>::rs(o, pa[kk], sw128_desc(vtile + kk * 2048, 1, 64), 1);
    else
      WgmmaN128<T>::rs(o, pa[kk], sw128_desc(vtile + kk * 2048, K1H_TILE >> 4, 64), 1);
  }
  wg_commit();
}

// s = q . k^T with q read from its swizzled tile in shared memory (the SS
// form): no q fragments in registers
template <typename T, int D>
__device__ __forceinline__ void k2h_issue_scores(float (&s)[32], uint32_t qtile,
                                                 uint32_t ktile) {
  reg_fence(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * K1H_TILE + (kk & 3) * 32;
    WgmmaSS<T, 0>::ss(s, sw128_desc(qtile + off, 1, 64), sw128_desc(ktile + off, 1, 64), kk > 0);
  }
  wg_commit();
}

// One tile of the online softmax on a thread's 2 x 16 scores, in the log2
// domain (c = scale * log2 e >= 0): keys past lim[row] masked (MASK = false
// for a tile every row sees whole), the running max m, alpha = exp2(m_prev -
// m_new), l = l * alpha + sum of the fp32 p (this thread's share; the quad is
// summed at the end), and p rounded to T in A fragments for p.v.  The max is
// taken over the raw scores (rounding s * c is monotonic for c >= 0, so
// max(s * c) = max(s) * c exactly) and s * c - m is one fused multiply-add.
// A masked score is -1e30 and never -inf: its p is exp2(-1e30 - m), which is
// 0, or 1 in a row that has seen no key yet (m = -1e30), as in the TPU
// kernel, and nothing becomes NaN.  s is only read: a write to a product's
// accumulator registers while another product is in flight makes ptxas
// serialise them (C7515).
template <typename T, bool MASK>
__device__ __forceinline__ void k2h_softmax(uint32_t (&pa)[4][4], const float (&s)[32],
                                            float (&m)[2], float (&l)[2], float (&alpha)[2],
                                            float c, int k0, const int (&lim)[2], int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!MASK || k0 + 8 * j + 2 * t + (e & 1) <= lim[e >> 1])
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float pm[2];  // p of a masked key
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], quad_max(mx[h]) * c);
    alpha[h] = ex2(m[h] - mn);
    m[h] = mn;
    l[h] *= alpha[h];
    if (MASK) pm[h] = ex2(K2_NEG - mn);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = 8 * kk + 2 * i, h = i & 1;
      const int key = k0 + 16 * kk + 8 * (i >> 1) + 2 * t;
      float p0 = ex2(fmaf(s[idx], c, -m[h])), p1 = ex2(fmaf(s[idx + 1], c, -m[h]));
      if (MASK) {
        p0 = key <= lim[h] ? p0 : pm[h];
        p1 = key + 1 <= lim[h] ? p1 : pm[h];
      }
      l[h] += p0 + p1;
      pa[kk][i] = pack2<T>(p0, p1);
    }
}

// Key tile j of a consumer warpgroup.  On entry tile j's scores (sc) are
// complete and tile j - 1's p.v (reading pp, writing acc) may be in flight.
// Tile j + 1's scores (sn) are issued before this tile's softmax, so both run
// under it; this tile's p.v runs under the next tile's softmax.  acc is
// rescaled by alpha with no product in flight: the wait ahead of it costs
// little, since tile j + 1's scores have had the whole softmax to finish.
template <typename T, int D>
__device__ __forceinline__ void k2h_step(int j, int nt, float (&sc)[32], float (&sn)[32],
                                         uint32_t (&pc)[4][4], uint32_t (&pp)[4][4],
                                         float (&acc)[D / 2], uint32_t qtile, float (&m)[2],
                                         float (&l)[2], uint32_t ring, uint32_t bars, float c,
                                         int free_keys, const int (&lim)[2], int t) {
  constexpr int TILE = k2h_tile_bytes<D>();
  const int st = j % K2H_STAGES;
  if (j + 1 < nt) {
    const int st1 = (j + 1) % K2H_STAGES;
    mbar_wait(k2h_k_full(bars, st1), ((j + 1) / K2H_STAGES) & 1);
    k2h_issue_scores<T, D>(sn, qtile, ring + 2 * st1 * TILE);
  }
  float alpha[2];
  if (64 * (j + 1) <= free_keys)
    k2h_softmax<T, false>(pc, sc, m, l, alpha, c, 64 * j, lim, t);
  else
    k2h_softmax<T, true>(pc, sc, m, l, alpha, c, 64 * j, lim, t);
  wg_wait<0>();  // p.v of tile j - 1, and scores j + 1
  reg_fence(sn);
  reg_fence(acc);
  reg_fence(pp);
  if (j > 0) mbar_arrive(k2h_empty(bars, (j - 1) % K2H_STAGES));  // k and v of tile j - 1
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
  mbar_wait(k2h_v_full(bars, st), (j / K2H_STAGES) & 1);
  k2h_issue_pv<T>(acc, pc, ring + (2 * st + 1) * TILE);
}

template <typename T, int D>
__global__ void __launch_bounds__(K1H_THREADS, 1)
k2h_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, const K2HParams prm) {
  constexpr int TILE = k2h_tile_bytes<D>();
  extern __shared__ unsigned char k1h_smem[];
  const uint32_t qbuf = k1h_align(k1h_smem);         // a tile per consumer
  const uint32_t ring = qbuf + K1H_CONS * TILE;      // stage st: k tile 2 st, v tile 2 st + 1
  const uint32_t bars = ring + 2 * K2H_STAGES * TILE;
  auto q_full = [&](int w) { return bars + 8 * w; };

  if (threadIdx.x == 0) {
    for (int w = 0; w < K1H_CONS; ++w) mbar_init(q_full(w), 1);
    for (int st = 0; st < K2H_STAGES; ++st) {
      mbar_init(k2h_k_full(bars, st), 1);
      mbar_init(k2h_v_full(bars, st), 1);
      mbar_init(k2h_empty(bars, st), 128 * K1H_CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the last query tiles first: under causal they see the most keys
  const int s = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * K2H_BQ;
  const int tq = prm.tq, tk = prm.tk, offset = tk - tq;
  // 64-key tiles warpgroup w consumes: none when its rows lie past tq; under
  // causal, tiles wholly above the diagonal of its last row are skipped
  auto tiles_of = [&](int w) {
    const int r0 = q0 + 64 * w;
    if (r0 >= tq) return 0;
    const int kend = prm.causal ? min(tk, max(r0 + 63 + offset + 1, 0)) : tk;
    return (kend + 63) / 64;
  };
  const int nt_cta = max(tiles_of(0), tiles_of(1));

  const int wg = threadIdx.x >> 7;
  if (wg == K1H_CONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(K1H_PRODUCER_REGS) : "memory");
    if (threadIdx.x == 128 * K1H_CONS) {
      for (int w = 0; w < K1H_CONS; ++w)
        if (tiles_of(w) > 0) {
          mbar_expect_tx(q_full(w), TILE);
          k2h_load_rows<D>(qbuf + w * TILE, &mq, q_full(w), q0 + 64 * w, s);
        }
      for (int j = 0; j < nt_cta; ++j) {
        const int st = j % K2H_STAGES;
        if (j >= K2H_STAGES) mbar_wait(k2h_empty(bars, st), (j / K2H_STAGES - 1) & 1);
        mbar_expect_tx(k2h_k_full(bars, st), TILE);
        k2h_load_rows<D>(ring + 2 * st * TILE, &mk, k2h_k_full(bars, st), 64 * j, s);
        mbar_expect_tx(k2h_v_full(bars, st), TILE);
        k2h_load_rows<D>(ring + (2 * st + 1) * TILE, &mv, k2h_v_full(bars, st), 64 * j, s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(K1H_CONSUMER_REGS) : "memory");
    const int wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int nt = tiles_of(wg);
    const int r0 = q0 + 64 * wg;  // the warpgroup's first row
    float acc[D / 2];  // element 4 j + e: column 8 j + 2 t + (e & 1), as K1's
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m[2] = {K2_NEG, K2_NEG}, l[2] = {0.f, 0.f};
    if (nt > 0) {
      // keys every row of the warpgroup sees: tiles below take no mask; and
      // the last key each of this thread's two rows sees
      const int free_keys = prm.causal ? min(tk, r0 + offset + 1) : tk;
      const int row = r0 + 16 * wi + (lane >> 2);
      const int lim[2] = {prm.causal ? min(tk - 1, row + offset) : tk - 1,
                          prm.causal ? min(tk - 1, row + 8 + offset) : tk - 1};
      const uint32_t qtile = qbuf + wg * TILE;
      mbar_wait(q_full(wg), 0);
      float sa[32], sb[32];
      uint32_t pa[4][4], pb[4][4];
      mbar_wait(k2h_k_full(bars, 0), 0);
      k2h_issue_scores<T, D>(sa, qtile, ring);
      wg_wait<0>();
      reg_fence(sa);
      for (int j = 0; j < nt; j += 2) {
        k2h_step<T, D>(j, nt, sa, sb, pa, pb, acc, qtile, m, l, ring, bars, prm.scale_log2,
                       free_keys, lim, lane & 3);
        if (j + 1 >= nt) break;
        k2h_step<T, D>(j + 1, nt, sb, sa, pb, pa, acc, qtile, m, l, ring, bars,
                       prm.scale_log2, free_keys, lim, lane & 3);
      }
      wg_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      reg_fence(pb);
      mbar_arrive(k2h_empty(bars, (nt - 1) % K2H_STAGES));
    }
    // tiles only the other warpgroup consumes (under causal it may see one
    // more): release each once it has landed, which is after the stage's
    // previous release has completed
    for (int j = nt; j < nt_cta; ++j) {
      const int st = j % K2H_STAGES;
      mbar_wait(k2h_k_full(bars, st), (j / K2H_STAGES) & 1);
      mbar_arrive(k2h_empty(bars, st));
    }
    const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
    T* out = static_cast<T*>(prm.o) + (size_t)s * tq * D;
#pragma unroll
    for (int sub = 0; sub < D / 64; ++sub)
      k1h_store<T>(out + 64 * sub, D, k2h_half(acc, sub), lsum, r0 + 16 * wi, tq, lane);
  }
}

template <typename T, int D>
cudaError_t k2h_launch(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                       int tk, float scale, int causal, CUtensorMapDataType dt,
                       cudaStream_t stream) {
  K1HMaps maps;
  if (!k1h_map(&maps.q, q, tq, bh, dt, D) || !k1h_map(&maps.k, k, tk, bh, dt, D) ||
      !k1h_map(&maps.v, v, tk, bh, dt, D))
    return cudaErrorInvalidValue;
  const K2HParams prm{o, tq, tk, scale * K1H_LOG2E, causal};
  constexpr size_t bytes = k2h_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(k2h_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + K2H_BQ - 1) / K2H_BQ);
  k2h_kernel<T, D><<<grid, K1H_THREADS, bytes, stream>>>(maps.q, maps.k, maps.v, prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t k2h_dispatch(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                         int tk, int d, float scale, int causal, CUtensorMapDataType dt,
                         cudaStream_t s) {
  if (d == 64) return k2h_launch<T, 64>(q, k, v, o, bh, tq, tk, scale, causal, dt, s);
  if (d == 128) return k2h_launch<T, 128>(q, k, v, o, bh, tq, tk, scale, causal, dt, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ K2, fp32 inputs

constexpr int K2F_THREADS = 256;
constexpr int K2F_BQ = 64;  // query rows per CTA: 16 row groups of 4

// DP: head dim padded to 64, 128 or 256; VEC: floats per cp.async (4 when
// every row starts on 16 bytes, else 1)
template <int DP>
struct K2FLayout {
  static constexpr int BK = DP <= 128 ? 64 : 32;  // keys per tile
  static constexpr int LD = DP + 4;               // q/k/v row stride (floats)
  static constexpr int LDP = K2F_BQ + 4;          // p^T row stride
  static constexpr int KN = BK / 16;              // keys per thread
  static constexpr int DN = DP / 64;              // float4 output columns per thread
  static constexpr size_t BYTES =
      sizeof(float) * ((size_t)K2F_BQ * LD + 4 * (size_t)BK * LD + (size_t)BK * LDP);
};

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const uint32_t d = smem_u32(dst);
  const int n = ok ? 4 * VEC : 0;  // 0 bytes read: the destination is zero-filled
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

// rows [r0, r0 + rows) of a (t, d) fp32 slice into shared memory (stride LD);
// rows at or past t and columns at or past d are zero
template <int DP, int VEC>
__device__ __forceinline__ void k2f_stage(float* dst, const float* __restrict__ src, int r0,
                                          int rows, int t, int d) {
  constexpr int CPR = DP / VEC;
  for (int i = threadIdx.x; i < rows * CPR; i += K2F_THREADS) {
    const int r = i / CPR, c = (i - r * CPR) * VEC;
    const int g = r0 + r;
    const bool ok = g < t && c < d;
    cp_async<VEC>(dst + r * K2FLayout<DP>::LD + c, ok ? src + (size_t)g * d + c : src, ok);
  }
}

// Thread (tr, tc) = (tid / 16, tid % 16) owns query rows 4tr..4tr+3, keys
// tc + 16j of each tile and output columns 4(tc + 16j')..+3: each value read
// from shared memory feeds 4 FMAs, and the 16 threads of a row group share
// its softmax state through shuffles.
template <int DP, int VEC>
__global__ void __launch_bounds__(K2F_THREADS)
k2f_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, int tq, int tk, int d, float scale, int causal) {
  using L = K2FLayout<DP>;
  constexpr int BK = L::BK, LD = L::LD, LDP = L::LDP, KN = L::KN, DN = L::DN;
  extern __shared__ __align__(16) float k2f_smem[];
  float* qs = k2f_smem;
  float* kvs = qs + K2F_BQ * LD;          // buffer b: k at kvs + 2b*BK*LD, v after it
  float* pt = kvs + 4 * BK * LD;          // p^T: (BK, LDP)

  const int sl = blockIdx.x, q0 = blockIdx.y * K2F_BQ;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* qg = q + (size_t)sl * tq * d;
  const float* kg = k + (size_t)sl * tk * d;
  const float* vg = v + (size_t)sl * tk * d;
  const int offset = tk - tq;
  int kend = tk;
  if (causal) {  // tiles wholly above the diagonal of this CTA's last row are skipped
    const int last = min(q0 + K2F_BQ, tq) - 1 + offset;
    kend = min(tk, max(last + 1, 0));
  }
  const int ntiles = (kend + BK - 1) / BK;

  k2f_stage<DP, VEC>(qs, qg, q0, K2F_BQ, tq, d);
  if (ntiles > 0) {
    k2f_stage<DP, VEC>(kvs, kg, 0, BK, tk, d);
    k2f_stage<DP, VEC>(kvs + BK * LD, vg, 0, BK, tk, d);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float m[4], l[4], acc[4][DN][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = K2_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {  // the next tile streams in while this one computes
      float* nb = kvs + ((it + 1) & 1) * 2 * BK * LD;
      k2f_stage<DP, VEC>(nb, kg, (it + 1) * BK, BK, tk, d);
      k2f_stage<DP, VEC>(nb + BK * LD, vg, (it + 1) * BK, BK, tk, d);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* ks = kvs + (it & 1) * 2 * BK * LD;
    const float* vs = ks + BK * LD;
    const int k0 = it * BK;

    float s[4][KN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qv[4], kv[KN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * tr + i) * LD + dd);
#pragma unroll
      for (int j = 0; j < KN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tc + 16 * j) * LD + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * tr + i;
      float mt = K2_NEG;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int key = k0 + tc + 16 * j;
        const bool valid = key < tk && (!causal || key <= qi + offset);
        s[i][j] = valid ? s[i][j] * scale : K2_NEG;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < DN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        l[i] += s[i][j];
      }
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < KN; ++j)
      *reinterpret_cast<float4*>(pt + (tc + 16 * j) * LDP + 4 * tr) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(pt + key * LDP + 4 * tr);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + key * LD + 4 * (tc + 16 * j));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(pr[i], vv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pr[i], vv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pr[i], vv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pr[i], vv.w, acc[i][j][3]);
        }
      }
    }
    __syncthreads();  // p^T and this tile's buffer are free again
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // q's copy when no tile ran

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qi = q0 + 4 * tr + i;
    if (qi >= tq) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
    float* og = o + ((size_t)sl * tq + qi) * d;
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (tc + 16 * j) + e;
        if (c < d) og[c] = acc[i][j][e] / den;
      }
  }
}

template <int DP, int VEC>
cudaError_t k2f_launch(const float* q, const float* k, const float* v, float* o, int bh, int tq,
                       int tk, int d, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = K2FLayout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(k2f_kernel<DP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + K2F_BQ - 1) / K2F_BQ);
  k2f_kernel<DP, VEC><<<grid, K2F_THREADS, bytes, stream>>>(q, k, v, o, tq, tk, d, scale, causal);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t k2f_dispatch_dp(const float* q, const float* k, const float* v, float* o, int bh,
                            int tq, int tk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 64) return k2f_launch<64, VEC>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (d <= 128) return k2f_launch<128, VEC>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (d <= 256) return k2f_launch<256, VEC>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

cudaError_t k2f_dispatch(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                         int tk, int d, float scale, int causal, cudaStream_t s) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const bool vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  return vec ? k2f_dispatch_dp<4>(qf, kf, vf, of, bh, tq, tk, d, scale, causal, s)
             : k2f_dispatch_dp<1>(qf, kf, vf, of, bh, tq, tk, d, scale, causal, s);
}

// dtype codes shared with audiolab_tpu_torch/kernels/attention.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

template <int V>
int k1_entry(const K1Params& prm, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prm.bh <= 0 || prm.tq <= 0 || prm.tk <= 0 || prm.spc <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16) return (int)k1_dispatch<__nv_bfloat16, V>(prm, d, s);
  if (dtype == DT_F16) return (int)k1_dispatch<__half, V>(prm, d, s);
  return (int)cudaErrorInvalidValue;
}

// K1's Hopper design: d = 64, 16-bit, tk <= 768, contiguous (bh, t, 64) rows
// on 16-byte aligned pointers.  band != 0 takes the band route (tq <= 64 and
// tk <= 64), else the time route.  The wrapper chooses the route by shape.
// slim (band only) is K6: the row sum apart.
int k1h_entry(const void* q, const void* k, const void* v, void* o, int bh, int tq, int tk,
              float scale, int dtype, int band, bool slim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0 || tk <= 0 || tk > 64 * K1H_MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  if (band && (tq > 64 || tk > 64)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const K1HParams prm{o, bh, tq, tk, (tk + 63) / 64, scale, 1, 64};
  if (dtype == DT_BF16)
    return (int)k1h_run<__nv_bfloat16>(q, k, v, prm, band != 0, slim,
                                       CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
  if (dtype == DT_F16)
    return (int)k1h_run<__half>(q, k, v, prm, band != 0, slim,
                                CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int k1_attention_nk1(const void* q, const void* k, const void* v, void* o, int bh,
                                int tq, int tk, int d, float scale, int dtype,
                                int slices_per_cta, void* stream) {
  const K1Params prm{q, k, v, o, nullptr, nullptr, bh, tq, tk, scale, slices_per_cta, 1, d, d};
  return k1_entry<K1_SCALED>(prm, d, dtype, stream);
}

extern "C" int k1_attention_nk1_sm90(const void* q, const void* k, const void* v, void* o, int bh,
                                     int tq, int tk, float scale, int dtype, int band,
                                     void* stream) {
  return k1h_entry(q, k, v, o, bh, tq, tk, scale, dtype, band, false, stream);
}

// K6 on the Hopper band design: d = 64, 16-bit, tq <= 64 and tk <= 64,
// contiguous (bh, t, 64) rows on 16-byte aligned pointers
extern "C" int k6_attention_slim_sm90(const void* q, const void* k, const void* v, void* o,
                                      int bh, int tq, int tk, float scale, int dtype,
                                      void* stream) {
  return k1h_entry(q, k, v, o, bh, tq, tk, scale, dtype, 1, true, stream);
}

// K7 on the Hopper time design: d = 64, 16-bit, t <= 768; q/k/v as for
// k7_attention_packed, on 16-byte aligned pointers with ld_in * 2 bytes a
// multiple of 16; output (b, t, heads*64) contiguous
extern "C" int k7_attention_packed_sm90(const void* q, const void* k, const void* v, void* o,
                                        int b, int heads, int t, int ld_in, float scale,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || heads <= 0 || t <= 0 || t > 64 * K1H_MAX_CHUNKS || ld_in < heads * 64)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0 || ld_in % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  const K1HParams prm{o, b * heads, t, t, (t + 63) / 64, scale, heads, heads * 64};
  if (dtype == DT_BF16)
    return (int)k1h_run_packed<__nv_bfloat16>(q, k, v, prm, b, ld_in,
                                              CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
  if (dtype == DT_F16)
    return (int)k1h_run_packed<__half>(q, k, v, prm, b, ld_in, CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                                       s);
  return (int)cudaErrorInvalidValue;
}

// K3 on the Hopper time design: d = 64, 16-bit, tk <= 768, contiguous
// (bh, t, 64) rows and (>= max(tq, tk), 64) fp32 tables, all on 16-byte
// aligned pointers; scale is folded into q's tables
extern "C" int k3_attention_nk1_rope_sm90(const void* q, const void* k, const void* v, void* o,
                                          const float* cos, const float* sin, int bh, int tq,
                                          int tk, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cos == nullptr || sin == nullptr || bh <= 0 || tq <= 0 || tk <= 0 ||
      tk > 64 * K1H_MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)cos |
       (uintptr_t)sin) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const K1HParams prm{o, bh, tq, tk, (tk + 63) / 64, scale, 1, 64, cos, sin};
  if (dtype == DT_BF16)
    return (int)k1h_run_rope<__nv_bfloat16>(q, k, v, prm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
  if (dtype == DT_F16)
    return (int)k1h_run_rope<__half>(q, k, v, prm, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s);
  return (int)cudaErrorInvalidValue;
}

// K3 on the WMMA core, any head dim of the core.
// cos/sin: (>= max(tq, tk), d) fp32 tables; scale is folded into q's
extern "C" int k3_attention_nk1_rope(const void* q, const void* k, const void* v, void* o,
                                     const float* cos, const float* sin, int bh, int tq, int tk,
                                     int d, float scale, int dtype, int slices_per_cta,
                                     void* stream) {
  if (cos == nullptr || sin == nullptr) return (int)cudaErrorInvalidValue;
  const K1Params prm{q, k, v, o, cos, sin, bh, tq, tk, scale, slices_per_cta, 1, d, d};
  return k1_entry<K1_ROPE>(prm, d, dtype, stream);
}

extern "C" int k6_attention_slim(const void* q, const void* k, const void* v, void* o, int bh,
                                 int tq, int tk, int d, float scale, int dtype,
                                 int slices_per_cta, void* stream) {
  const K1Params prm{q, k, v, o, nullptr, nullptr, bh, tq, tk, scale, slices_per_cta, 1, d, d};
  return k1_entry<K1_SCALED>(prm, d, dtype, stream);
}

// q/k/v: batch b at b*t*ld_in, row i of head h at + i*ld_in + h*d; output
// (b, t, heads*d) contiguous
extern "C" int k7_attention_packed(const void* q, const void* k, const void* v, void* o, int b,
                                   int heads, int t, int d, int ld_in, float scale, int dtype,
                                   void* stream) {
  if (b <= 0 || heads <= 0 || ld_in < heads * d) return (int)cudaErrorInvalidValue;
  const K1Params prm{q, k, v, o, nullptr, nullptr, b * heads, t, t, scale, 1, heads, ld_in,
                     heads * d};
  return k1_entry<K1_PACKED>(prm, d, dtype, stream);
}

// K2 on the Hopper design: d = 64 or 128, 16-bit, scale >= 0, contiguous
// (bh, t, d) rows on 16-byte aligned pointers
extern "C" int k2_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                       int bh, int tq, int tk, int d, float scale, int causal,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // scale >= 0: the kernel takes the row max over the raw scores
  if (bh <= 0 || tq <= 0 || tk <= 0 || (tq + K2H_BQ - 1) / K2H_BQ > 65535 || !(scale >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (dtype == DT_BF16)
    return (int)k2h_dispatch<__nv_bfloat16>(q, k, v, o, bh, tq, tk, d, scale, causal,
                                            CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
  if (dtype == DT_F16)
    return (int)k2h_dispatch<__half>(q, k, v, o, bh, tq, tk, d, scale, causal,
                                     CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s);
  return (int)cudaErrorInvalidValue;
}

// K2 off the Hopper design: fp32 inputs on k2f_kernel, 16-bit ones on the
// row-per-thread-group k2_kernel, any head dim up to 256
extern "C" int k2_flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                                  int tq, int tk, int d, float scale, int causal, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) return (int)k2f_dispatch(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (dtype == DT_BF16)
    return (int)k2_dispatch<__nv_bfloat16>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (dtype == DT_F16)
    return (int)k2_dispatch<__half>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
