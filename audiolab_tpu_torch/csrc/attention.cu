// Attention kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// K1  k1_attention_nk1       replaces audiolab_tpu/kernels/attention.py
//                            ::_flash_kernel_nk1 (single-KV-block, non-causal).
// K2  k2_flash_attention     replaces audiolab_tpu/kernels/attention.py
//                            ::_flash_kernel (online softmax over KV tiles,
//                            key-length mask, optional causal mask).
// K3  k3_attention_nk1_rope  replaces audiolab_tpu/kernels/attention.py
//                            ::_flash_kernel_nk1_rope (K1 with half-split rope
//                            fused onto the q and k tiles).
// K6  k6_attention_slim      replaces tools/probe_freq_bh128.py::_nk1_slim
//                            (K1 with the row sum as a separate fp32 reduction).
// K7  k7_attention_packed    replaces tools/probe_packed_attn.py::_packed_kernel
//                            (K1 reading q/k/v from the packed (b, t, h*d)
//                            layout and writing the output in it).
//
// Every entry point takes device pointers and a CUDA stream, launches on
// that stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// K1, K2, K3 and K6 take contiguous (slices, t, d) tensors; K7 takes
// (b, t, row stride) rows, see below.
//
// K1 — bound and design.
//   Work at the RoFormer shapes (bf16): time axis 3968 slices x 690 x 64,
//   4*3968*690^2*64 = 4.84e11 FLOP over 1.40e9 bytes, so it is bound by
//   tensor-core operations (989 TFLOP/s bf16: 0.49 ms; bytes: 0.42 ms).
//   Band axis 44,160 slices x 62 x 64: 4.35e10 FLOP over 1.40e9 bytes, bound
//   by bytes (0.42 ms at 3.35 TB/s).
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
// K3, K6 and K7 are K1's core (k1_kernel) with one thing changed, chosen at
// compile time by its variant, so K1's own instance is unchanged:
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
//     reduction over the rounded p.  On the card K1 already sums the rounded
//     p that way (WMMA has no idle lanes to fill), so K6's function runs in
//     K1's scaled instance.  What the probe asked (fold twice the slices per
//     TPU grid step) is the entry's slices_per_cta, which the wrapper sets
//     to twice K1's.  Bound: bytes, like K1's band axis.
//   K7 (K1_PACKED): slice (batch, head) of q/k/v lives at rows of stride
//     ld_in elements (heads*d for a packed tensor, 3*heads*d for a view of a
//     fused qkv activation), starting at batch*t*ld_in + head*d; the output
//     is written at stride heads*d in the same layout, so no transpose pass
//     runs on either side.  A d = 64 bf16 row is 128 contiguous bytes, so
//     the staging loads stay coalesced.  One CTA per (batch, head, 64-row
//     query tile); the ragged query tail is masked (the TPU needed bq | t).
//     Same bound as K1 on the time axis.
//
// K2 — bound and design.
//   HuBERT (fp32): 96 slices x 399 x 64: 4*96*399^2*64 = 3.9e9 FLOP over
//   3.9e7 bytes; in fp32 outside the tensor cores (67 TFLOP/s) that is
//   0.058 ms, bound by operations.
//   Online softmax as on the TPU: m, l and acc in fp32; keys at or past
//   kv_len masked to -1e30; causal mask key <= query + (tk - tq); KV tiles
//   entirely above the diagonal skipped; l <= 0 -> 1.  As in the TPU kernel
//   the row sum takes the unrounded p and the numerator takes p rounded to
//   v's type.  Scalar fp32 FMAs (fp32 inputs must keep fp32 products):
//   TPR threads share one query row, each holding 16 of its dims, and
//   reduce the q.k dot product with warp shuffles.  64-key tiles of K and V
//   are staged in shared memory as fp32.

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

}  // namespace

extern "C" int k1_attention_nk1(const void* q, const void* k, const void* v, void* o, int bh,
                                int tq, int tk, int d, float scale, int dtype,
                                int slices_per_cta, void* stream) {
  const K1Params prm{q, k, v, o, nullptr, nullptr, bh, tq, tk, scale, slices_per_cta, 1, d, d};
  return k1_entry<K1_SCALED>(prm, d, dtype, stream);
}

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

extern "C" int k2_flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                                  int tq, int tk, int d, float scale, int causal, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return (int)k2_dispatch<float>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (dtype == DT_BF16)
    return (int)k2_dispatch<__nv_bfloat16>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  if (dtype == DT_F16)
    return (int)k2_dispatch<__half>(q, k, v, o, bh, tq, tk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
