// K2 (forward) and K3 (backward) for Hopper (sm_90a): softmax attention over
// the interleaved QKV projection [B, T, H*3*HD] (column group h is
// [q_h | k_h | v_h]) with prefix key lengths and an optional causal mask.
//
// Replaces musicstyletransfer_tpu/ops/attention_core.py: K2 is _core_forward
// (Pallas kernel _core_fwd_kernel), K3 is _core_backward (_core_bwd_kernel).
// Re-thought for the card rather than carried over block by block. The TPU
// kernel holds one (row, head group)'s whole [T, T] float32 score tile in
// VMEM, 1 MB at T=514; a block here has at most 227 KB of shared memory. So:
//
// - K2 (core_fwd_kernel): one block per (64-query tile, head, row); it walks
//   32-key tiles held in shared memory with an online softmax (running max m
//   and sum l, the context rescaled when m grows) and still emits the
//   lse = m + log l that K3 reads. Key tiles past key_lens (and, causal,
//   past the query tile) are skipped.
// - K3 is two kernels that each recompute P = exp(S - lse) from the saved
//   lse: core_bwd_dq_kernel (per query tile: delta = rowsum(dO * O), saved
//   for the next kernel, then dQ) and core_bwd_dkdv_kernel (per key tile:
//   dK and dV, walking the query tiles). No atomics, no [T, T] array.
// - Head groups (_head_group, Mosaic lane tiling) are dropped: one head per
//   block. A query (or key) row belongs to TPR = max(1, HD/32) neighbouring
//   threads that hold 32 (or HD) of its dimensions in registers and meet in
//   warp shuffles; the tiles in shared memory are float32, the row pieces
//   padded apart so the TPR threads read different banks.
// - Arithmetic is CUDA-core float32 FMA. The backward must be float32
//   throughout, and the forward's scores are float32 sums of exact products
//   of the inputs, so this matches the reference's rounding. bfloat16 at
//   HD 32 or 64, every core launch of the wide recipe, runs on the tensor
//   cores instead (the core's entry points of flash_attention_tc.cu, chosen
//   by attention_core.core_route); this file keeps float32 and the other
//   head dimensions.
//
// What bounds it: at the wide training shapes (B=8, H=16, T=513 with HD=64
// non-causal, T=514 with HD=32 causal, bf16) an encoder call moves 34 MB
// forward (qkv read, ctx and lse written) and 67 MB backward (qkv, ctx, dO
// read, dqkv written): 10 / 20 us at 3.35 TB/s. It needs 4*HD (forward) or
// 10*HD (backward) flops per unmasked (query, key) pair: at full key
// lengths 8.6 / 21.6 GFLOP, 8.7 / 21.8 us at the 989 TFLOP/s bf16 peak. The
// two bounds are about equal (bytes ahead at a corpus batch's shorter key
// lengths). On CUDA cores (67 TFLOP/s float32 peak) this kernel cannot come
// nearer than ~15x that bound; PERF.md has its times.
//
// Rounding points of the reference (kept): q * sm_scale rounded to the qkv
// type (the scale itself rounded to that type first, as jnp.asarray(scale,
// dtype) does); scores in float32; masked scores -1e30; p rounded to the v
// type before P.V; o / max(l, 1e-30); fully masked rows give zeros and the
// lse sentinel -1e30; the backward all in float32 (q * sm_scale in float32,
// ds = p * (dp - delta), dq scaled at the end, dk from the pre-scaled q).
// Where p is 0 the backward adds nothing, so cotangents of 1e19 stay finite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_core_args.cuh"

namespace {

constexpr int kRows = 64;   // query (or key) rows a block owns
constexpr int kTile = 32;   // keys (or queries) per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kSentinel = -1e29f;  // lse at or below it: a fully masked row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// Row layout: TPR threads per row, DPT dimensions each; in shared memory a
// row's pieces sit PAD floats apart (stride RS floats a row).
template <int HD> struct Layout {
  static constexpr int TPR = HD > 32 ? HD / 32 : 1;
  static constexpr int DPT = HD / TPR;
  static constexpr int PAD = TPR > 1 ? 4 : 0;
  static constexpr int RS = TPR * (DPT + PAD);
  static constexpr int kThreads = kRows * TPR;
  __device__ static int offset(int row, int d) { return row * RS + (d / DPT) * (DPT + PAD) + d % DPT; }
};

// Sum over the TPR neighbouring threads of one row (every thread gets it).
template <int TPR> __device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fill a [kTile, HD] float tile from `rows` (row stride W elements), rows
// at or past `end` as zeros; `scale` multiplies every value.
template <typename T, int HD>
__device__ void load_tile(float* tile, const T* rows, int first, int end, int W, float scale) {
  using L = Layout<HD>;
  for (int e = threadIdx.x; e < kTile * HD; e += L::kThreads) {
    const int j = e / HD, d = e % HD, row = first + j;
    tile[L::offset(j, d)] = row < end ? to_f(rows[(size_t)row * W + d]) * scale : 0.f;
  }
}

// ----------------------------------------------------------------------------
// K2: forward. grid (ceil(T/kRows), H, B).

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads) core_fwd_kernel(MstCoreArgs a) {
  using L = Layout<HD>;
  constexpr int TPR = L::TPR, DPT = L::DPT;
  __shared__ float ks[kTile * L::RS], vs[kTile * L::RS];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, qpos = q0 + r;
  const int Tn = a.T, W = a.H * 3 * HD;
  const T* base = static_cast<const T*>(a.qkv) + (size_t)b * Tn * W + h * 3 * HD;
  const int valid = min(max(a.key_lens[b], 0), Tn);
  const bool live = qpos < Tn;

  float q[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = live ? rnd<T>(to_f(base[(size_t)qpos * W + part * DPT + i]) * a.fwd_scale) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int kend = a.causal ? min(valid, min(Tn, q0 + kRows)) : valid;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    load_tile<T, HD>(ks, base + HD, k0, Tn, W, 1.f);
    load_tile<T, HD>(vs, base + 2 * HD, k0, Tn, W, 1.f);
    __syncthreads();
    float s[kTile];
    uint32_t ok = 0;
    float mt = m;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float* kr = ks + j * L::RS + part * (DPT + L::PAD);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot = fmaf(q[i], kr[i], dot);
      dot = row_sum<TPR>(dot);
      const int kp = k0 + j;
      const bool okj = kp < valid && (!a.causal || kp <= qpos);
      s[j] = okj ? dot : kNegInf;
      ok |= okj ? 1u << j : 0u;
      mt = fmaxf(mt, s[j]);
    }
    const float alpha = expf(m - mt);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (!((ok >> j) & 1u)) continue;
      const float p = expf(s[j] - mt);
      l += p;
      const float pr = rnd<T>(p);
      const float* vr = vs + j * L::RS + part * (DPT + L::PAD);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pr, vr[i], acc[i]);
    }
    m = mt;
    __syncthreads();
  }
  if (!live) return;
  const float lm = fmaxf(l, 1e-30f);
  T* out = static_cast<T*>(a.out) + ((size_t)b * Tn + qpos) * a.H * HD + h * HD + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) out[i] = from_f<T>(acc[i] / lm);
  if (part == 0) a.lse[((size_t)b * a.H + h) * Tn + qpos] = m + logf(lm);
}

// ----------------------------------------------------------------------------
// K3, first kernel: delta and dQ. grid (ceil(T/kRows), H, B).

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads) core_bwd_dq_kernel(MstCoreArgs a) {
  using L = Layout<HD>;
  constexpr int TPR = L::TPR, DPT = L::DPT;
  __shared__ float ks[kTile * L::RS], vs[kTile * L::RS];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, qpos = q0 + r;
  const int Tn = a.T, W = a.H * 3 * HD, Wo = a.H * HD;
  const T* base = static_cast<const T*>(a.qkv) + (size_t)b * Tn * W + h * 3 * HD;
  const int valid = min(max(a.key_lens[b], 0), Tn);
  const bool live = qpos < Tn;
  const size_t orow = ((size_t)b * Tn + qpos) * Wo + h * HD + part * DPT;
  const size_t lrow = ((size_t)b * a.H + h) * Tn + qpos;

  float q[DPT], dout[DPT], dq[DPT];
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = live ? to_f(base[(size_t)qpos * W + part * DPT + i]) * a.bwd_scale : 0.f;
    dout[i] = live ? to_f(static_cast<const T*>(a.dout)[orow + i]) : 0.f;
    const float o = live ? to_f(static_cast<const T*>(a.out)[orow + i]) : 0.f;
    dsum = fmaf(dout[i], o, dsum);
    dq[i] = 0.f;
  }
  const float delta = row_sum<TPR>(dsum);
  const float lse = live ? a.lse[lrow] : kNegInf;
  if (live && part == 0) a.delta[lrow] = delta;
  const bool row_ok = lse > kSentinel;

  const int kend = a.causal ? min(valid, min(Tn, q0 + kRows)) : valid;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    load_tile<T, HD>(ks, base + HD, k0, Tn, W, 1.f);
    load_tile<T, HD>(vs, base + 2 * HD, k0, Tn, W, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float* kr = ks + j * L::RS + part * (DPT + L::PAD);
      const float* vr = vs + j * L::RS + part * (DPT + L::PAD);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        s = fmaf(q[i], kr[i], s);
        dp = fmaf(dout[i], vr[i], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const int kp = k0 + j;
      const bool okj = row_ok && kp < valid && (!a.causal || kp <= qpos);
      const float ds = okj ? expf(s - lse) * (dp - delta) : 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dq[i] = fmaf(ds, kr[i], dq[i]);
    }
    __syncthreads();
  }
  if (!live) return;
  T* dqkv = static_cast<T*>(a.dqkv) + ((size_t)b * Tn + qpos) * W + h * 3 * HD + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) dqkv[i] = from_f<T>(dq[i] * a.bwd_scale);
}

// ----------------------------------------------------------------------------
// K3, second kernel: dK and dV. grid (ceil(T/kRows), H, B); a block owns 64
// keys and walks the query tiles that can see them.

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads) core_bwd_dkdv_kernel(MstCoreArgs a) {
  using L = Layout<HD>;
  constexpr int TPR = L::TPR, DPT = L::DPT;
  __shared__ float qs[kTile * L::RS], dos[kTile * L::RS];
  __shared__ float lses[kTile], deltas[kTile];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kRows;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, kpos = k0 + r;
  const int Tn = a.T, W = a.H * 3 * HD, Wo = a.H * HD;
  const T* base = static_cast<const T*>(a.qkv) + (size_t)b * Tn * W + h * 3 * HD;
  const T* dout = static_cast<const T*>(a.dout) + (size_t)b * Tn * Wo + h * HD;
  const float* lse = a.lse + ((size_t)b * a.H + h) * Tn;
  const float* delta = a.delta + ((size_t)b * a.H + h) * Tn;
  const int valid = min(max(a.key_lens[b], 0), Tn);
  const bool live = kpos < Tn, key_ok = kpos < valid;

  float k[DPT], v[DPT], dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    k[i] = live ? to_f(base[(size_t)kpos * W + HD + part * DPT + i]) : 0.f;
    v[i] = live ? to_f(base[(size_t)kpos * W + 2 * HD + part * DPT + i]) : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  // Keys at or past key_lens get nothing; causal queries before k0 see none
  // of this block's keys.
  const int qbegin = k0 < valid ? (a.causal ? k0 : 0) : Tn;
  for (int i0 = qbegin; i0 < Tn; i0 += kTile) {
    load_tile<T, HD>(qs, base, i0, Tn, W, a.bwd_scale);
    load_tile<T, HD>(dos, dout, i0, Tn, Wo, 1.f);
    if (threadIdx.x < kTile) {
      const int qi = i0 + threadIdx.x;
      lses[threadIdx.x] = qi < Tn ? lse[qi] : kNegInf;
      deltas[threadIdx.x] = qi < Tn ? delta[qi] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float* qr = qs + j * L::RS + part * (DPT + L::PAD);
      const float* dr = dos + j * L::RS + part * (DPT + L::PAD);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        s = fmaf(k[i], qr[i], s);
        dp = fmaf(v[i], dr[i], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const int qi = i0 + j;
      const float lj = lses[j];
      const bool okj = key_ok && lj > kSentinel && (!a.causal || kpos <= qi);
      const float p = okj ? expf(s - lj) : 0.f;
      const float ds = okj ? p * (dp - deltas[j]) : 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dv[i] = fmaf(p, dr[i], dv[i]);
        dk[i] = fmaf(ds, qr[i], dk[i]);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  T* dqkv = static_cast<T*>(a.dqkv) + ((size_t)b * Tn + kpos) * W + h * 3 * HD + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dqkv[HD + i] = from_f<T>(dk[i]);
    dqkv[2 * HD + i] = from_f<T>(dv[i]);
  }
}

// ----------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch(const MstCoreArgs& a, bool backward, cudaStream_t stream) {
  const dim3 grid((a.T + kRows - 1) / kRows, a.H, a.B);
  const int threads = Layout<HD>::kThreads;
  if (!backward) {
    core_fwd_kernel<T, HD><<<grid, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  core_bwd_dq_kernel<T, HD><<<grid, threads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  core_bwd_dkdv_kernel<T, HD><<<grid, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const MstCoreArgs& a, bool backward, cudaStream_t stream) {
  switch (a.HD) {
    case 8: return launch<T, 8>(a, backward, stream);
    case 16: return launch<T, 16>(a, backward, stream);
    case 32: return launch<T, 32>(a, backward, stream);
    case 64: return launch<T, 64>(a, backward, stream);
    case 128: return launch<T, 128>(a, backward, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(const MstCoreArgs* a, bool backward, void* stream) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->H > 65535 || a->B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->is_bf16 ? launch_hd<__nv_bfloat16>(*a, backward, s) : launch_hd<float>(*a, backward, s);
}

}  // namespace

extern "C" int mst_core_forward(const MstCoreArgs* a, void* stream) {
  return (int)run(a, false, stream);
}

extern "C" int mst_core_backward(const MstCoreArgs* a, void* stream) {
  return (int)run(a, true, stream);
}

extern "C" const char* mst_core_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
