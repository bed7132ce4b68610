// K4 (forward) and K5 (backward) for Hopper (sm_90a): flash attention over
// q, k, v [B, H, T, HD] with prefix key lengths and an optional causal mask.
//
// Replaces musicstyletransfer_tpu/ops/flash_attention.py:
// - flash_fwd_kernel replaces K4a, _flash_forward_with_lse (Pallas kernel
//   _flash_kernel), and K4b, _flash_forward_streaming (_flash_stream_kernel);
// - flash_bwd_delta_kernel, flash_bwd_dq_kernel and flash_bwd_dkdv_kernel
//   replace K5a, _flash_backward (_dqkv_kernel), and K5b/K5c,
//   _flash_backward_streaming (_dq_stream_kernel, _dkv_stream_kernel).
// Re-thought for the card rather than carried over block by block. The TPU
// kernels keep K/V for a whole head resident in VMEM below padded T = 8192
// and stream them above it, with block sizes fitted to the 16 MB scoped
// VMEM; and the resident backward carries f32 dK/dV accumulators for the
// whole head across its sequential query grid axis. Blocks on the card run
// in parallel, in no order, with at most 227 KB of shared memory, so:
//
// - One design for every T. The forward is one block per (64-query tile,
//   head, row); it walks 32-key tiles held in shared memory with an online
//   softmax (running max m and sum l, the accumulator rescaled when m
//   grows), stops at min(key_len, the causal bound of its tile) (the Pallas
//   kernel's num_k_blocks skip), and writes out and lse = m + log l.
// - The backward is three kernels, no atomics and no [T, T] array:
//   flash_bwd_delta_kernel (one warp per row: delta = rowsum(dO * O) - g_lse),
//   flash_bwd_dq_kernel (per query tile, walking the key tiles as the
//   forward does) and flash_bwd_dkdv_kernel (per key tile, walking the
//   query tiles from the diagonal on). Both recompute P = exp(S - lse) from
//   the saved lse. Masked terms are selected away, never multiplied by a
//   zero p, so cotangents of 1e19 stay finite.
// - A query (or key) row belongs to TPR = max(1, HD/32) neighbouring threads
//   that hold 32 (or HD) of its dimensions in registers and meet in warp
//   shuffles; the shared-memory tiles are float32, the row pieces padded
//   apart so the TPR threads read different banks.
// - Any strides with a contiguous last dimension: the model passes its
//   [B, T, H, HD] projections as [B, H, T, HD] views, and out and the
//   gradients are written in the layout the caller allocated.
// - Arithmetic is CUDA-core float32 FMA (the backward must be float32
//   throughout; the forward's scores are float32 sums of exact products of
//   the inputs). Tensor cores (mma.sync, wgmma) and TMA are later work.
//
// What bounds it: at the long training shapes (bf16; B=4, H=8; encoder
// T=2047, HD=64, non-causal; decoder T=2048, HD=32, causal; a corpus
// batch's key lengths) the forward needs 4*HD flops per unmasked (query,
// key) pair: 24.6 GFLOP (encoder) and 7.4 GFLOP (decoder), 25 and 7.5 us at
// the 989 TFLOP/s bf16 peak, against 34 and 17 MB of q, k, v, out and lse
// (10 and 5 us at 3.35 TB/s): operations bound. The backward needs 10*HD
// flops a pair (2.5x). On CUDA cores (67 TFLOP/s float32) these kernels
// cannot come nearer than ~15x that bound; PERF.md has their times.
//
// Rounding points of the reference (kept): q * sm_scale rounded to the input
// type (the scale itself rounded to that type first, as
// jnp.asarray(scale, dtype) does); scores in float32; masked scores -1e30;
// p rounded to the v type before P.V; out = acc / max(l, 1e-30); a row that
// sees no key gives zeros and the lse sentinel -1e30; the backward all in
// float32 (q * sm_scale in float32, a row live where lse > -1e29,
// ds = p * (dp - delta), dq scaled at the end, dk from the pre-scaled q).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_args.cuh"

namespace {

constexpr int kRows = 64;   // query (or key) rows a block owns
constexpr int kTile = 32;   // keys (or queries) per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kSentinel = -1e29f;  // lse at or below it: a row that sees no key

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
};

// Sum over the TPR neighbouring threads of one row (every thread gets it).
template <int TPR> __device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The (b, h) head of a strided [B, H, T, HD] tensor.
template <typename P>
__device__ __forceinline__ P* head(P* base, const long long* s, int b, int h) {
  return base + b * s[0] + h * s[1];
}

// Fill a [kTile, HD] float tile from rows first.. of a head (row stride
// `stride` elements), rows at or past `end` as zeros; `scale` multiplies
// every value.
template <typename T, int HD>
__device__ void load_tile(float* tile, const T* rows, long long stride, int first, int end,
                          float scale) {
  using L = Layout<HD>;
  for (int e = threadIdx.x; e < kTile * HD; e += L::kThreads) {
    const int j = e / HD, d = e % HD, row = first + j;
    tile[j * L::RS + (d / L::DPT) * (L::DPT + L::PAD) + d % L::DPT] =
        row < end ? to_f(rows[row * stride + d]) * scale : 0.f;
  }
}

// ----------------------------------------------------------------------------
// K4: forward. grid (ceil(T/kRows), H, B).

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads) flash_fwd_kernel(MstFlashArgs a) {
  using L = Layout<HD>;
  constexpr int TPR = L::TPR, DPT = L::DPT;
  __shared__ float ks[kTile * L::RS], vs[kTile * L::RS];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, qpos = q0 + r;
  const int Tn = a.T;
  const T* qh = head(static_cast<const T*>(a.q), a.sq, b, h);
  const T* kh = head(static_cast<const T*>(a.k), a.sk, b, h);
  const T* vh = head(static_cast<const T*>(a.v), a.sv, b, h);
  const int valid = min(max(a.key_lens[b], 0), Tn);
  const bool live = qpos < Tn;

  float q[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = live ? rnd<T>(to_f(qh[qpos * a.sq[2] + part * DPT + i]) * a.fwd_scale) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int kend = a.causal ? min(valid, min(Tn, q0 + kRows)) : valid;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    load_tile<T, HD>(ks, kh, a.sk[2], k0, Tn, 1.f);
    load_tile<T, HD>(vs, vh, a.sv[2], k0, Tn, 1.f);
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
  T* out = head(static_cast<T*>(a.out), a.so, b, h) + qpos * a.so[2] + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) out[i] = from_f<T>(acc[i] / lm);
  if (part == 0) a.lse[((size_t)b * a.H + h) * Tn + qpos] = m + logf(lm);
}

// ----------------------------------------------------------------------------
// K5, first kernel: delta = rowsum(dO * O) - g_lse, one warp per (b, h, t)
// row. grid ceil(B*H*T / 8) blocks of 256 threads.

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(MstFlashArgs a) {
  const size_t rows = (size_t)a.B * a.H * a.T;
  const size_t row = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int t = row % a.T, h = (row / a.T) % a.H, b = row / ((size_t)a.T * a.H);
  const T* o = head(static_cast<const T*>(a.out), a.so, b, h) + t * a.so[2];
  const T* g = head(static_cast<const T*>(a.dout), a.sdo, b, h) + t * a.sdo[2];
  float s = 0.f;
  for (int d = lane; d < a.HD; d += 32) s = fmaf(to_f(g[d]), to_f(o[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = a.g_lse != nullptr ? s - a.g_lse[row] : s;
}

// ----------------------------------------------------------------------------
// K5, second kernel: dQ. grid (ceil(T/kRows), H, B).

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads) flash_bwd_dq_kernel(MstFlashArgs a) {
  using L = Layout<HD>;
  constexpr int TPR = L::TPR, DPT = L::DPT;
  __shared__ float ks[kTile * L::RS], vs[kTile * L::RS];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, qpos = q0 + r;
  const int Tn = a.T;
  const T* qh = head(static_cast<const T*>(a.q), a.sq, b, h);
  const T* kh = head(static_cast<const T*>(a.k), a.sk, b, h);
  const T* vh = head(static_cast<const T*>(a.v), a.sv, b, h);
  const T* gh = head(static_cast<const T*>(a.dout), a.sdo, b, h);
  const int valid = min(max(a.key_lens[b], 0), Tn);
  const bool live = qpos < Tn;
  const size_t lrow = ((size_t)b * a.H + h) * Tn + qpos;

  float q[DPT], dout[DPT], dq[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = live ? to_f(qh[qpos * a.sq[2] + part * DPT + i]) * a.bwd_scale : 0.f;
    dout[i] = live ? to_f(gh[qpos * a.sdo[2] + part * DPT + i]) : 0.f;
    dq[i] = 0.f;
  }
  const float lse = live ? a.lse[lrow] : kNegInf;
  const float delta = live ? a.delta[lrow] : 0.f;
  const bool row_ok = lse > kSentinel;

  const int kend = a.causal ? min(valid, min(Tn, q0 + kRows)) : valid;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    load_tile<T, HD>(ks, kh, a.sk[2], k0, Tn, 1.f);
    load_tile<T, HD>(vs, vh, a.sv[2], k0, Tn, 1.f);
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
  T* dqr = head(static_cast<T*>(a.dq), a.sdq, b, h) + qpos * a.sdq[2] + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) dqr[i] = from_f<T>(dq[i] * a.bwd_scale);
}

// ----------------------------------------------------------------------------
// K5, third kernel: dK and dV. grid (ceil(T/kRows), H, B); a block owns 64
// keys and walks the query tiles that can see them.

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads) flash_bwd_dkdv_kernel(MstFlashArgs a) {
  using L = Layout<HD>;
  constexpr int TPR = L::TPR, DPT = L::DPT;
  __shared__ float qs[kTile * L::RS], dos[kTile * L::RS];
  __shared__ float lses[kTile], deltas[kTile];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kRows;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, kpos = k0 + r;
  const int Tn = a.T;
  const T* qh = head(static_cast<const T*>(a.q), a.sq, b, h);
  const T* kh = head(static_cast<const T*>(a.k), a.sk, b, h);
  const T* vh = head(static_cast<const T*>(a.v), a.sv, b, h);
  const T* gh = head(static_cast<const T*>(a.dout), a.sdo, b, h);
  const float* lse = a.lse + ((size_t)b * a.H + h) * Tn;
  const float* delta = a.delta + ((size_t)b * a.H + h) * Tn;
  const int valid = min(max(a.key_lens[b], 0), Tn);
  const bool live = kpos < Tn, key_ok = kpos < valid;

  float k[DPT], v[DPT], dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    k[i] = live ? to_f(kh[kpos * a.sk[2] + part * DPT + i]) : 0.f;
    v[i] = live ? to_f(vh[kpos * a.sv[2] + part * DPT + i]) : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  // Keys at or past key_lens get nothing; causal queries before k0 see none
  // of this block's keys.
  const int qbegin = k0 < valid ? (a.causal ? k0 : 0) : Tn;
  for (int i0 = qbegin; i0 < Tn; i0 += kTile) {
    load_tile<T, HD>(qs, qh, a.sq[2], i0, Tn, a.bwd_scale);
    load_tile<T, HD>(dos, gh, a.sdo[2], i0, Tn, 1.f);
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
  T* dkr = head(static_cast<T*>(a.dk), a.sdk, b, h) + kpos * a.sdk[2] + part * DPT;
  T* dvr = head(static_cast<T*>(a.dv), a.sdv, b, h) + kpos * a.sdv[2] + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dkr[i] = from_f<T>(dk[i]);
    dvr[i] = from_f<T>(dv[i]);
  }
}

// ----------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch(const MstFlashArgs& a, bool backward, cudaStream_t stream) {
  const dim3 grid((a.T + kRows - 1) / kRows, a.H, a.B);
  const int threads = Layout<HD>::kThreads;
  if (!backward) {
    flash_fwd_kernel<T, HD><<<grid, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t rows = (size_t)a.B * a.H * a.T;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD><<<grid, threads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, HD><<<grid, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const MstFlashArgs& a, bool backward, cudaStream_t stream) {
  switch (a.HD) {
    case 8: return launch<T, 8>(a, backward, stream);
    case 16: return launch<T, 16>(a, backward, stream);
    case 32: return launch<T, 32>(a, backward, stream);
    case 64: return launch<T, 64>(a, backward, stream);
    case 128: return launch<T, 128>(a, backward, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(const MstFlashArgs* a, bool backward, void* stream) {
  // windows and grouped K/V heads are flash_attention_tc.cu's
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->H > 65535 || a->B > 65535 || a->window != 0 ||
      a->group > 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->is_bf16 ? launch_hd<__nv_bfloat16>(*a, backward, s) : launch_hd<float>(*a, backward, s);
}

}  // namespace

extern "C" int mst_flash_forward(const MstFlashArgs* a, void* stream) {
  return (int)run(a, false, stream);
}

extern "C" int mst_flash_backward(const MstFlashArgs* a, void* stream) {
  return (int)run(a, true, stream);
}

extern "C" const char* mst_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
