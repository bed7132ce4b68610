// K1 for Hopper (sm_90a): the transformer decoder's whole decode loop in one
// launch — embed, every layer over the KV cache, the float32 vocab head,
// next-token choice (Gumbel-max after top-k/top-p, argmax, or forced) and
// the -log p scores, for all max_len positions.
//
// Replaces musicstyletransfer_tpu/ops/fused_decode.py::fused_decode, whose
// body is built by _make_kernel. Re-thought for the card rather than carried
// over block by block: one thread block per batch row, a loop over positions
// inside the block (the TPU kernel's sequential grid has no counterpart),
// per-row activations in shared memory, the KV cache in a global scratch
// buffer [NL, 2, B, T, D] (4.3 MB in bf16 at B=64, T=130, D=128: it stays in
// the 50 MB L2), weights read from global memory in flax's [in, out] layout
// so neighbouring threads read neighbouring output columns. The TPU-only
// parts are not carried over: the VMEM budget and batch tiling, the
// head-membership "segment matmul" and the one-hot embedding matmul.
//
// What bounds it: at B=64, D=128, T=130 the decoder weights are ~0.55 MB and
// a step is ~30 MFLOP for the whole batch, so neither bytes nor FLOPs bound
// it. The 130 positions are a chain of dependent steps, each a sequence of
// block-wide barriers and reductions (GEMVs, softmax, LayerNorm, the 2x32
// bisection steps of top-k/top-p), so the latency of that chain does. The
// design keeps every step inside one block with no launch or host sync
// between steps; fewer barriers and several rows per block are later work.
//
// Numerics mirror the port's nn.Module step (and flax): a dense layer is a
// product accumulated in float32, rounded to the compute type T, then a bias
// add in T; LayerNorm in float32 with eps 1e-6; attention scores rounded to
// T, softmax in float32, probabilities rounded to T; the head in float32.
// With T = float every rounding is the identity.
//
// Random numbers: Philox4x32-10, counter (row, step, vocab index, 0), key =
// the 64-bit seed; the low 23 bits map to a uniform strictly inside (0, 1).
// The plain PyTorch version (fused_decode.py) draws the same numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {
// Mirrored by _Args in fused_decode.py; keep the two in the same order.
struct MstFusedDecodeArgs {
  const void* x0;         // [B, D] T: conditioning state (position 0)
  const void* pos;        // [>=T, D] T: positional table
  const void* emb;        // [V, D] T: token embedding
  const void* wt;         // per-layer T weights, see layer_weights()
  const void* wf;         // float32 LayerNorm params, final LN, head
  const void* step_bias;  // [B, D] T class rows (per_step) or null
  const void* forced;     // [B, T] int32 (forced mode) or null
  void* cache;            // [NL, 2, B, T, D] T scratch
  void* seqs;             // [B, T] int32, pre-filled with PAD
  void* scores;           // [B] float32, pre-filled with 0
  void* logits;           // [B, T, V] float32 (forced mode), zeros, or null
  unsigned long long seed;
  int B, T, D, H, FF, V, NL;
  int mode, pre_ln, per_step, top_k, is_bf16;
  float top_p, temperature, scale, head_scale;
};
}

namespace {

constexpr int kThreads = 512;
constexpr int kPad = 0, kSos = 1, kEos = 2;
constexpr int kGreedy = 1, kForced = 2;  // mode 0 samples
constexpr float kNegInf = -1e30f;
constexpr float kLnEps = 1e-6f;
constexpr int kFilterIters = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float to the compute type and back (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; every thread gets the result. `red` holds 32 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nw ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < nw ? red[lane] : -INFINITY);
}

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// First-occurrence argmax over the block's (value, index) candidates.
__device__ int block_argmax(float v, int i, float* redf, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  __syncthreads();
  if (lane == 0) { redf[warp] = v; redi[warp] = i; }
  __syncthreads();
  v = lane < nw ? redf[lane] : -INFINITY;
  i = lane < nw ? redi[lane] : INT32_MAX;
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  return i;
}

// out[j] = sum_i x[i] * W[i * N + j] for j < N, float32, unrounded. Columns
// are spread over the block; when N < blockDim the K range is split over
// blockDim / N thread groups whose partial sums meet in `scratch`.
template <typename TW>
__device__ void gemv(const float* __restrict__ x, const TW* __restrict__ W, int K, int N,
                     float* __restrict__ out, float* __restrict__ scratch) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (N >= nt) {
    for (int j = tid; j < N; j += nt) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < K; ++i) acc = fmaf(x[i], to_f(W[(size_t)i * N + j]), acc);
      out[j] = acc;
    }
    __syncthreads();
    return;
  }
  const int split = nt / N, j = tid % N, s = tid / N;
  float acc = 0.f;
  if (s < split) {
    const int k0 = s * K / split, k1 = (s + 1) * K / split;
#pragma unroll 8
    for (int i = k0; i < k1; ++i) acc = fmaf(x[i], to_f(W[(size_t)i * N + j]), acc);
  }
  scratch[tid] = acc;
  __syncthreads();
  if (tid < N) {
    float sum = 0.f;
    for (int r = 0; r < split; ++r) sum += scratch[r * N + tid];
    out[tid] = sum;
  }
  __syncthreads();
}

// flax Dense at compute type T: round(round(x @ W) + b), optionally ReLU.
template <typename T>
__device__ void dense(const float* x, const T* W, const T* b, int K, int N, float* out,
                      float* scratch, bool relu) {
  gemv(x, W, K, N, out, scratch);
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float v = rnd<T>(rnd<T>(out[j]) + to_f(b[j]));
    out[j] = relu ? fmaxf(v, 0.f) : v;
  }
  __syncthreads();
}

// out = round(LayerNorm(in)), float32 statistics; `out` may alias `in`.
template <typename T>
__device__ void layer_norm(const float* in, float* out, const float* s, const float* b, int D,
                           float* red) {
  float part = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) part += in[d];
  const float mean = block_sum(part, red) / D;
  part = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float c = in[d] - mean;
    part += c * c;
  }
  const float inv = rsqrtf(block_sum(part, red) / D + kLnEps);
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    out[d] = rnd<T>((in[d] - mean) * inv * s[d] + b[d]);
  __syncthreads();
}

// out = round(a + b) elementwise.
template <typename T>
__device__ void residual(const float* a, const float* b, float* out, int D) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) out[d] = rnd<T>(a[d] + b[d]);
  __syncthreads();
}

__device__ __forceinline__ uint32_t philox_bits(uint32_t c0, uint32_t c1, uint32_t c2,
                                                unsigned long long seed) {
  uint32_t c3 = 0, k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__device__ __forceinline__ float uniform_open01(uint32_t bits) {
  return (float)(bits & 0x7FFFFFu) * 1.1920928955078125e-07f + 5.9604644775390625e-08f;
}

// Monotone float -> int32 key; -0.0 maps onto +0.0's key.
__device__ __forceinline__ int sort_key(float x) {
  const int i = (x == 0.f) ? 0 : __float_as_int(x);
  return i ^ ((i >> 31) & 0x7fffffff);
}

// The least int32 t with sum(w[keys > t]) < bound (w = 1 when null), by
// 32-step bisection; the midpoint floor((lo+hi)/2) avoids overflow.
__device__ int threshold_key(const int* keys, const float* w, int V, float bound, float* red) {
  int lo = INT32_MIN, hi = INT32_MAX;
  for (int it = 0; it < kFilterIters; ++it) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    float part = 0.f;
    for (int v = threadIdx.x; v < V; v += blockDim.x)
      if (keys[v] > mid) part += w ? w[v] : 1.f;
    if (block_sum(part, red) < bound) hi = mid; else lo = mid;
  }
  return hi;
}

template <typename T>
struct Layer {
  const T *wqkv, *wo, *w1, *w2, *bqkv, *bo, *b1, *b2;
  const float *ln1s, *ln1b, *ln2s, *ln2b;
  T *kc, *vc;  // this row's K and V cache, [T, D] each
};

template <typename T>
__device__ Layer<T> layer_weights(const MstFusedDecodeArgs& a, int l, int b) {
  const int D = a.D, FF = a.FF;
  const size_t per = (size_t)4 * D * D + 2 * (size_t)D * FF + 4 * D + FF + D;
  const T* w = static_cast<const T*>(a.wt) + l * per;
  const float* f = static_cast<const float*>(a.wf) + (size_t)l * 4 * D;
  T* cache = static_cast<T*>(a.cache);
  Layer<T> L;
  L.wqkv = w;
  L.wo = L.wqkv + (size_t)3 * D * D;
  L.w1 = L.wo + (size_t)D * D;
  L.w2 = L.w1 + (size_t)D * FF;
  L.bqkv = L.w2 + (size_t)FF * D;
  L.bo = L.bqkv + 3 * D;
  L.b1 = L.bo + D;
  L.b2 = L.b1 + FF;
  L.ln1s = f;
  L.ln1b = f + D;
  L.ln2s = f + 2 * D;
  L.ln2b = f + 3 * D;
  L.kc = cache + ((size_t)(2 * l) * a.B + b) * a.T * D;
  L.vc = cache + ((size_t)(2 * l + 1) * a.B + b) * a.T * D;
  return L;
}

struct Smem {
  float *x, *a, *y, *qkv, *ctx, *hid, *sc, *lg, *wv, *pv, *scratch, *red;
  int *keys, *redi;
};

__host__ __device__ inline size_t smem_floats(int D, int H, int T, int FF, int V, int nt) {
  return (size_t)3 * D + 3 * D + D + FF + (size_t)H * T + 3 * V + nt + 32;
}

__host__ __device__ inline size_t smem_bytes(int D, int H, int T, int FF, int V, int nt) {
  return (smem_floats(D, H, T, FF, V, nt) + V + 32) * 4;
}

// Self-attention of one layer at position t for input `in`; writes the
// attention block's output (after w_o) to s.y.
template <typename T>
__device__ void attention(const MstFusedDecodeArgs& a, const Layer<T>& L, const float* in,
                          int t, const Smem& s) {
  const int D = a.D, H = a.H, HD = D / H, tid = threadIdx.x, nt = blockDim.x;
  dense<T>(in, L.wqkv, L.bqkv, D, 3 * D, s.qkv, s.scratch, false);
  for (int d = tid; d < D; d += nt) {
    L.kc[(size_t)t * D + d] = from_f<T>(s.qkv[D + d]);
    L.vc[(size_t)t * D + d] = from_f<T>(s.qkv[2 * D + d]);
  }
  __syncthreads();  // the block's cache writes are visible to the block
  const int n = t + 1;
  for (int p = tid; p < H * n; p += nt) {
    const int h = p / n, tau = p % n;
    const T* kr = L.kc + (size_t)tau * D + h * HD;
    const float* q = s.qkv + h * HD;
    float acc = 0.f;
    for (int i = 0; i < HD; ++i) acc = fmaf(q[i], to_f(kr[i]), acc);
    s.sc[h * a.T + tau] = rnd<T>(rnd<T>(acc) / a.head_scale);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int h = warp; h < H; h += nw) {  // one warp per head
    float* row = s.sc + h * a.T;
    float m = -INFINITY;
    for (int tau = lane; tau < n; tau += 32) m = fmaxf(m, row[tau]);
    m = warp_max(m);
    float sum = 0.f;
    for (int tau = lane; tau < n; tau += 32) {
      const float e = expf(row[tau] - m);
      row[tau] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int tau = lane; tau < n; tau += 32) row[tau] = rnd<T>(row[tau] / sum);
  }
  __syncthreads();
  // ctx[d] = sum_tau p[head(d), tau] * V[tau, d]; when D < blockDim the tau
  // range is split over blockDim / D thread groups.
  if (D >= nt) {
    for (int d = tid; d < D; d += nt) {
      const float* p = s.sc + (d / HD) * a.T;
      float acc = 0.f;
      for (int tau = 0; tau < n; ++tau) acc = fmaf(p[tau], to_f(L.vc[(size_t)tau * D + d]), acc);
      s.ctx[d] = rnd<T>(acc);
    }
  } else {
    const int split = nt / D, d = tid % D, g = tid / D;
    float acc = 0.f;
    if (g < split) {
      const float* p = s.sc + (d / HD) * a.T;
      const int t0 = g * n / split, t1 = (g + 1) * n / split;
      for (int tau = t0; tau < t1; ++tau) acc = fmaf(p[tau], to_f(L.vc[(size_t)tau * D + d]), acc);
    }
    s.scratch[tid] = acc;
    __syncthreads();
    if (tid < D) {
      float sum = 0.f;
      for (int r = 0; r < split; ++r) sum += s.scratch[r * D + tid];
      s.ctx[tid] = rnd<T>(sum);
    }
  }
  __syncthreads();
  dense<T>(s.ctx, L.wo, L.bo, D, D, s.y, s.scratch, false);
}

// Every layer at position t on the residual stream s.x. Returns the stack's
// output buffer (s.x under post-LN, the final LayerNorm in s.a under pre-LN).
template <typename T>
__device__ const float* run_stack(const MstFusedDecodeArgs& a, int b, int t, const Smem& s) {
  const int D = a.D;
  for (int l = 0; l < a.NL; ++l) {
    const Layer<T> L = layer_weights<T>(a, l, b);
    if (a.pre_ln) {
      layer_norm<T>(s.x, s.a, L.ln1s, L.ln1b, D, s.red);
      attention<T>(a, L, s.a, t, s);
      residual<T>(s.x, s.y, s.x, D);
      layer_norm<T>(s.x, s.a, L.ln2s, L.ln2b, D, s.red);
      dense<T>(s.a, L.w1, L.b1, D, a.FF, s.hid, s.scratch, true);
      dense<T>(s.hid, L.w2, L.b2, a.FF, D, s.y, s.scratch, false);
      residual<T>(s.x, s.y, s.x, D);
    } else {
      attention<T>(a, L, s.x, t, s);
      residual<T>(s.x, s.y, s.a, D);
      layer_norm<T>(s.a, s.x, L.ln1s, L.ln1b, D, s.red);
      dense<T>(s.x, L.w1, L.b1, D, a.FF, s.hid, s.scratch, true);
      dense<T>(s.hid, L.w2, L.b2, a.FF, D, s.y, s.scratch, false);
      residual<T>(s.x, s.y, s.a, D);
      layer_norm<T>(s.a, s.x, L.ln2s, L.ln2b, D, s.red);
    }
  }
  if (!a.pre_ln) return s.x;
  const float* f = static_cast<const float*>(a.wf) + (size_t)a.NL * 4 * D;
  layer_norm<T>(s.x, s.a, f, f + D, D, s.red);
  return s.a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_decode_kernel(const MstFusedDecodeArgs a) {
  extern __shared__ float smem[];
  __shared__ int s_tok, s_done;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int D = a.D, T_ = a.T, V = a.V;
  Smem s;
  s.x = smem;
  s.a = s.x + D;
  s.y = s.a + D;
  s.qkv = s.y + D;
  s.ctx = s.qkv + 3 * D;
  s.hid = s.ctx + D;
  s.sc = s.hid + a.FF;
  s.lg = s.sc + (size_t)a.H * T_;
  s.wv = s.lg + V;
  s.pv = s.wv + V;
  s.scratch = s.pv + V;
  s.red = s.scratch + nt;
  s.keys = reinterpret_cast<int*>(s.red + 32);
  s.redi = s.keys + V;

  const T* pos = static_cast<const T*>(a.pos);
  const T* emb = static_cast<const T*>(a.emb);
  const T* sbias = static_cast<const T*>(a.step_bias);
  const float* fhead = static_cast<const float*>(a.wf) + (size_t)a.NL * 4 * D + 2 * D;
  const float* head_b = fhead + (size_t)D * V;
  int* seqs = static_cast<int*>(a.seqs) + (size_t)b * T_;
  const int* forced = static_cast<const int*>(a.forced);
  float* logits_out = static_cast<float*>(a.logits);

  // Position 0: the conditioning state; its head output is unused.
  const T* x0 = static_cast<const T*>(a.x0) + (size_t)b * D;
  for (int d = tid; d < D; d += nt)
    s.x[d] = rnd<T>(rnd<T>(a.scale * to_f(x0[d])) + to_f(pos[d]));
  __syncthreads();
  run_stack<T>(a, b, 0, s);
  if (tid == 0) {
    seqs[0] = kSos;
    s_tok = kSos;
    s_done = 0;
  }
  __syncthreads();

  float score = 0.f;  // thread 0's running -log p
  for (int t = 1; t < T_; ++t) {
    const int tok = s_tok;
    for (int d = tid; d < D; d += nt) {
      float e = to_f(emb[(size_t)tok * D + d]);
      if (a.per_step) e = rnd<T>(e + to_f(sbias[(size_t)b * D + d]));
      s.x[d] = rnd<T>(rnd<T>(a.scale * e) + to_f(pos[(size_t)t * D + d]));
    }
    __syncthreads();
    const float* h = run_stack<T>(a, b, t, s);
    gemv(h, fhead, D, V, s.lg, s.scratch);
    for (int v = tid; v < V; v += nt) s.lg[v] += head_b[v];
    __syncthreads();

    int nxt;
    if (a.mode == kForced) {
      float* out = logits_out + ((size_t)b * T_ + t) * V;
      for (int v = tid; v < V; v += nt) out[v] = s.lg[v];
      nxt = forced[(size_t)b * T_ + t];
    } else if (a.mode == kGreedy) {
      float best = -INFINITY;
      int bi = INT32_MAX;
      for (int v = tid; v < V; v += nt) argmax_merge(best, bi, s.lg[v], v);
      nxt = block_argmax(best, bi, s.red, s.redi);
    } else {
      for (int v = tid; v < V; v += nt) s.wv[v] = s.lg[v] / a.temperature;
      __syncthreads();
      if (a.top_k > 0 && a.top_k < V) {
        for (int v = tid; v < V; v += nt) s.keys[v] = sort_key(s.wv[v]);
        __syncthreads();
        const int thr = threshold_key(s.keys, nullptr, V, (float)a.top_k, s.red);
        for (int v = tid; v < V; v += nt)
          if (s.keys[v] < thr) s.wv[v] = kNegInf;
        __syncthreads();
      }
      if (a.top_p > 0.f && a.top_p < 1.f) {
        float m = -INFINITY;
        for (int v = tid; v < V; v += nt) {
          s.keys[v] = sort_key(s.wv[v]);
          m = fmaxf(m, s.wv[v]);
        }
        m = block_max(m, s.red);
        float part = 0.f;
        for (int v = tid; v < V; v += nt) {
          s.pv[v] = expf(s.wv[v] - m);
          part += s.pv[v];
        }
        const float sum = block_sum(part, s.red);
        for (int v = tid; v < V; v += nt) s.pv[v] /= sum;
        __syncthreads();
        const int thr = threshold_key(s.keys, s.pv, V, a.top_p, s.red);
        for (int v = tid; v < V; v += nt)
          if (s.keys[v] < thr) s.wv[v] = kNegInf;
        __syncthreads();
      }
      float best = -INFINITY;
      int bi = INT32_MAX;
      for (int v = tid; v < V; v += nt) {
        const float u = uniform_open01(philox_bits((uint32_t)b, (uint32_t)t, (uint32_t)v, a.seed));
        argmax_merge(best, bi, s.wv[v] - logf(-logf(u)), v);
      }
      nxt = block_argmax(best, bi, s.red, s.redi);
    }

    // -log p of the emitted token under the unfiltered, untempered logits.
    float m = -INFINITY;
    for (int v = tid; v < V; v += nt) m = fmaxf(m, s.lg[v]);
    m = block_max(m, s.red);
    float part = 0.f;
    for (int v = tid; v < V; v += nt) part += expf(s.lg[v] - m);
    const float lse = logf(block_sum(part, s.red)) + m;
    if (tid == 0) {
      const int done = s_done;
      if (!done) score += lse - s.lg[nxt];
      int out = nxt;
      if (a.mode != kForced) {
        if (done) out = kPad;
        else if (nxt == kEos) s_done = 1;
      }
      seqs[t] = out;
      s_tok = out;
    }
    __syncthreads();
    if (s_done) break;
  }
  if (tid == 0) static_cast<float*>(a.scores)[b] = score;
}

template <typename T>
cudaError_t launch(const MstFusedDecodeArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D, a.H, a.T, a.FF, a.V, kThreads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fused_decode_kernel<T><<<a.B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mst_fused_decode(const MstFusedDecodeArgs* a, void* stream) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->D % a->H != 0 || a->V < 1 || a->NL < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->is_bf16 ? launch<__nv_bfloat16>(*a, s) : launch<float>(*a, s));
}

extern "C" const char* mst_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
