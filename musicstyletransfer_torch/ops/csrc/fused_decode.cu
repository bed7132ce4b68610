// K1 for Hopper (sm_90a): the transformer decoder's whole decode loop in one
// launch — embed, every layer over the KV cache, the float32 vocab head,
// next-token choice (Gumbel-max after top-k/top-p, argmax, or forced) and
// the -log p scores, for all max_len positions.
//
// Replaces musicstyletransfer_tpu/ops/fused_decode.py::fused_decode, whose
// body is built by _make_kernel. The TPU kernel runs a tile of rows through
// every product as the matrix unit's M dimension, so that one weight read
// serves the tile; this kernel keeps that property on the card:
//
// - Rows in groups. A group of R <= 16 rows is decoded together, and every
//   weight element loaded feeds all R rows: in bf16 the rows are the M
//   dimension of mma.sync m16n8k16 (rows padded to 16; every activation is
//   already rounded to bf16, so the operands are exact) with float32
//   accumulation, in float32 CUDA-core FMAs on 16-byte weight loads. The
//   float32 head stays float32 (FMAs) in both.
// - One group on a thread-block cluster of C blocks (C divides the number of
//   heads). Block c owns heads [c*H/C, (c+1)*H/C): their q, k, v columns,
//   their KV cache (read and written by that block alone) and their
//   attention for every row of the group; and 1/C of the columns of the
//   other products (w_o, ff1, ff2, the head). A product's output slice is
//   written into every block of the cluster through distributed shared
//   memory, then one cluster barrier; each block holds the group's whole
//   activations, so LayerNorm, the embedding and the token choice run in
//   every block alike, with no traffic (the residual adds ride in the w_o
//   and ff2 epilogues). 4 cluster barriers a layer and one for the head per
//   position; a buffer written remotely in a phase is never read in that
//   phase, so one barrier a phase suffices.
// - Groups fill the card: the grid is G = ceil(B/R) clusters; R and C come
//   from plan() in fused_decode.py (a pure function of the shapes and of the
//   clusters the card runs at once, mst_fused_decode_clusters).
// - A block's weight slices stay resident in shared memory for the whole
//   launch where they fit beside the group's buffers (the canonical decoder:
//   0.54 MB / 8 blocks); otherwise they are streamed from L2 each position
//   (3.4 MB long, 13.2 MB wide: all stay in the 50 MB L2), 16 bytes a lane,
//   several loads in flight a warp. plan() chooses. In bf16 the pack orders
//   each 32-wide piece of a weight row so that one 16-byte load holds a
//   lane's B fragments of two mma k-steps (fused_decode.py MMA_ORDER).
// - Attention reads the K/V cache ([NL, 2, B, H, T, hd]: one head's keys
//   contiguous) with 16-byte loads along the head dimension, neighbouring
//   lanes on neighbouring keys; two passes over the keys (max and sum, then
//   the rounded probabilities times V) keep the numerics below and need no
//   score buffer, so shared memory does not grow with T. A (row, head) item
//   whose warp would be alone is split over several warps by key ranges.
// - The token choice runs per row within one warp (shuffles, no block
//   barrier): the top-k/top-p bisections, Gumbel-max or argmax over V.
// - A group stops when all its rows have emitted EOS; a finished row emits
//   PAD and adds nothing to its score.
// - Any decoder whose heads divide its model size: the wrapper pads the
//   model size Dl to D, a multiple of 32 that the heads divide (each head's
//   dimensions padded from Dl/H to D/H), and FF to a multiple of 32, with
//   zeros in every weight, bias, LayerNorm parameter and input of the pads,
//   so every product and every pad column stays what it was (zero);
//   LayerNorm takes its statistics over the Dl true columns. A vocabulary
//   above 32 * kMaxVLane takes a token choice that loops over shared memory
//   instead of holding the logits in registers.
//
// What bounds it: a position is a chain of dependent phases (products,
// attention, barriers); at the wide decoder the weights streamed from L2 each
// position, at the long decoder the KV-cache reads (PERF.md).
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
//
// Built with -DMST_K1_PHASES, thread 0 of every block sums clock64() by
// phase (scripts/k1-phases.py reads the sums).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
  void* cache;            // [NL, 2, B, H, T, D/H] T scratch
  void* seqs;             // [B, T] int32, pre-filled with PAD
  void* scores;           // [B] float32, pre-filled with 0
  void* logits;           // [B, T, V] float32 (forced mode), zeros, or null
  unsigned long long seed;
  int B, T, D, H, FF, V, NL;
  int mode, pre_ln, per_step, top_k, is_bf16;
  float top_p, temperature, scale, head_scale;
  int rows, cluster;      // the plan: rows a group, blocks a cluster (<= 8)
  int resident;           // the plan: weight slices resident in shared memory
  int Dl;                 // the model size; D is its padded width (see below)
};
}

namespace {

// 256 threads leave a thread 255 registers: the kernel is one large inlined
// body, and at 512 threads (128 registers) it spilled kilobytes a thread.
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxRows = 16;    // the mma's M
constexpr int kMaxCluster = 8;  // the portable cluster size
// A resident slice's rows are padded by 64 bytes: the 4 lanes of a column
// read 64 contiguous bytes, and the next column's lanes the 64 bytes on the
// other half of the banks.
constexpr int kSlicePad = 64;
constexpr int kMaxVLane = 10;   // vocab entries a lane holds in registers: V <= 320
constexpr int kPad = 0, kSos = 1, kEos = 2;
constexpr int kGreedy = 1, kForced = 2;  // mode 0 samples
constexpr float kNegInf = -1e30f;
constexpr float kLnEps = 1e-6f;
constexpr int kFilterIters = 32;

#ifdef MST_K1_PHASES
__shared__ unsigned long long mst_ph[16];
__device__ unsigned long long mst_ph_total[16];
#define PH_BEGIN(v) const unsigned long long v = clock64()
#define PH_END(i, v) do { if (threadIdx.x == 0) mst_ph[i] += clock64() - (v); } while (0)
#else
#define PH_BEGIN(v) do {} while (0)
#define PH_END(i, v) do {} while (0)
#endif
// Indices of PHASES in scripts/k1-phases.py (residual and embedding are
// phases of the one-block-per-row kernel only; here they ride in epilogues).
enum Phase { kPhQkv, kPhScores, kPhSoftmax, kPhPV, kPhO, kPhLN, kPhFF1, kPhFF2, kPhResidual,
             kPhHead, kPhToken, kPhEmbed, kPhWhole, kPhBlockBar, kPhClusterBar };

__device__ __forceinline__ void block_sync() {
#ifdef MST_K1_PHASES
  const unsigned long long t0 = clock64();
  __syncthreads();
  if (threadIdx.x == 0) mst_ph[kPhBlockBar] += clock64() - t0;
#else
  __syncthreads();
#endif
}

__device__ __forceinline__ void cluster_sync() {
#ifdef MST_K1_PHASES
  const unsigned long long t0 = clock64();
  cg::this_cluster().sync();
  if (threadIdx.x == 0) mst_ph[kPhClusterBar] += clock64() - t0;
#else
  cg::this_cluster().sync();
#endif
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float to the compute type and back (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// Four consecutive elements as floats (16 bytes of float, 8 of bf16).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(lo); o[1] = __high2float(lo); o[2] = __low2float(hi); o[3] = __high2float(hi);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// First-occurrence argmax over the warp's (value, index) candidates.
__device__ __forceinline__ int warp_argmax(float v, int i) {
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  return i;
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

// The least int32 t with sum(w[keys > t]) < bound over the warp's entries
// (a lane's entries in registers; absent ones carry key INT32_MIN, which no
// midpoint is below), by 32-step bisection; the midpoint floor((lo+hi)/2)
// avoids overflow.
__device__ __forceinline__ int warp_threshold_key(const int (&keys)[kMaxVLane],
                                                  const float (&w)[kMaxVLane], float bound) {
  int lo = INT32_MIN, hi = INT32_MAX;
  for (int it = 0; it < kFilterIters; ++it) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVLane; ++i)
      if (keys[i] > mid) part += w[i];
    if (warp_sum(part) < bound) hi = mid; else lo = mid;
  }
  return hi;
}

// ---------------------------------------------------------------------------
// Shared memory. Activations are stored in T (every one is rounded to T), in
// rows of `width + kLdPad` elements: the pad spreads an mma A fragment's 8
// rows over all 32 banks.

constexpr int kLdPad = 8;

__host__ __device__ inline int split_of(int n_tiles, int K) {
  // warps on one 8-column tile share its k range when tiles are fewer than warps
  if (n_tiles >= kWarps) return 1;
  const int s = kWarps / n_tiles, chunks = K / 32;
  return s < chunks ? s : chunks;
}

struct Dims {
  int R, D, FF, V, HD, Hc, C, esize, NL, resident;
  __host__ __device__ int nb_qkv() const { return 3 * Hc * HD; }
  __host__ __device__ int nb_o() const { return D / C; }
  __host__ __device__ int nb_ff1() const { return FF / C; }
  __host__ __device__ int nb_head() const { return ((V + C - 1) / C + 7) / 8 * 8; }
  // A resident slice keeps a weight row per output column, padded.
  __host__ __device__ int wpad() const { return kSlicePad / esize; }
  __host__ __device__ size_t slice_layer() const {  // elements of T a layer
    return (size_t)(nb_qkv() + nb_o() + nb_ff1()) * (D + wpad()) + (size_t)nb_o() * (FF + wpad());
  }
  __host__ __device__ size_t slice_bytes() const {
    if (!resident) return 0;
    return (size_t)NL * slice_layer() * esize + (size_t)nb_head() * (D + kSlicePad / 4) * 4;
  }
  __host__ __device__ int part_floats() const {
    const int nb[5] = {nb_qkv(), nb_o(), nb_ff1(), nb_o(), nb_head()};
    const int k[5] = {D, D, D, FF, D};
    int m = 0;
    for (int i = 0; i < 5; ++i) {
      const int p = split_of(nb[i] / 8, k[i]) * R * nb[i];
      m = p > m ? p : m;
    }
    return m;
  }
};

enum Buf { kX, kA, kCtx, kHid, kQkv, kLg, kPart, kNoise, kMl, kCpart, kTok, kDone, kScore, kW,
           kNBuf };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Byte offsets of the buffers (off[kNBuf] = the total).
__host__ __device__ inline size_t smem_layout(const Dims& d, size_t* off) {
  const size_t act = (size_t)d.R * (d.D + kLdPad) * d.esize;
  const size_t sizes[kNBuf] = {
      act, act, act, (size_t)d.R * (d.FF + kLdPad) * d.esize,
      (size_t)d.R * d.nb_qkv() * 4, (size_t)d.R * d.V * 4, (size_t)d.part_floats() * 4,
      (size_t)d.R * d.V * 4, (size_t)kWarps * 2 * 4, (size_t)kWarps * d.HD * 4,
      kMaxRows * 4, kMaxRows * 4, kMaxRows * 4, d.slice_bytes()};
  size_t o = 0;
  for (int i = 0; i < kNBuf; ++i) {
    if (off) off[i] = o;
    o += align16(sizes[i]);
  }
  if (off) off[kNBuf] = o;
  return o;
}

template <typename T>
struct Smem {
  T *x, *a, *ctx, *hid;  // [R][D + pad], hid [R][FF + pad]
  float *qkv;                // [R][3 * Hc * HD]: this block's heads' q, k, v
  float *lg;                 // [R][V] logits
  float *part;               // split partial sums of a product
  float *noise;              // [R][V] Gumbel noise of this position (sample mode)
  float *ml;                 // [warps][2] (max, sum) of a key range
  float *cpart;              // [warps][HD] partial context of a key range
  int *tok, *done;
  float *score;
  T *w;                      // resident slices: per layer qkv, o, ff1, ff2
  float *whead;              // resident slice of the head
};

// ---------------------------------------------------------------------------
// Products. part[s][r][j] = sum over split s's k range of A[r][k] * W[row(j)][k]
// for the block's Nb columns j and the group's rows r < R; float32,
// unrounded. W holds a weight row per output (K contiguous, rows ldw
// apart), in global memory or (kSmem) a resident slice in shared memory; a
// column whose row is >= nvalid reads zeros. Warps take (8-column tile, k
// range) items.

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes of a resident slice (volatile: never hoisted above the copy)
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

__device__ __forceinline__ void mma_k16(float (&acc)[4], const __nv_bfloat16* lo,
                                        const __nv_bfloat16* hi, bool lo_ok, bool hi_ok, int k,
                                        uint32_t b0, uint32_t b1) {
  const uint32_t a0 = lo_ok ? lds32(lo + k) : 0u, a1 = hi_ok ? lds32(hi + k) : 0u;
  const uint32_t a2 = lo_ok ? lds32(lo + k + 8) : 0u, a3 = hi_ok ? lds32(hi + k + 8) : 0u;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 weights on the tensor cores. Rows g and g + 8 of the A fragment are
// the group's rows (zeros from R on); each 32-wide piece of a weight row is
// stored in mma order (fused_decode.py mma_order), so lane (g, q) finds its
// B fragments of both k steps in one 16-byte load at 8 * q.
template <int kChunks, bool kSmem, typename RowOf>
__device__ void product_mma(const __nv_bfloat16* A, int lda, int R, int K,
                            const __nv_bfloat16* W, int ldw, int nvalid, int Nb, RowOf row_of,
                            float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int NT = Nb >> 3, split = split_of(NT, K), KC = K >> 5;
  const __nv_bfloat16* lo = A + (size_t)g * lda + 2 * q;
  const __nv_bfloat16* hi = lo + (size_t)8 * lda;
  const bool lo_ok = g < R, hi_ok = g + 8 < R;
  for (int item = warp; item < NT * split; item += kWarps) {
    const int nt = item % NT, s = item / NT;
    const int c0 = s * KC / split, c1 = (s + 1) * KC / split;
    const int wr = row_of(nt * 8 + g);
    const bool valid = wr < nvalid;
    const uint4* wp = reinterpret_cast<const uint4*>(W + (size_t)(valid ? wr : 0) * ldw) + q;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = c0; c < c1; c += kChunks) {  // kChunks 16-byte loads a lane in flight
      uint4 b[kChunks];
#pragma unroll
      for (int u = 0; u < kChunks; ++u)
        b[u] = !(valid && c + u < c1) ? make_uint4(0, 0, 0, 0)
               : kSmem ? lds128(wp + (size_t)(c + u) * 4) : __ldg(wp + (size_t)(c + u) * 4);
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        if (c + u < c1) {
          mma_k16(acc, lo, hi, lo_ok, hi_ok, (c + u) * 32, b[u].x, b[u].y);
          mma_k16(acc, lo, hi, lo_ok, hi_ok, (c + u) * 32 + 16, b[u].z, b[u].w);
        }
      }
    }
    float* out = part + (size_t)s * R * Nb + nt * 8 + 2 * q;
    if (lo_ok) { out[(size_t)g * Nb] = acc[0]; out[(size_t)g * Nb + 1] = acc[1]; }
    if (hi_ok) { out[(size_t)(g + 8) * Nb] = acc[2]; out[(size_t)(g + 8) * Nb + 1] = acc[3]; }
  }
}

// float32 weights (every float32 layer, and the head) on the CUDA cores:
// lane (g, q) reads 4 consecutive weights of column g at 4 * q of a 16-wide
// piece and adds them into all R rows; the four q lanes meet by shuffles.
template <typename TA, typename RowOf>
__device__ void product_fma(const TA* A, int lda, int R, int K, const float* W, int ldw,
                            int nvalid, int Nb, RowOf row_of, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int NT = Nb >> 3, split = split_of(NT, K), KC = K >> 5;
  for (int item = warp; item < NT * split; item += kWarps) {
    const int nt = item % NT, s = item / NT;
    const int k0 = (s * KC / split) * 32, k1 = ((s + 1) * KC / split) * 32;
    const int wr = row_of(nt * 8 + g);
    const bool valid = wr < nvalid;
    const float* wp = W + (size_t)(valid ? wr : 0) * ldw + 4 * q;
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = k0; k < k1; k += 16) {
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      if (valid) load4(wp + k, w);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < R) {
          float x[4];
          load4(A + (size_t)r * lda + k + 4 * q, x);
          acc[r] = fmaf(x[0], w[0], acc[r]);
          acc[r] = fmaf(x[1], w[1], acc[r]);
          acc[r] = fmaf(x[2], w[2], acc[r]);
          acc[r] = fmaf(x[3], w[3], acc[r]);
        }
      }
    }
    float* out = part + (size_t)s * R * Nb + nt * 8 + g;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
      if (r < R && (r & 3) == q) out[(size_t)r * Nb] = acc[r];
    }
  }
}

template <typename T, typename RowOf>
__device__ __forceinline__ void product(const T* A, int lda, int R, int K, const T* W, int ldw,
                                        bool smem, int nvalid, int Nb, RowOf row_of,
                                        float* part) {
  if constexpr (sizeof(T) == 2) {
    // 8 weight loads a lane in flight where a warp's k range holds 8 pieces
    // of 32 or more (the wide decoder's products), else 4 (the canonical
    // one, and every resident slice)
    if (smem)
      product_mma<4, true>(A, lda, R, K, W, ldw, nvalid, Nb, row_of, part);
    else if ((K / 32) / split_of(Nb / 8, K) >= 8)
      product_mma<8, false>(A, lda, R, K, W, ldw, nvalid, Nb, row_of, part);
    else
      product_mma<4, false>(A, lda, R, K, W, ldw, nvalid, Nb, row_of, part);
  } else
    product_fma(A, lda, R, K, W, ldw, nvalid, Nb, row_of, part);
}

// f(r, j, sum) for every (row, column) of the block's slice, the split
// partials summed in order.
template <typename F>
__device__ __forceinline__ void finish(const float* part, int R, int Nb, int split, F f) {
  for (int i = threadIdx.x; i < R * Nb; i += kThreads) {
    const int r = i / Nb, j = i - r * Nb;
    float acc = part[(size_t)r * Nb + j];
    for (int s = 1; s < split; ++s) acc += part[((size_t)s * R + r) * Nb + j];
    f(r, j, acc);
  }
}

// flax Dense at compute type T on the block's Nb columns [col0, col0 + Nb):
// round(round(x @ W) + b), then ReLU, or the residual add round(resid + .)
// where `resid` is given, written into `dst` ([R][ld]) of every block of the
// cluster. A block reads only its own columns of `resid`, so `dst` may be
// `resid`. `slice` is the block's resident slice of W (rows K + pad apart),
// or null to read W's rows from global memory.
template <typename T>
__device__ void dense_cluster(const T* A, int lda, int R, int K, const T* W, const T* slice,
                              const T* bias, int col0, int Nb, bool relu, const T* resid, T* dst,
                              int ld, float* part, int C) {
  const int row0 = slice ? 0 : col0;
  const int ldw = slice ? K + kSlicePad / (int)sizeof(T) : K;
  product(A, lda, R, K, slice ? slice : W, ldw, slice != nullptr, 1 << 30, Nb,
          [row0](int j) { return row0 + j; }, part);
  block_sync();
  cg::cluster_group cluster = cg::this_cluster();
  finish(part, R, Nb, split_of(Nb / 8, K), [&](int r, int j, float acc) {
    const int col = col0 + j;
    float v = rnd<T>(rnd<T>(acc) + to_f(bias[col]));
    if (relu) v = fmaxf(v, 0.f);
    if (resid) v = rnd<T>(to_f(resid[(size_t)r * ld + col]) + v);
    const T out = from_f<T>(v);
    for (int c = 0; c < C; ++c) cluster.map_shared_rank(dst, c)[(size_t)r * ld + col] = out;
  });
}

// out = round(LayerNorm(in)) row by row, one warp a row, float32 statistics
// over the Dl true columns; the pad columns [Dl, D) of `out` are zeros.
// `out` may alias `in`.
template <typename T>
__device__ void layer_norm_rows(const T* in, T* out, int R, int Dl, int D, int ld,
                                const float* s, const float* b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kWarps) {
    const T* x = in + (size_t)r * ld;
    float part = 0.f;
    for (int d = lane; d < Dl; d += 32) part += to_f(x[d]);
    const float mean = warp_sum(part) / Dl;
    part = 0.f;
    for (int d = lane; d < Dl; d += 32) {
      const float c = to_f(x[d]) - mean;
      part += c * c;
    }
    const float inv = rsqrtf(warp_sum(part) / Dl + kLnEps);
    for (int d = lane; d < D; d += 32)
      out[(size_t)r * ld + d] =
          from_f<T>(d < Dl ? (to_f(x[d]) - mean) * inv * s[d] + b[d] : 0.f);
  }
}


// ---------------------------------------------------------------------------
// One layer's weights. wt (T), per layer: Wqkv [3D][D] (rows q, k, v), Wo
// [D][D], W1 [FF][D], W2 [D][FF] (a row per output, in mma order in bf16),
// then bqkv, bo, b1, b2. wf (float32): per layer ln1 scale/bias, ln2
// scale/bias; then the final LayerNorm's scale/bias; the head [V][D]; its bias.

template <typename T>
struct Layer {
  const T *wqkv, *wo, *w1, *w2, *bqkv, *bo, *b1, *b2;
  const float *ln1s, *ln1b, *ln2s, *ln2b;
};

template <typename T>
__device__ Layer<T> layer_weights(const MstFusedDecodeArgs& a, int l) {
  const int D = a.D, FF = a.FF;
  const size_t per = (size_t)4 * D * D + 2 * (size_t)D * FF + 4 * D + FF + D;
  const T* w = static_cast<const T*>(a.wt) + l * per;
  const float* f = static_cast<const float*>(a.wf) + (size_t)l * 4 * D;
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
  return L;
}

// 16 bytes of T as floats (8 of bf16, 4 of float).
__device__ __forceinline__ void unpack16(const uint4& v, float* o, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __low2float(h[i]);
    o[2 * i + 1] = __high2float(h[i]);
  }
}
__device__ __forceinline__ void unpack16(const uint4& v, float* o, float) {
  o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z); o[3] = __uint_as_float(v.w);
}

// One cache row of HD elements, held as 16-byte vectors until used.
template <typename T, int HD>
struct CacheRow {
  static constexpr int kE = 16 / sizeof(T), kN = HD / kE;
  uint4 v[kN];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = *reinterpret_cast<const uint4*>(p + i * kE);
  }
};

// round(round(q . k) / head_scale), the product summed in d order.
template <typename T, int HD>
__device__ __forceinline__ float score_of(const float* q, const CacheRow<T, HD>& k,
                                          float head_scale) {
  constexpr int E = CacheRow<T, HD>::kE;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < HD / E; ++i) {
    float kf[E];
    unpack16(k.v[i], kf, T());
#pragma unroll
    for (int e = 0; e < E; ++e) acc = fmaf(q[i * E + e], kf[e], acc);
  }
  return rnd<T>(rnd<T>(acc) / head_scale);
}

__device__ __forceinline__ void online_add(float& m, float& l, float sc) {
  if (sc > m) {
    l = l * expf(m - sc) + 1.f;
    m = sc;
  } else {
    l += expf(sc - m);
  }
}

// A warp's (max, sum of exp(s - max)) over keys [k0, k1): a key a lane, two
// rows of keys in flight, merged over the warp; every lane gets the result.
template <typename T, int HD>
__device__ __forceinline__ float2 score_stats(const float* q, const T* K, int k0, int k1,
                                              float head_scale) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY, l = 0.f;
  for (int base = k0; base < k1; base += 64) {
    const int ta = base + lane, tb = ta + 32;
    CacheRow<T, HD> ka, kb;
    if (ta < k1) ka.load(K + (size_t)ta * HD);
    if (tb < k1) kb.load(K + (size_t)tb * HD);
    if (ta < k1) online_add(m, l, score_of<T, HD>(q, ka, head_scale));
    if (tb < k1) online_add(m, l, score_of<T, HD>(q, kb, head_scale));
  }
  const float mm = warp_max(m);
  return make_float2(mm, warp_sum(m == -INFINITY ? 0.f : l * expf(m - mm)));
}

// Sum over the warp of HD values a lane, scattered: afterwards lane l holds
// dimensions (l >> (5 - h)) * nf + i, i < nf, in acc[i], where h = log2 of
// min(HD, 32) and nf = max(1, HD / 32); lanes that share a dimension hold the
// same sum.
template <int HD>
__device__ __forceinline__ void warp_reduce_scatter(float (&acc)[HD]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int o = 16 >> s, n = HD >> s;
    if (n >= 2) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = up ? acc[i] : acc[i + n / 2];
        const float keep = up ? acc[i + n / 2] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
    }
  }
}

// A warp's sum over keys [k0, k1) of round(exp(s - M) / L) * V[tau]: a key a
// lane, its K and V rows loaded together; reduce-scattered over the warp.
template <typename T, int HD>
__device__ __forceinline__ void weighted_values(const float* q, const T* K, const T* Vc, int k0,
                                                int k1, float M, float L, float head_scale,
                                                float (&acc)[HD]) {
  const int lane = threadIdx.x & 31;
  constexpr int E = CacheRow<T, HD>::kE;
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int tau = k0 + lane; tau < k1; tau += 32) {
    CacheRow<T, HD> kr, vr;
    kr.load(K + (size_t)tau * HD);
    vr.load(Vc + (size_t)tau * HD);
    const float p = rnd<T>(expf(score_of<T, HD>(q, kr, head_scale) - M) / L);
#pragma unroll
    for (int i = 0; i < HD / E; ++i) {
      float vf[E];
      unpack16(vr.v[i], vf, T());
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i * E + e] = fmaf(p, vf[e], acc[i * E + e]);
    }
  }
  warp_reduce_scatter<HD>(acc);
}

// The same for a head dimension known only at run time (HD = 0 below):
// scalar loads, keys summed in the same order, and P.V in pieces of 32
// dimensions with the probabilities recomputed for each piece.
template <typename T>
__device__ __forceinline__ float score_rt(const float* q, const T* k, int hd, float head_scale) {
  float acc = 0.f;
  for (int d = 0; d < hd; ++d) acc = fmaf(q[d], to_f(k[d]), acc);
  return rnd<T>(rnd<T>(acc) / head_scale);
}

template <typename T>
__device__ __forceinline__ float2 score_stats_rt(const float* q, const T* K, int k0, int k1,
                                                 int hd, float head_scale) {
  float m = -INFINITY, l = 0.f;
  for (int tau = k0 + (threadIdx.x & 31); tau < k1; tau += 32)
    online_add(m, l, score_rt<T>(q, K + (size_t)tau * hd, hd, head_scale));
  const float mm = warp_max(m);
  return make_float2(mm, warp_sum(m == -INFINITY ? 0.f : l * expf(m - mm)));
}

template <typename T, typename Sink>
__device__ __forceinline__ void weighted_values_rt(const float* q, const T* K, const T* Vc, int k0,
                                                   int k1, float M, float L, int hd,
                                                   float head_scale, Sink sink) {
  const int lane = threadIdx.x & 31;
  for (int d0 = 0; d0 < hd; d0 += 32) {
    const int nd = min(32, hd - d0);
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    for (int tau = k0 + lane; tau < k1; tau += 32) {
      const float p = rnd<T>(expf(score_rt<T>(q, K + (size_t)tau * hd, hd, head_scale) - M) / L);
      const T* v = Vc + (size_t)tau * hd + d0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < nd) acc[j] = fmaf(p, to_f(v[j]), acc[j]);
    }
    warp_reduce_scatter<32>(acc);
    if (lane < nd) sink(d0 + lane, acc[0]);
  }
}

// A (row, head) item over keys [k0, k1): (max, sum of exp(s - max)) on
// every lane, and sink(d, sum over the keys of p * V[.][d]) once for every
// dimension d.
template <typename T, int HD>
__device__ __forceinline__ float2 item_stats(const float* q, const T* K, int k0, int k1, int hd,
                                             float head_scale) {
  if constexpr (HD > 0) return score_stats<T, HD>(q, K, k0, k1, head_scale);
  else return score_stats_rt<T>(q, K, k0, k1, hd, head_scale);
}

template <typename T, int HD, typename Sink>
__device__ __forceinline__ void item_values(const float* q, const T* K, const T* Vc, int k0,
                                            int k1, float M, float L, int hd, float head_scale,
                                            Sink sink) {
  if constexpr (HD > 0) {
    constexpr int h = HD >= 32 ? 5 : (HD == 16 ? 4 : 3), nf = HD >= 32 ? HD / 32 : 1;
    const int lane = threadIdx.x & 31;
    float acc[HD];
    weighted_values<T, HD>(q, K, Vc, k0, k1, M, L, head_scale, acc);
    if ((lane & ((1 << (5 - h)) - 1)) == 0) {
#pragma unroll
      for (int i = 0; i < nf; ++i) sink((lane >> (5 - h)) * nf + i, acc[i]);
    }
  } else {
    weighted_values_rt<T>(q, K, Vc, k0, k1, M, L, hd, head_scale, sink);
  }
}

// The attention of this block's (row, head) items at position t over the
// cache rows written so far; the context goes (rounded to T) into ctx of
// every block of the cluster. An item has a warp, or several on key ranges
// when items are fewer than warps.
template <typename T, int HD>
__device__ void attend(const MstFusedDecodeArgs& a, const T* cache, size_t v_off, int l, int t,
                       int row0, int R, const Dims& dm, int rank, const Smem<T>& s) {
  const int hd = HD > 0 ? HD : dm.HD;
  const int Hc = dm.Hc, nq = Hc * hd, ld = a.D + kLdPad, C = dm.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = t + 1, items = R * Hc;
  int S = 1;
  if (items < kWarps) S = max(1, min(kWarps / items, (n + 31) / 32));
  auto head_base = [&](int r, int hl) {
    return (((size_t)l * 2 * a.B + row0 + r) * a.H + rank * Hc + hl) * (size_t)a.T * hd;
  };
  auto write_ctx = [&](int r, int hl, int d, float v) {
    const T out = from_f<T>(v);
    const size_t o = (size_t)r * ld + (rank * Hc + hl) * hd + d;
    for (int c = 0; c < C; ++c) cluster.map_shared_rank(s.ctx, c)[o] = out;
  };
  PH_BEGIN(t1);
  if (S == 1) {
    for (int it = warp; it < items; it += kWarps) {
      const int r = it / Hc, hl = it - r * Hc;
      const float* q = s.qkv + (size_t)r * 3 * nq + hl * hd;
      const T* K = cache + head_base(r, hl);
      const float2 ml = item_stats<T, HD>(q, K, 0, n, hd, a.head_scale);
      item_values<T, HD>(q, K, K + v_off, 0, n, ml.x, ml.y, hd, a.head_scale,
                         [&](int d, float v) { write_ctx(r, hl, d, rnd<T>(v)); });
    }
    PH_END(kPhPV, t1);
    return;
  }
  const int units = items * S, it = warp % items, sp = warp / items;
  const int r = it / Hc, hl = it - r * Hc;
  const int k0 = sp * n / S, k1 = (sp + 1) * n / S;
  const float* q = s.qkv + (size_t)r * 3 * nq + hl * hd;
  const T* K = cache + head_base(r, hl);
  if (warp < units) {
    const float2 ml = item_stats<T, HD>(q, K, k0, k1, hd, a.head_scale);
    if (lane == 0) { s.ml[2 * warp] = ml.x; s.ml[2 * warp + 1] = ml.y; }
  }
  block_sync();
  PH_END(kPhScores, t1);
  PH_BEGIN(t2);
  if (warp < units) {
    float M = -INFINITY, Lsum = 0.f;
    for (int k = 0; k < S; ++k) M = fmaxf(M, s.ml[2 * (k * items + it)]);
    for (int k = 0; k < S; ++k) {
      const float mk = s.ml[2 * (k * items + it)];
      if (mk != -INFINITY) Lsum += s.ml[2 * (k * items + it) + 1] * expf(mk - M);
    }
    PH_END(kPhSoftmax, t2);
    item_values<T, HD>(q, K, K + v_off, k0, k1, M, Lsum, hd, a.head_scale,
                       [&](int d, float v) { s.cpart[warp * hd + d] = v; });
  }
  block_sync();
  for (int i = threadIdx.x; i < items * hd; i += kThreads) {
    const int j = i / hd, d = i - j * hd;
    float sum = s.cpart[j * hd + d];
    for (int k = 1; k < S; ++k) sum += s.cpart[(k * items + j) * hd + d];
    write_ctx(j / Hc, j % Hc, d, rnd<T>(sum));
  }
  PH_END(kPhPV, t2);
}

// Self-attention of layer l at position t on this block's heads, for the
// group's rows: q, k, v of those heads, the cache write, and the context,
// written (rounded to T) into ctx of every block of the cluster. `slice` is
// the block's resident rows of Wqkv, or null.
template <typename T, int HD>
__device__ void attention(const MstFusedDecodeArgs& a, const Layer<T>& L, const T* slice,
                          const T* in, int l, int t, int row0, int R, const Dims& dm, int rank,
                          const Smem<T>& s) {
  const int hd = HD > 0 ? HD : dm.HD;
  const int D = a.D, Hc = dm.Hc, nq = Hc * hd, ld = D + kLdPad;
  PH_BEGIN(t0);
  auto qkv_row = [=](int j) {
    const int p = j / nq;
    return p * D + rank * nq + (j - p * nq);
  };
  const bool res = slice != nullptr;
  product(in, ld, R, D, res ? slice : L.wqkv, res ? D + dm.wpad() : D, res, 1 << 30, 3 * nq,
          [=](int j) { return res ? j : qkv_row(j); }, s.part);
  block_sync();
  // q stays in shared memory; this position's keys and values of the block's
  // heads go to the cache [NL, 2, B, H, T, hd]
  T* cache = static_cast<T*>(a.cache);
  const size_t head_len = (size_t)a.T * hd, v_off = (size_t)a.B * a.H * head_len;
  finish(s.part, R, 3 * nq, split_of(3 * nq / 8, D), [&](int r, int j, float acc) {
    const float v = rnd<T>(rnd<T>(acc) + to_f(L.bqkv[qkv_row(j)]));
    if (j < nq) {
      s.qkv[(size_t)r * 3 * nq + j] = v;
      return;
    }
    const int w = (j - nq) % nq;
    cache[(((size_t)l * 2 * a.B + row0 + r) * a.H + rank * Hc + w / hd) * head_len +
          (size_t)t * hd + w % hd + (j >= 2 * nq ? v_off : 0)] = from_f<T>(v);
  });
  block_sync();
  PH_END(kPhQkv, t0);
  attend<T, HD>(a, cache, v_off, l, t, row0, R, dm, rank, s);
}

// Copy the rows row_of(j), j < n, of W ([.][K] T, 16-byte pieces) into the
// resident slice dst ([n][K + pad]); rows >= nvalid become zeros.
template <typename T, typename RowOf>
__device__ void copy_slice(const T* W, int K, int n, int nvalid, RowOf row_of, T* dst) {
  constexpr int E = 16 / sizeof(T);
  const int pieces = K / E, ldd = K + kSlicePad / (int)sizeof(T);
  for (int i = threadIdx.x; i < n * pieces; i += kThreads) {
    const int j = i / pieces, c = i - j * pieces, wr = row_of(j);
    *reinterpret_cast<uint4*>(dst + (size_t)j * ldd + c * E) =
        wr < nvalid ? __ldg(reinterpret_cast<const uint4*>(W + (size_t)wr * K) + c)
                    : make_uint4(0, 0, 0, 0);
  }
}

// x = round(round(scale * e) + pos[t]) for row b's token `tok` (e its
// embedding, plus the class row under per_step), by one warp.
template <typename T>
__device__ __forceinline__ void embed_row(const MstFusedDecodeArgs& a, T* x, int b, int t,
                                          int tok) {
  const T* emb = static_cast<const T*>(a.emb) + (size_t)tok * a.D;
  const T* pos = static_cast<const T*>(a.pos) + (size_t)t * a.D;
  for (int d = threadIdx.x & 31; d < a.D; d += 32) {
    float e = to_f(emb[d]);
    if (a.per_step)
      e = rnd<T>(e + to_f(static_cast<const T*>(a.step_bias)[(size_t)b * a.D + d]));
    x[d] = from_f<T>(rnd<T>(a.scale * e) + to_f(pos[d]));
  }
}

// The next token of row b from its logits lg and (sample mode) noise, by one
// warp, a vocabulary of V <= 32 * kMaxVLane held in registers; `lse` gets
// the row's logsumexp.
__device__ __forceinline__ int pick_narrow(const MstFusedDecodeArgs& a, const float* lg,
                                           const float* noise, int b, int t, float& lse) {
  const int lane = threadIdx.x & 31, V = a.V;
  float x[kMaxVLane];
#pragma unroll
  for (int i = 0; i < kMaxVLane; ++i) {
    const int v = lane + 32 * i;
    x[i] = v < V ? lg[v] : -INFINITY;
  }
  int nxt;
  if (a.mode == kForced) {
    nxt = static_cast<const int*>(a.forced)[(size_t)b * a.T + t];
  } else if (a.mode == kGreedy) {
    float best = -INFINITY;
    int bi = INT32_MAX;
#pragma unroll
    for (int i = 0; i < kMaxVLane; ++i)
      if (lane + 32 * i < V) argmax_merge(best, bi, x[i], lane + 32 * i);
    nxt = warp_argmax(best, bi);
  } else {
    float wv[kMaxVLane], w[kMaxVLane];
    int keys[kMaxVLane];
#pragma unroll
    for (int i = 0; i < kMaxVLane; ++i) wv[i] = x[i] / a.temperature;
    if (a.top_k > 0 && a.top_k < V) {
#pragma unroll
      for (int i = 0; i < kMaxVLane; ++i) {
        const bool ok = lane + 32 * i < V;
        keys[i] = ok ? sort_key(wv[i]) : INT32_MIN;
        w[i] = ok ? 1.f : 0.f;
      }
      const int thr = warp_threshold_key(keys, w, (float)a.top_k);
#pragma unroll
      for (int i = 0; i < kMaxVLane; ++i)
        if (keys[i] < thr) wv[i] = kNegInf;
    }
    if (a.top_p > 0.f && a.top_p < 1.f) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kMaxVLane; ++i) {
        const bool ok = lane + 32 * i < V;
        keys[i] = ok ? sort_key(wv[i]) : INT32_MIN;
        if (ok) m = fmaxf(m, wv[i]);
      }
      m = warp_max(m);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxVLane; ++i) {
        w[i] = lane + 32 * i < V ? expf(wv[i] - m) : 0.f;
        part += w[i];
      }
      const float sum = warp_sum(part);
#pragma unroll
      for (int i = 0; i < kMaxVLane; ++i) w[i] /= sum;
      const int thr = warp_threshold_key(keys, w, a.top_p);
#pragma unroll
      for (int i = 0; i < kMaxVLane; ++i)
        if (keys[i] < thr) wv[i] = kNegInf;
    }
    float best = -INFINITY;
    int bi = INT32_MAX;
#pragma unroll
    for (int i = 0; i < kMaxVLane; ++i) {
      const int v = lane + 32 * i;
      if (v < V) argmax_merge(best, bi, wv[i] + noise[v], v);
    }
    nxt = warp_argmax(best, bi);
  }
  // -log p of the emitted token under the unfiltered, untempered logits.
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxVLane; ++i) m = fmaxf(m, x[i]);
  m = warp_max(m);
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVLane; ++i)
    if (lane + 32 * i < V) part += expf(x[i] - m);
  lse = logf(warp_sum(part)) + m;
  return nxt;
}

// The same for any vocabulary: every pass reads the logits from shared
// memory (a lane takes entries lane, lane + 32, ...: the sums run in the
// order of the register version). The scaled logit of entry v after the
// top-k filter is recomputed where it is needed.
__device__ __forceinline__ int pick_wide(const MstFusedDecodeArgs& a, const float* lg,
                                         const float* noise, int b, int t, float& lse) {
  const int lane = threadIdx.x & 31, V = a.V;
  int nxt;
  if (a.mode == kForced) {
    nxt = static_cast<const int*>(a.forced)[(size_t)b * a.T + t];
  } else if (a.mode == kGreedy) {
    float best = -INFINITY;
    int bi = INT32_MAX;
    for (int v = lane; v < V; v += 32) argmax_merge(best, bi, lg[v], v);
    nxt = warp_argmax(best, bi);
  } else {
    const bool use_k = a.top_k > 0 && a.top_k < V;
    int thr_k = INT32_MIN;
    if (use_k) {  // the least key with fewer than top_k entries above it
      int lo = INT32_MIN, hi = INT32_MAX;
      for (int it = 0; it < kFilterIters; ++it) {
        const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
        float part = 0.f;
        for (int v = lane; v < V; v += 32)
          if (sort_key(lg[v] / a.temperature) > mid) part += 1.f;
        if (warp_sum(part) < (float)a.top_k) hi = mid; else lo = mid;
      }
      thr_k = hi;
    }
    auto scaled = [&](int v) {
      const float w = lg[v] / a.temperature;
      return use_k && sort_key(w) < thr_k ? kNegInf : w;
    };
    int thr_p = INT32_MIN;
    if (a.top_p > 0.f && a.top_p < 1.f) {
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, scaled(v));
      m = warp_max(m);
      float part = 0.f;
      for (int v = lane; v < V; v += 32) part += expf(scaled(v) - m);
      const float sum = warp_sum(part);
      int lo = INT32_MIN, hi = INT32_MAX;
      for (int it = 0; it < kFilterIters; ++it) {
        const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
        float acc = 0.f;
        for (int v = lane; v < V; v += 32) {
          const float w = scaled(v);
          if (sort_key(w) > mid) acc += expf(w - m) / sum;
        }
        if (warp_sum(acc) < a.top_p) hi = mid; else lo = mid;
      }
      thr_p = hi;
    }
    float best = -INFINITY;
    int bi = INT32_MAX;
    for (int v = lane; v < V; v += 32) {
      const float w = scaled(v);
      argmax_merge(best, bi, (sort_key(w) < thr_p ? kNegInf : w) + noise[v], v);
    }
    nxt = warp_argmax(best, bi);
  }
  float m = -INFINITY;
  for (int v = lane; v < V; v += 32) m = fmaxf(m, lg[v]);
  m = warp_max(m);
  float part = 0.f;
  for (int v = lane; v < V; v += 32) part += expf(lg[v] - m);
  lse = logf(warp_sum(part)) + m;
  return nxt;
}

// The next token of each row, one warp a row, in every block alike; block 0
// of the cluster writes the outputs; the warp then writes the row's input of
// the next position.
template <typename T>
__device__ void choose_tokens(const MstFusedDecodeArgs& a, int row0, int R, int t, int rank,
                              const Smem<T>& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, V = a.V, T_ = a.T;
  for (int r = warp; r < R; r += kWarps) {
    const int b = row0 + r;
    const float* lg = s.lg + (size_t)r * V;
    const float* noise = s.noise + (size_t)r * V;
    float lse;
    // Both give the same tokens. Under top-k or top-p the register version
    // holds each bisection's weights, which pick_wide recomputes: at the
    // serving launch it is 2.1x faster with top-k 30 and top-p 0.9 (pick_wide
    // 1.4% faster without them; scripts/k1-variants.py serving, PERF.md).
    const int nxt = V <= 32 * kMaxVLane ? pick_narrow(a, lg, noise, b, t, lse)
                                        : pick_wide(a, lg, noise, b, t, lse);
    if (lane == 0) {
      const int done = s.done[r];
      if (!done) s.score[r] += lse - lg[nxt];
      int out = nxt;
      if (a.mode != kForced) {
        if (done) out = kPad;
        else if (nxt == kEos) s.done[r] = 1;
      }
      s.tok[r] = out;
      if (rank == 0) static_cast<int*>(a.seqs)[(size_t)b * T_ + t] = out;
    }
    if (a.mode == kForced && rank == 0) {
      float* out = static_cast<float*>(a.logits) + ((size_t)b * T_ + t) * V;
      for (int v = lane; v < V; v += 32) out[v] = lg[v];
    }
    // the next position's input row: the embedding of the emitted token
    const int tok = __shfl_sync(0xffffffffu, s.tok[r], 0);
    if (t + 1 < T_) embed_row<T>(a, s.x + (size_t)r * (a.D + kLdPad), b, t + 1, tok);
  }
}

// One kernel per head dimension (8, 16, 32, 64; HD = 0 takes any other at
// run time): its registers are allocated for its own attention alone (with
// all four in one kernel, the hd=64 code's pressure made the hd=16/32 paths
// spill: 10-22% slower).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_kernel(const MstFusedDecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster, rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / C) * a.rows, R = min(a.rows, a.B - row0);
  const int D = a.D, FF = a.FF, V = a.V, ld = D + kLdPad, ldh = FF + kLdPad;
  const Dims dm = {a.rows, D, FF, V, D / a.H, a.H / C, C, (int)sizeof(T), a.NL, a.resident};
  size_t off[kNBuf + 1];
  smem_layout(dm, off);
  Smem<T> s;
  s.x = reinterpret_cast<T*>(smem + off[kX]);
  s.a = reinterpret_cast<T*>(smem + off[kA]);
  s.ctx = reinterpret_cast<T*>(smem + off[kCtx]);
  s.hid = reinterpret_cast<T*>(smem + off[kHid]);
  s.qkv = reinterpret_cast<float*>(smem + off[kQkv]);
  s.lg = reinterpret_cast<float*>(smem + off[kLg]);
  s.part = reinterpret_cast<float*>(smem + off[kPart]);
  s.noise = reinterpret_cast<float*>(smem + off[kNoise]);
  s.ml = reinterpret_cast<float*>(smem + off[kMl]);
  s.cpart = reinterpret_cast<float*>(smem + off[kCpart]);
  s.tok = reinterpret_cast<int*>(smem + off[kTok]);
  s.done = reinterpret_cast<int*>(smem + off[kDone]);
  s.score = reinterpret_cast<float*>(smem + off[kScore]);
  s.w = reinterpret_cast<T*>(smem + off[kW]);
  s.whead = reinterpret_cast<float*>(smem + off[kW] + (size_t)a.NL * dm.slice_layer() * sizeof(T));

  const T* pos = static_cast<const T*>(a.pos);
  const T* x0 = static_cast<const T*>(a.x0);
  const float* fln = static_cast<const float*>(a.wf) + (size_t)a.NL * 4 * D;
  const float* head = fln + 2 * D;
  const float* head_b = head + (size_t)V * D;
  const int Vb = dm.nb_head(), col_o = rank * (D / C), col_ff = rank * (FF / C);
  const int col_v = rank * Vb, nq = dm.nb_qkv() / 3, wp = dm.wpad();
  // Resident slices of layer l: qkv, o, ff1, ff2 (null: streamed from L2)
  auto slice = [&](int l, int which) -> T* {
    if (!a.resident) return nullptr;
    T* w = s.w + (size_t)l * dm.slice_layer();
    const size_t n[3] = {(size_t)3 * nq * (D + wp), (size_t)(D / C) * (D + wp),
                         (size_t)(FF / C) * (D + wp)};
    for (int i = 0; i < which; ++i) w += n[i];
    return w;
  };
  if (a.resident) {
    for (int l = 0; l < a.NL; ++l) {
      const Layer<T> L = layer_weights<T>(a, l);
      copy_slice(L.wqkv, D, 3 * nq, 1 << 30, [=](int j) {
        const int p = j / nq;
        return p * D + rank * nq + (j - p * nq);
      }, slice(l, 0));
      copy_slice(L.wo, D, D / C, 1 << 30, [=](int j) { return col_o + j; },
                 slice(l, 1));
      copy_slice(L.w1, D, FF / C, 1 << 30, [=](int j) { return col_ff + j; },
                 slice(l, 2));
      copy_slice(L.w2, FF, D / C, 1 << 30, [=](int j) { return col_o + j; },
                 slice(l, 3));
    }
    copy_slice(head, D, Vb, V, [=](int j) { return col_v + j; }, s.whead);
  }

  if (threadIdx.x < kMaxRows) {
    s.tok[threadIdx.x] = kSos;
    s.done[threadIdx.x] = 0;
    s.score[threadIdx.x] = 0.f;
  }
#ifdef MST_K1_PHASES
  if (threadIdx.x < 16) mst_ph[threadIdx.x] = 0;
#endif
  cluster.sync();  // every block of the cluster runs before the first remote write
  PH_BEGIN(t_whole);

  for (int t = 0; t < a.T; ++t) {
    if (t == 0) {  // position 0: the conditioning state (later rows: choose_tokens)
      for (int i = threadIdx.x; i < R * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        const float e = to_f(x0[(size_t)(row0 + r) * D + d]);
        s.x[(size_t)r * ld + d] = from_f<T>(rnd<T>(a.scale * e) + to_f(pos[d]));
      }
      block_sync();
    }

    for (int l = 0; l < a.NL; ++l) {
      const Layer<T> L = layer_weights<T>(a, l);
      const T* in = s.x;
      if (a.pre_ln) {
        PH_BEGIN(tl);
        layer_norm_rows(s.x, s.a, R, a.Dl, D, ld, L.ln1s, L.ln1b);
        block_sync();
        PH_END(kPhLN, tl);
        in = s.a;
      }
      attention<T, HD>(a, L, slice(l, 0), in, l, t, row0, R, dm, rank, s);
      cluster_sync();
      PH_BEGIN(to);
      // the residual stream x (pre-LN) or LN1's input a (post-LN) = round(x + attention)
      dense_cluster(s.ctx, ld, R, D, L.wo, slice(l, 1), L.bo, col_o, D / C, false, s.x,
                    a.pre_ln ? s.x : s.a, ld, s.part, C);
      cluster_sync();
      PH_END(kPhO, to);
      PH_BEGIN(tn);
      if (a.pre_ln) layer_norm_rows(s.x, s.a, R, a.Dl, D, ld, L.ln2s, L.ln2b);
      else layer_norm_rows(s.a, s.x, R, a.Dl, D, ld, L.ln1s, L.ln1b);
      block_sync();
      PH_END(kPhLN, tn);
      PH_BEGIN(t1);
      dense_cluster(a.pre_ln ? s.a : s.x, ld, R, D, L.w1, slice(l, 2), L.b1, col_ff, FF / C,
                    true, static_cast<const T*>(nullptr), s.hid, ldh, s.part, C);
      cluster_sync();
      PH_END(kPhFF1, t1);
      PH_BEGIN(t2);
      dense_cluster(s.hid, ldh, R, FF, L.w2, slice(l, 3), L.b2, col_o, D / C, false, s.x,
                    a.pre_ln ? s.x : s.a, ld, s.part, C);
      cluster_sync();
      PH_END(kPhFF2, t2);
      if (!a.pre_ln) {
        PH_BEGIN(tn2);
        layer_norm_rows(s.a, s.x, R, a.Dl, D, ld, L.ln2s, L.ln2b);
        block_sync();
        PH_END(kPhLN, tn2);
      }
    }
    const T* h = s.x;
    if (a.pre_ln) {
      PH_BEGIN(tf);
      layer_norm_rows(s.x, s.a, R, a.Dl, D, ld, fln, fln + D);
      block_sync();
      PH_END(kPhLN, tf);
      h = s.a;
    }
    if (t == 0) {  // the conditioning position's head output is unused
      if (rank == 0 && threadIdx.x < R)
        static_cast<int*>(a.seqs)[(size_t)(row0 + threadIdx.x) * a.T] = kSos;
      const int warp = threadIdx.x >> 5;  // position 1's input: SOS
      for (int r = warp; r < R && a.T > 1; r += kWarps)
        embed_row<T>(a, s.x + (size_t)r * ld, row0 + r, 1, kSos);
      block_sync();
      continue;
    }

    PH_BEGIN(th);
    const bool sample = a.mode != kForced && a.mode != kGreedy;
    if (a.resident)
      product_fma(h, ld, R, D, s.whead, D + kSlicePad / 4, Vb, Vb, [](int j) { return j; },
                  s.part);
    else
      product_fma(h, ld, R, D, head, D, V, Vb, [col_v](int j) { return col_v + j; }, s.part);
    block_sync();
    finish(s.part, R, Vb, split_of(Vb / 8, D), [&](int r, int j, float acc) {
      const int col = col_v + j;
      if (col >= V) return;
      const float v = acc + head_b[col];
      const size_t o = (size_t)r * V + col;
      for (int c = 0; c < C; ++c) cluster.map_shared_rank(s.lg, c)[o] = v;
      if (sample) {  // the Gumbel noise of the block's columns travels with them
        const float u = uniform_open01(philox_bits((uint32_t)(row0 + r), (uint32_t)t,
                                                   (uint32_t)col, a.seed));
        const float g = -logf(-logf(u));
        for (int c = 0; c < C; ++c) cluster.map_shared_rank(s.noise, c)[o] = g;
      }
    });
    cluster_sync();
    PH_END(kPhHead, th);

    PH_BEGIN(tc);
    choose_tokens<T>(a, row0, R, t, rank, s);
    block_sync();
    PH_END(kPhToken, tc);
    if (a.mode != kForced) {
      bool all_done = true;
      for (int r = 0; r < R; ++r) all_done = all_done && s.done[r];
      if (all_done) break;
    }
  }
  PH_END(kPhWhole, t_whole);
  if (rank == 0 && threadIdx.x < R) static_cast<float*>(a.scores)[row0 + threadIdx.x] = s.score[threadIdx.x];
#ifdef MST_K1_PHASES
  if (threadIdx.x == 0)
    for (int i = 0; i < 16; ++i) atomicAdd(&mst_ph_total[i], mst_ph[i]);
#endif
  cluster.sync();  // no block leaves while another may still write into its memory
}

template <typename T, int HD>
cudaError_t launch(const MstFusedDecodeArgs& a, cudaStream_t stream) {
  const Dims dm = {a.rows, a.D, a.FF, a.V, a.D / a.H, a.H / a.cluster, a.cluster, (int)sizeof(T),
                   a.NL, a.resident};
  const size_t smem = smem_layout(dm, nullptr);
  if (smem > 232448) return cudaErrorInvalidValue;
  void (*kernel)(const MstFusedDecodeArgs) = fused_decode_kernel<T, HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((a.B + a.rows - 1) / a.rows) * a.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, a);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace

extern "C" int mst_fused_decode(const MstFusedDecodeArgs* a, void* stream) {
  const int hd = a->H >= 1 ? a->D / a->H : 0, C = a->cluster;
  const bool ok = a->B >= 1 && a->T >= 1 && a->H >= 1 && a->D % a->H == 0 && a->NL >= 1 &&
                  a->D % 32 == 0 && a->FF % 32 == 0 && a->V >= 1 && a->Dl >= 1 &&
                  a->Dl <= a->D &&
                  a->rows >= 1 && a->rows <= kMaxRows && C >= 1 && C <= kMaxCluster &&
                  a->H % C == 0 && a->D % (8 * C) == 0 && a->FF % (8 * C) == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_bf16) {
    switch (hd) {
      case 8: return (int)launch<__nv_bfloat16, 8>(*a, s);
      case 16: return (int)launch<__nv_bfloat16, 16>(*a, s);
      case 32: return (int)launch<__nv_bfloat16, 32>(*a, s);
      case 64: return (int)launch<__nv_bfloat16, 64>(*a, s);
      default: return (int)launch<__nv_bfloat16, 0>(*a, s);
    }
  }
  switch (hd) {
    case 8: return (int)launch<float, 8>(*a, s);
    case 16: return (int)launch<float, 16>(*a, s);
    case 32: return (int)launch<float, 32>(*a, s);
    case 64: return (int)launch<float, 64>(*a, s);
    default: return (int)launch<float, 0>(*a, s);
  }
}

// The clusters of `cluster` blocks the card runs at once (one block an SM:
// a block's 256 threads at up to 255 registers fill an SM's register file).
extern "C" int mst_fused_decode_clusters(int cluster, int* out) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, fused_decode_kernel<__nv_bfloat16, 32>, &cfg);
}

extern "C" const char* mst_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef MST_K1_PHASES
extern "C" int mst_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, mst_ph_total, sizeof(mst_ph_total));
}
extern "C" int mst_phase_reset() {
  static const unsigned long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(mst_ph_total, zero, sizeof(zero));
}
#endif
