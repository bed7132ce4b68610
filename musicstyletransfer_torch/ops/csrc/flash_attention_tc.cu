// K4 (forward) and K5 (backward) on the tensor cores of Hopper (sm_90a):
// flash attention over bf16 q, k, v [B, H, T, HD], HD = 32 or 64, with prefix
// key lengths and an optional causal mask.
//
// Replaces musicstyletransfer_tpu/ops/flash_attention.py, as
// flash_attention.cu does and with the same interface (MstFlashArgs):
// - flash_fwd_kernel_tc replaces K4a, _flash_forward_with_lse (Pallas kernel
//   _flash_kernel), and K4b, _flash_forward_streaming (_flash_stream_kernel);
// - flash_bwd_delta_kernel_tc, flash_bwd_dq_kernel_tc and
//   flash_bwd_dkdv_kernel_tc replace K5a, _flash_backward (_dqkv_kernel), and
//   K5b/K5c, _flash_backward_streaming (_dq_stream_kernel,
//   _dkv_stream_kernel).
// flash_attention.cu keeps float32 inputs and the other head dimensions.
//
// What bounds it: operations. At the long training shapes (B=4, H=8; encoder
// T=2047, HD=64; decoder T=2048, HD=32, causal) the forward needs 4*HD flops
// per unmasked (query, key) pair, 24.6 and 7.4 GFLOP, 25 and 7.5 us at the
// 989 TFLOP/s bf16 peak of the tensor cores against 10 and 5 us for the
// bytes; the backward 10*HD a pair (14*HD as done here, in two passes over
// the scores). CUDA-core float32 FMA (67 TFLOP/s) cannot come nearer than 15x
// that bound, so every matrix product here is a warpgroup matrix multiply
// (wgmma.mma_async m64nNk16, bf16 operands, float32 accumulators in
// registers). Beside the products, every pair costs one exponential (two in
// the backward) on the special function units, 16 a clock an SM against 16
// pairs' worth of products at HD=64, so the kernels must run the two side
// by side to come near the bound:
//
// - A consumer warpgroup (4 warps) owns 64 rows; a block is NWG of them and
//   one producer warpgroup. The rows' own operands (Q in the forward; Q and dO in the dQ kernel; K and V in the
//   dK/dV kernel) are read once from device memory straight into the
//   register layout of a wgmma A operand. The tiles a block walks over (K and
//   V; Q and dO in the dK/dV kernel) stay bf16 in shared memory, [rows, HD]
//   with the 128-byte (HD=64) or 64-byte (HD=32) swizzle of a wgmma matrix
//   descriptor, so one tile serves as the K-major B operand of the first
//   products (contraction over HD) and as the MN-major B operand (the
//   transpose flag) of the second ones (contraction over the tile's rows).
// - The accumulator fragment of a first product has the register layout of
//   an A operand: P (forward), dS (dQ kernel), P^T and dS^T (dK/dV kernel,
//   which computes S^T = K Q^T and dP^T = V dO^T directly) are rounded to
//   bf16 in registers and fed to the second products; nothing is transposed
//   or staged through shared memory.
// - Asynchronous copies: the producer warpgroup fills a ring of kStages
//   stages with 16-byte cp.async copies (rows past T arrive as zeros) and
//   hands each stage over through an mbarrier that completes when the copies
//   have landed; the consumers hand it back through a second one. The
//   producers give most of their registers to the consumers (setmaxnreg).
//   Nothing else ties the warpgroups of a block together, so one's
//   exponentials run beside another's products. The copies are not TMA: the
//   tiles' rows are only 16-byte aligned pieces of strided tensors, which
//   cp.async takes as they are, and the copies are not what bounds the
//   kernels (PERF.md has the measurements).
// - The backward stays three kernels without atomics or a [T, T] buffer:
//   delta, dQ (per query tile), dK/dV (per key tile, from the diagonal on),
//   so gradients are identical from run to run.
//
// Rounding points: the forward's are the reference's (q * sm_scale rounded to
// bf16 with the scale rounded first; float32 scores; masked scores -1e30;
// float32 online softmax; p rounded to bf16 before P.V; out = acc /
// max(l, 1e-30); lse = m + log l; no visible key: zeros and lse -1e30). The
// backward computes S from the raw bf16 q with a float32 sum and multiplies
// by the float32 scale afterwards, rounds P (for dV) and dS (for dQ, dK) to
// bf16 before the second products, and scales dQ and dK at the end; masked
// terms are selected away, never multiplied by zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_args.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kSentinel = -1e29f;  // lse at or below it: a row that sees no key

template <int HD> struct Cfg {
  static_assert(HD == 32 || HD == 64, "a tile row is one 64- or 128-byte swizzle span");
  static constexpr int ROWB = HD * 2;                    // bytes a tile row
  static constexpr int CHUNKS = ROWB / 16;               // 16-byte chunks a row
  static constexpr uint32_t XOR_MASK = ROWB == 128 ? 7u : 3u;
  static constexpr uint64_t SWIZZLE = ROWB == 128 ? 1 : 2;  // descriptor: 128B, 64B
  static constexpr int GROUP = 8 * ROWB;                 // 8 rows
};

// The (b, h) head of a strided [B, H, T, HD] tensor.
template <typename P>
__device__ __forceinline__ P* head(P* base, const long long* s, int b, int h) {
  return base + b * s[0] + h * s[1];
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// Tile shapes: keys (queries in the dK/dV kernel) a tile and consumer
// warpgroups a block, for each kernel, and the stages of a block's ring.
// PERF.md lists what else was tried on the card.
constexpr int kFwdTile = 128, kFwdGroups = 2;
constexpr int kDqTile = 64, kDqGroups = 2;
constexpr int kDkvTile = 64, kDkvGroups = 2;
constexpr int kStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special function unit; exponentials are taken as 2^(x log2 e)
// with the factor folded into a multiply-add.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ----------------------------------------------------------------------------
// Shared-memory tiles and their copies.

// Byte offset of logical offset `off` in a swizzled tile whose base is 1024-
// byte aligned: address bits [7, 10) (or [7, 9)) are xor-ed into the 16-byte
// chunk bits [4, 7) (or [4, 6)), as the wgmma descriptor's swizzle mode reads.
template <int HD> __device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & Cfg<HD>::XOR_MASK) << 4);
}

// Start the copy of rows first.. of a head (row stride `stride` elements)
// into an [R, HD] tile; rows at or past `end` arrive as zeros.
template <int HD, int R, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const bf16* rows, long long stride,
                                                int first, int end, int tid) {
  constexpr int CH = Cfg<HD>::CHUNKS, N = R * CH;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (N % NT != 0 && e >= N) break;
    const int r = e / CH, c = e % CH, row = first + r;
    const bool ok = row < end;
    const bf16* src = rows + (long long)(ok ? row : 0) * stride + c * 8;
    const uint32_t dst = tile + swz<HD>(r * Cfg<HD>::ROWB + c * 16);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0));
  }
}

// mbarriers in shared memory: a phase completes when the expected arrivals
// have come in; a waiter names the parity of the phase it waits for.
__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One arrival at `bar` once every copy this thread has started has landed.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Makes the tile the copies wrote visible to the tensor cores' reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------------------------
// wgmma: D[64, N] (+)= A[64, 16] B[16, N], A from registers, B from shared
// memory through a matrix descriptor; TB = 1 reads B MN-major.

// Descriptor of a swizzled [rows, HD] tile: the low word holds the start
// address (in 16-byte units) and the leading offset (unused: a tile is one
// swizzle span wide), the high word the stride offset (8 rows) and the
// swizzle mode. Tiles are 1024-byte aligned, so a step inside a tile adds
// to the low word without a carry into the next field.
template <int HD> __device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFFu) >> 4) | (1u << 16);
}
template <int HD> __device__ __forceinline__ uint64_t make_desc(uint32_t lo, int step_bytes) {
  constexpr uint32_t hi = (Cfg<HD>::GROUP >> 4) | ((uint32_t)Cfg<HD>::SWIZZLE << 30);
  return ((uint64_t)hi << 32) | (lo + (step_bytes >> 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching an accumulator while its product runs.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

// d = A B^T, contraction over HD: A fragments a[HD / 16], B the K-major
// [N, HD] tile at `tile`.
template <int HD, int NR>
__device__ __forceinline__ void mma_nt(float (&d)[NR], const uint32_t (&a)[HD / 16][4],
                                       uint32_t tile) {
  const uint32_t lo = desc_lo<HD>(tile);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs<0>(d, a[kk], make_desc<HD>(lo, kk * 32), kk > 0);
}

// d += A B, contraction over the KT rows of the [KT, HD] tile at `tile`
// (MN-major B): A fragments a[KT / 16].
template <int HD, int KT>
__device__ __forceinline__ void mma_nn(float (&d)[HD / 2], const uint32_t (&a)[KT / 16][4],
                                       uint32_t tile) {
  const uint32_t lo = desc_lo<HD>(tile);
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_rs<1>(d, a[kk], make_desc<HD>(lo, kk * 16 * Cfg<HD>::ROWB), 1);
}

// Fragment coordinates of a thread in its warpgroup's [64, N] tile: value
// 4 * j + e of an accumulator sits at row frag_row + 8 * (e >> 1), column
// 8 * j + frag_col + (e & 1); an A operand's register i of 16-column step kk
// holds row frag_row + 8 * (i & 1), columns 16 * kk + 8 * (i >> 1) + frag_col
// and the next one.
struct Frag {
  int row, col;
  __device__ Frag() {
    const int t = threadIdx.x % 128;
    row = (t / 32) * 16 + (t % 32) / 4;
    col = (t % 4) * 2;
  }
};

// The A fragments of rows first + f.row (+ 8) of a head; rows at or past
// `end` as zeros.
template <int HD>
__device__ __forceinline__ void load_frags(uint32_t (&a)[HD / 16][4], const bf16* rows,
                                           long long stride, int first, int end, Frag f) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = first + f.row + 8 * (i & 1), col = 16 * kk + 8 * (i >> 1) + f.col;
      a[kk][i] = row < end ? *reinterpret_cast<const uint32_t*>(rows + (long long)row * stride + col)
                           : 0u;
    }
}

// An accumulator (rounded to bf16) as the A fragments of the next product.
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = 4 * (2 * kk + (i >> 1)) + 2 * (i & 1);
      a[kk][i] = pack(d[at], d[at + 1]);
    }
}

// Write an accumulator as rows first + f.row (+ 8) of a head, rows below `end`.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* rows, long long stride, int first, int end, Frag f,
                                           const float (&d)[HD / 2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = first + f.row + 8 * half;
      if (row < end)
        *reinterpret_cast<uint32_t*>(rows + (long long)row * stride + 8 * j + f.col) =
            pack(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    }
}

// Sum (or maximum) over the four threads that share an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ----------------------------------------------------------------------------
// The pipeline of a block: its last warpgroup is the producer, which copies
// tile after tile into a ring of kStages stages; the consumer warpgroups
// before it wait for a stage to be full, work on it, and hand it back empty.
// full[s] completes when the copies of all 128 producer threads have landed,
// empty[s] when every consumer thread has arrived. Nothing else ties the
// warpgroups of a block together, so one's softmax runs beside another's
// matrix products.

// Registers a thread: a block of two consumer warpgroups and one producer
// starts every thread with the same count (168); the producers give most of
// theirs back and the consumers take them (setmaxnreg). 2 * 232 + 40 <= 512,
// the 64 K registers of an SM over the 128 lanes of a warpgroup.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
template <int N> __device__ __forceinline__ void regs_give_back() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int NWG> struct Ring {
  static_assert(NWG == 2, "the register split above is for two consumer warpgroups");
  uint32_t base;  // 1024-byte aligned: the barriers, then from base + 1024 the stages
  __device__ explicit Ring(const uint8_t* raw)
      : base(((uint32_t)__cvta_generic_to_shared(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 8 * (kStages + s); }
  // Every thread of the block, before the roles part.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(s), 128);
        mbar_init(empty(s), NWG * 128);
      }
    }
    __syncthreads();
  }
  // Producer: the stage of tile `it` is free again.
  __device__ void wait_empty(int it) const {
    if (it >= kStages) mbar_wait(empty(it % kStages), (it / kStages + 1) & 1);
  }
  // Producer: full[s] completes once this thread's copies so far have landed.
  __device__ void commit_full(int it) const { cp_async_mbar_arrive(full(it % kStages)); }
  // Consumer: tile `it` has landed and the tensor cores may read it.
  __device__ void wait_full(int it) const {
    mbar_wait(full(it % kStages), (it / kStages) & 1);
    fence_async_proxy();
  }
  __device__ void release(int it) const { mbar_arrive(empty(it % kStages)); }
};

// ----------------------------------------------------------------------------
// K4: forward. grid (ceil(T / (64 NWG)), H, B); a warpgroup owns 64 queries
// and walks BN-key tiles of K and V.

template <int HD, int BN, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 128, 1) flash_fwd_kernel_tc(const MstFlashArgs a) {
  constexpr int BM = NWG * 64, TILE = BN * Cfg<HD>::ROWB;
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG> ring(smem_raw);
  const uint32_t stages = ring.base + 1024;
  const int b = blockIdx.z, h = blockIdx.y;
  // Causal blocks near the end of the sequence have the most keys: first.
  const int q0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BM;
  const int Tn = a.T;
  const int valid = min(max(a.key_lens[b], 0), Tn);
  const int kend = a.causal ? min(valid, min(Tn, q0 + BM)) : valid;
  const int ntiles = (kend + BN - 1) / BN;
  ring.init();

  if (threadIdx.x >= NWG * 128) {  // the producer warpgroup
    regs_give_back<kProducerRegs>();
    const bf16* kh = head(static_cast<const bf16*>(a.k), a.sk, b, h);
    const bf16* vh = head(static_cast<const bf16*>(a.v), a.sv, b, h);
    const int lane = threadIdx.x % 128;
    for (int it = 0; it < ntiles; ++it) {
      const uint32_t ks = stages + (it % kStages) * 2 * TILE;
      ring.wait_empty(it);
      load_tile_async<HD, BN, 128>(ks, kh, a.sk[2], it * BN, Tn, lane);
      load_tile_async<HD, BN, 128>(ks + TILE, vh, a.sv[2], it * BN, Tn, lane);
      ring.commit_full(it);
    }
    return;
  }
  regs_take<kConsumerRegs>();

  const int w0 = q0 + (threadIdx.x / 128) * 64;
  const Frag f;
  uint32_t qf[HD / 16][4];  // q * sm_scale, rounded to bf16
  load_frags<HD>(qf, head(static_cast<const bf16*>(a.q), a.sq, b, h), a.sq[2], w0, Tn, f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack(qf[kk][i]);
      qf[kk][i] = pack(x.x * a.fwd_scale, x.y * a.fwd_scale);
    }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN;
    const uint32_t ks = stages + (it % kStages) * 2 * TILE, vs = ks + TILE;
    const bool active = !a.causal || k0 <= w0 + 63;  // else the tile is above the diagonal
    float s[BN / 2];
    ring.wait_full(it);
    if (active) {
      wgmma_fence();
      mma_nt<HD>(s, qf, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Mask the tiles that cross key_lens or the diagonal; a masked score is
      // -1e30 and its p = 2^(-1e30 log2e - ...) an exact zero.
      if (k0 + BN > valid || (a.causal && k0 + BN - 1 > w0)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = w0 + f.row + 8 * (e >> 1), col = k0 + 8 * j + f.col + (e & 1);
            if (!(col < valid && (!a.causal || col <= row))) s[4 * j + e] = kNegInf;
          }
      }
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * j + e]);
      float alpha[2], shift[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = quad_max(mt[r]);
        alpha[r] = ex2((m[r] - mt[r]) * kLog2e);
        // A row with no visible key yet has mt = -1e30: shift by 0, so its p are zeros.
        shift[r] = mt[r] > kSentinel ? mt[r] * kLog2e : 0.f;
        l[r] *= alpha[r];
        m[r] = mt[r];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * j + e], kLog2e, -shift[e >> 1]));
          l[e >> 1] += p;
          s[4 * j + e] = p;
        }
      uint32_t pf[BN / 16][4];
      to_frags<BN>(pf, s);
      // The running maximum of most rows stops growing after a few tiles.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      }
      wgmma_fence();
      mma_nn<HD, BN>(o, pf, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    ring.release(it);
  }

  float lm[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lm[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / lm[r];
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= inv[e >> 1];
  store_rows<HD>(head(static_cast<bf16*>(a.out), a.so, b, h), a.so[2], w0, Tn, f, o);
  if (f.col == 0) {
    float* lse = a.lse + ((size_t)b * a.H + h) * Tn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + f.row + 8 * r;
      if (row < Tn) lse[row] = m[r] + logf(lm[r]);
    }
  }
}

// ----------------------------------------------------------------------------
// K5, first kernel: delta = rowsum(dO * O) - g_lse; HD / 8 threads a row, 16
// bytes a thread. grid ceil(B H T / rows a block) blocks of 256 threads.

template <int HD>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel_tc(const MstFlashArgs a) {
  constexpr int TPR = HD / 8;
  const size_t rows = (size_t)a.B * a.H * a.T;
  const size_t row = (size_t)blockIdx.x * (256 / TPR) + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  float s = 0.f;
  if (row < rows) {
    const int t = row % a.T, h = (row / a.T) % a.H, b = row / ((size_t)a.T * a.H);
    const bf16* o = head(static_cast<const bf16*>(a.out), a.so, b, h) + t * a.so[2] + part * 8;
    const bf16* g = head(static_cast<const bf16*>(a.dout), a.sdo, b, h) + t * a.sdo[2] + part * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(o), gv = *reinterpret_cast<const uint4*>(g);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack(ow[i]), y = unpack(gw[i]);
      s = fmaf(y.x, x.x, s);
      s = fmaf(y.y, x.y, s);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && part == 0) a.delta[row] = a.g_lse != nullptr ? s - a.g_lse[row] : s;
}

// ----------------------------------------------------------------------------
// K5, second kernel: dQ. grid (ceil(T / (64 NWG)), H, B); a warpgroup owns
// 64 queries and walks BN-key tiles of K and V as the forward does.

template <int HD, int BN, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 128, 1)
    flash_bwd_dq_kernel_tc(const MstFlashArgs a) {
  constexpr int BM = NWG * 64, TILE = BN * Cfg<HD>::ROWB;
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG> ring(smem_raw);
  const uint32_t stages = ring.base + 1024;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BM;
  const int Tn = a.T;
  const int valid = min(max(a.key_lens[b], 0), Tn);
  const int kend = a.causal ? min(valid, min(Tn, q0 + BM)) : valid;
  const int ntiles = (kend + BN - 1) / BN;
  ring.init();

  if (threadIdx.x >= NWG * 128) {  // the producer warpgroup
    regs_give_back<kProducerRegs>();
    const bf16* kh = head(static_cast<const bf16*>(a.k), a.sk, b, h);
    const bf16* vh = head(static_cast<const bf16*>(a.v), a.sv, b, h);
    const int lane = threadIdx.x % 128;
    for (int it = 0; it < ntiles; ++it) {
      const uint32_t ks = stages + (it % kStages) * 2 * TILE;
      ring.wait_empty(it);
      load_tile_async<HD, BN, 128>(ks, kh, a.sk[2], it * BN, Tn, lane);
      load_tile_async<HD, BN, 128>(ks + TILE, vh, a.sv[2], it * BN, Tn, lane);
      ring.commit_full(it);
    }
    return;
  }
  regs_take<kConsumerRegs>();

  const int w0 = q0 + (threadIdx.x / 128) * 64;
  const Frag f;
  uint32_t qf[HD / 16][4], gf[HD / 16][4];  // q (unscaled) and dO
  load_frags<HD>(qf, head(static_cast<const bf16*>(a.q), a.sq, b, h), a.sq[2], w0, Tn, f);
  load_frags<HD>(gf, head(static_cast<const bf16*>(a.dout), a.sdo, b, h), a.sdo[2], w0, Tn, f);
  // lse2 = lse log2 e, so that p = 2^(s scale log2 e - lse2); a row without
  // terms (past T, or one that saw no key) gets 1e30 and with it p = 0.
  float lse2[2], delta[2];
  const float scale2 = a.bwd_scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + f.row + 8 * r;
    const size_t at = ((size_t)b * a.H + h) * Tn + row;
    const float lse = row < Tn ? a.lse[at] : kNegInf;
    lse2[r] = lse > kSentinel ? lse * kLog2e : -kNegInf;
    delta[r] = row < Tn ? a.delta[at] : 0.f;
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN;
    const uint32_t ks = stages + (it % kStages) * 2 * TILE, vs = ks + TILE;
    const bool active = !a.causal || k0 <= w0 + 63;
    float s[BN / 2], dp[BN / 2];
    ring.wait_full(it);
    if (active) {
      wgmma_fence();
      mma_nt<HD>(s, qf, ks);
      mma_nt<HD>(dp, gf, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // dS = P (dP - delta), P = exp(scale S - lse); on the tiles that cross
      // key_lens or the diagonal the masked terms are selected away.
      if (k0 + BN > valid || (a.causal && k0 + BN - 1 > w0)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, row = w0 + f.row + 8 * r, col = k0 + 8 * j + f.col + (e & 1);
            const bool ok = col < valid && (!a.causal || col <= row);
            const float p = ex2(fmaf(s[4 * j + e], scale2, -lse2[r]));
            s[4 * j + e] = ok ? p * (dp[4 * j + e] - delta[r]) : 0.f;
          }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[4 * j + e], scale2, -lse2[e >> 1]));
            s[4 * j + e] = p * (dp[4 * j + e] - delta[e >> 1]);
          }
      }
      uint32_t dsf[BN / 16][4];
      to_frags<BN>(dsf, s);
      wgmma_fence();
      mma_nn<HD, BN>(dq, dsf, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    ring.release(it);
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] *= a.bwd_scale;
  store_rows<HD>(head(static_cast<bf16*>(a.dq), a.sdq, b, h), a.sdq[2], w0, Tn, f, dq);
}

// A stage of the dK/dV kernel: the Q and dO tiles, then lse and delta of the
// tile's queries, rounded up so that the next stage's tiles stay aligned.
template <int HD, int BN> struct DkvStage {
  static constexpr int BYTES = 2 * BN * Cfg<HD>::ROWB + (2 * BN * 4 + 1023) / 1024 * 1024;
};

// ----------------------------------------------------------------------------
// K5, third kernel: dK and dV. grid (ceil(T / (64 NWG)), H, B); a warpgroup
// owns 64 keys and walks the BN-query tiles of Q and dO that can see them,
// with the tiles' lse and delta beside them. The tiles are transposed:
// S^T = K Q^T and dP^T = V dO^T, rows keys, columns queries.

template <int HD, int BN, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 128, 1)
    flash_bwd_dkdv_kernel_tc(const MstFlashArgs a) {
  constexpr int BM = NWG * 64, TILE = BN * Cfg<HD>::ROWB, STAGE = DkvStage<HD, BN>::BYTES;
  static_assert(BM % BN == 0 || BN % BM == 0, "the causal walk starts at the block's first key");
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG> ring(smem_raw);
  const uint32_t stages = ring.base + 1024;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BM;
  const int Tn = a.T;
  const int valid = min(max(a.key_lens[b], 0), Tn);
  // Keys at or past key_lens get nothing; causal queries before k0 see none
  // of this block's keys.
  const int qbegin = k0 < valid ? (a.causal ? (k0 / BN) * BN : 0) : Tn;
  const int ntiles = (Tn - qbegin + BN - 1) / BN;
  ring.init();

  if (threadIdx.x >= NWG * 128) {  // the producer warpgroup
    regs_give_back<kProducerRegs>();
    const bf16* qh = head(static_cast<const bf16*>(a.q), a.sq, b, h);
    const bf16* gh = head(static_cast<const bf16*>(a.dout), a.sdo, b, h);
    const float* lse = a.lse + ((size_t)b * a.H + h) * Tn;
    const float* delta = a.delta + ((size_t)b * a.H + h) * Tn;
    const int lane = threadIdx.x % 128;
    for (int it = 0; it < ntiles; ++it) {
      const uint32_t qs = stages + (it % kStages) * STAGE;
      const int i0 = qbegin + it * BN;
      ring.wait_empty(it);
      load_tile_async<HD, BN, 128>(qs, qh, a.sq[2], i0, Tn, lane);
      load_tile_async<HD, BN, 128>(qs + TILE, gh, a.sdo[2], i0, Tn, lane);
#pragma unroll
      for (int e = lane; e < 2 * BN; e += 128) {  // lse, then delta; past T as zeros
        const int qi = i0 + e % BN;
        const float* src = (e < BN ? lse : delta) + (qi < Tn ? qi : 0);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(qs + 2 * TILE + e * 4),
                     "l"(src), "r"(qi < Tn ? 4 : 0));
      }
      ring.commit_full(it);
    }
    return;
  }
  regs_take<kConsumerRegs>();

  const int w0 = k0 + (threadIdx.x / 128) * 64;
  const Frag f;
  const uint8_t* const stage_ptr =
      smem_raw + (stages - (uint32_t)__cvta_generic_to_shared(smem_raw));
  uint32_t kf[HD / 16][4], vf[HD / 16][4];
  load_frags<HD>(kf, head(static_cast<const bf16*>(a.k), a.sk, b, h), a.sk[2], w0, Tn, f);
  load_frags<HD>(vf, head(static_cast<const bf16*>(a.v), a.sv, b, h), a.sv[2], w0, Tn, f);
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  const float scale2 = a.bwd_scale * kLog2e;

  for (int it = 0; it < ntiles; ++it) {
    const int i0 = qbegin + it * BN;
    const uint32_t qs = stages + (it % kStages) * STAGE, gs = qs + TILE;
    const bool active = !a.causal || i0 + BN - 1 >= w0;  // else every query is before the keys
    float s[BN / 2], dp[BN / 2];
    ring.wait_full(it);
    if (active) {
      wgmma_fence();
      mma_nt<HD>(s, kf, qs);
      mma_nt<HD>(dp, vf, gs);
      wgmma_commit();
      wgmma_wait<0>();
      const float* lses =
          reinterpret_cast<const float*>(stage_ptr + (it % kStages) * STAGE + 2 * TILE);
      const float* deltas = lses + BN;
      fence_regs(s);
      fence_regs(dp);
      // P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T - delta), lse and
      // delta by column; on the tiles that cross key_lens, T or the diagonal
      // the masked terms are selected away.
      if (w0 + 64 > valid || i0 + BN > Tn || (a.causal && i0 < w0 + 63)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 lj = *reinterpret_cast<const float2*>(lses + 8 * j + f.col);
          const float2 dj = *reinterpret_cast<const float2*>(deltas + 8 * j + f.col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = w0 + f.row + 8 * (e >> 1), qi = i0 + 8 * j + f.col + (e & 1);
            const float le = (e & 1) ? lj.y : lj.x, de = (e & 1) ? dj.y : dj.x;
            const bool ok = key < valid && qi < Tn && le > kSentinel && (!a.causal || key <= qi);
            const float p = ok ? ex2(fmaf(s[4 * j + e], scale2, -le * kLog2e)) : 0.f;
            s[4 * j + e] = p;
            dp[4 * j + e] = ok ? p * (dp[4 * j + e] - de) : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float2 lj = *reinterpret_cast<const float2*>(lses + 8 * j + f.col);
          const float2 dj = *reinterpret_cast<const float2*>(deltas + 8 * j + f.col);
          lj.x *= kLog2e;
          lj.y *= kLog2e;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[4 * j + e], scale2, -((e & 1) ? lj.y : lj.x)));
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dj.y : dj.x));
          }
        }
      }
      uint32_t pf[BN / 16][4], dsf[BN / 16][4];
      to_frags<BN>(pf, s);
      to_frags<BN>(dsf, dp);
      wgmma_fence();
      mma_nn<HD, BN>(dv, pf, gs);
      mma_nn<HD, BN>(dk, dsf, qs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    ring.release(it);
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] *= a.bwd_scale;
  store_rows<HD>(head(static_cast<bf16*>(a.dk), a.sdk, b, h), a.sdk[2], w0, Tn, f, dk);
  store_rows<HD>(head(static_cast<bf16*>(a.dv), a.sdv, b, h), a.sdv[2], w0, Tn, f, dv);
}

// ----------------------------------------------------------------------------

// Dynamic shared memory of a kernel: the slack that aligns it to 1024 bytes,
// the barriers' 1024 bytes, the stages; above 48 KB a kernel must be told.
template <typename K> cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD> cudaError_t launch_forward(const MstFlashArgs& a, cudaStream_t stream) {
  constexpr int BN = kFwdTile, NWG = kFwdGroups;
  constexpr int smem = 2048 + kStages * 2 * BN * Cfg<HD>::ROWB;
  auto kernel = flash_fwd_kernel_tc<HD, BN, NWG>;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((a.T + 64 * NWG - 1) / (64 * NWG), a.H, a.B);
  kernel<<<grid, NWG * 128 + 128, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD> cudaError_t launch_backward(const MstFlashArgs& a, cudaStream_t stream) {
  const size_t rows = (size_t)a.B * a.H * a.T;
  constexpr int rows_a_block = 256 / (HD / 8);
  flash_bwd_delta_kernel_tc<HD>
      <<<(unsigned)((rows + rows_a_block - 1) / rows_a_block), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  {
    constexpr int BN = kDqTile, NWG = kDqGroups;
    constexpr int smem = 2048 + kStages * 2 * BN * Cfg<HD>::ROWB;
    auto kernel = flash_bwd_dq_kernel_tc<HD, BN, NWG>;
    static const cudaError_t allowed = allow_smem(kernel, smem);
    if (allowed != cudaSuccess) return allowed;
    const dim3 grid((a.T + 64 * NWG - 1) / (64 * NWG), a.H, a.B);
    kernel<<<grid, NWG * 128 + 128, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int BN = kDkvTile, NWG = kDkvGroups;
  constexpr int smem = 2048 + kStages * DkvStage<HD, BN>::BYTES;
  auto kernel = flash_bwd_dkdv_kernel_tc<HD, BN, NWG>;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((a.T + 64 * NWG - 1) / (64 * NWG), a.H, a.B);
  kernel<<<grid, NWG * 128 + 128, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run(const MstFlashArgs* a, bool backward, void* stream) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->H > 65535 || a->B > 65535 || !a->is_bf16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->HD) {
    case 32: return backward ? launch_backward<32>(*a, s) : launch_forward<32>(*a, s);
    case 64: return backward ? launch_backward<64>(*a, s) : launch_forward<64>(*a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mst_flash_tc_forward(const MstFlashArgs* a, void* stream) {
  return (int)run(a, false, stream);
}

extern "C" int mst_flash_tc_backward(const MstFlashArgs* a, void* stream) {
  return (int)run(a, true, stream);
}

extern "C" const char* mst_flash_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
