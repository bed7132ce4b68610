// K4 (forward) and K5 (backward) on the tensor cores of Hopper (sm_90a):
// flash attention over bf16 q, k, v [B, H, T, HD], HD = 16, 32, 64 or 128,
// and float32 ones at HD = 32 or 64, with prefix key lengths and an optional
// causal mask; and K2/K3, the
// attention core over the interleaved bf16 qkv projection, as front ends of
// the same device code.
//
// Replaces musicstyletransfer_tpu/ops/flash_attention.py, as
// flash_attention.cu does and with the same interface (MstFlashArgs):
// - flash_fwd_kernel_tc replaces K4a, _flash_forward_with_lse (Pallas kernel
//   _flash_kernel), and K4b, _flash_forward_streaming (_flash_stream_kernel);
// - flash_bwd_delta_kernel_tc, flash_bwd_dq_kernel_tc and
//   flash_bwd_dkdv_kernel_tc replace K5a, _flash_backward (_dqkv_kernel), and
//   K5b/K5c, _flash_backward_streaming (_dq_stream_kernel,
//   _dkv_stream_kernel).
// flash_attention.cu keeps the other head dimensions (8; and 16 and 128 in
// float32, where three pieces of a 128-wide operand outgrow the stages).
//
// float32 inputs run the same device code with every operand as three bf16
// pieces (NP = 3 below; bf16 inputs are NP = 1): x = hi + mid + lo with hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which hold x's 24
// significant bits exactly (bf16 has float32's exponent range). A float32
// product A B becomes six bf16 products into one float32 accumulator,
// smallest first: lo hi, hi lo, mid mid, mid hi, hi mid, hi hi; the terms
// left out (mid lo, lo mid, lo lo) are below 2^-24 of the product. That is
// 989 / 6 = 165 TFLOP/s of float32 work, 2.5x the 67 TFLOP/s of CUDA-core
// FMA, and keeps what the bf16 design is built on (below): the swizzled
// tiles, the transpose flag that lets one tile serve as both B operands,
// and accumulators that are already A fragments. TF32 keeps none of them
// (wgmma transposes only 16-bit operands; its A fragment is not the
// accumulator's layout). split_bf16x3_kernel writes the pieces of q * scale,
// k, v and dO ([3, B, H, T, HD] planes) before the launch; P, dS, P^T and
// dS^T are split in registers. The rows a warpgroup owns stay in registers
// in the forward (Q's pieces); in the backward they go to the warpgroup's
// own part of shared memory and the first products read both operands from
// there (the SS form of wgmma), since three pieces of two operands do not
// fit beside the accumulators in 232 registers. Three planes of a tile make
// a stage three times larger, so the float32 instances run fewer stages
// (kStagesOf). The float32 rounding points are flash_attention.cu's: q *
// sm_scale rounded to float32 before the split (forward and backward), p
// and dS unrounded, dq scaled at the end, dk from the scaled q; delta =
// rowsum(dO * O) a float32 sum of the float32 inputs.
//
// Also replaces musicstyletransfer_tpu/ops/attention_core.py for bf16 at
// HD 32 or 64, as attention_core.cu does for the rest and with the same
// interface (MstCoreArgs; mst_core_tc_forward, mst_core_tc_backward):
// - core_fwd_kernel_tc replaces K2, _core_forward (Pallas kernel
//   _core_fwd_kernel, attention_core.py:80);
// - core_bwd_dq_kernel_tc and core_bwd_dkdv_kernel_tc replace K3,
//   _core_backward (_core_bwd_kernel, :130).
// The core's qkv [B, T, H*3*HD] is one more set of strides for the flash
// kernels' device code (flash_view below), ctx [B, T, H*HD] is [B, T, H, HD]
// and dqkv three strided outputs, so K2/K3 run the same per-item code as
// K4/K5 with a grid of their own (Schedule): the core's window is
// 256 <= T < 1024, where a block has only 1-9 tiles of work. K3 is two
// kernels: its dQ kernel computes delta = rowsum(dO * O) from the rows it
// holds anyway, in place of K5's delta kernel.
//
// What bounds it: operations. At the long training shapes (B=4, H=8; encoder
// T=2047, HD=64; decoder T=2048, HD=32, causal) the forward needs 4*HD flops
// per unmasked (query, key) pair, 24.6 and 7.4 GFLOP, 25 and 7.5 us at the
// 989 TFLOP/s bf16 peak of the tensor cores against 10 and 5 us for the
// bytes; the backward 10*HD a pair (14*HD as done here, in two passes over
// the scores). At the wide training shapes of the core (B=8, H=16; encoder
// T=513, HD=64; decoder T=514, HD=32, causal) it is bytes: at the corpus
// batch's key lengths the encoder's 21.9M unmasked pairs need 5.6 GFLOP
// forward (5.7 us) and 14.0 backward (14.2 us) against 34 and 67 MB (10 and
// 20 us at 3.35 TB/s); but what holds the kernels there is each block's
// fixed cost against its few tiles, which the core's grid amortises.
// CUDA-core float32 FMA (67 TFLOP/s) cannot come nearer than 15x the
// operations bound, so every matrix product here is a warpgroup matrix multiply
// (wgmma.mma_async m64nNk16, bf16 operands, float32 accumulators in
// registers). For float32 inputs the bound is the same work at the 495
// TFLOP/s TF32 peak; this design's own ceiling is 165 TFLOP/s (six bf16
// products a product). Beside the products, every pair costs one exponential (two in
// the backward) on the special function units, 16 a clock an SM against 16
// pairs' worth of products at HD=64, so the kernels must run the two side
// by side to come near the bound; at HD=32 (forward) and HD=16 the
// exponentials alone bound it (3.9 T/s: 25 us for the encoder's 95.9M
// pairs at HD=16, against 6 us of products), at HD=128 the products (50
// us forward, 124 backward):
//
// - A consumer warpgroup (4 warps) owns 64 rows; a block is NWG of them and
//   one producer warpgroup. The rows' own operands (Q in the forward; Q and dO in the dQ kernel; K and V in the
//   dK/dV kernel) are read once from device memory straight into the
//   register layout of a wgmma A operand (at HD=128 the dK/dV kernel keeps K
//   and V in its shared memory instead: the dK and dV accumulators take 128
//   of its 232 registers). The tiles a block walks over (K and
//   V; Q and dO in the dK/dV kernel) stay bf16 in shared memory, [rows, HD]
//   with the 128-byte (HD=64), 64-byte (HD=32) or 32-byte (HD=16) swizzle of
//   a wgmma matrix descriptor; a 256-byte row (HD=128) is two 128-byte
//   swizzle spans, so its tile is two [rows, 64] column blocks one after the
//   other. One tile serves as the K-major B operand of the first
//   products (contraction over HD; at HD=128 the descriptor moves to the
//   second block after four k-steps) and as the MN-major B operand (the
//   transpose flag) of the second ones (contraction over the tile's rows; at
//   HD=128 the descriptor's leading offset steps from block to block).
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
// - The backward stays three kernels (two for the core) without atomics or a
//   [T, T] buffer: delta, dQ (per query tile), dK/dV (per key tile, from the
//   diagonal on), so gradients are identical from run to run.
// - Grouped K/V heads and a left window are bf16's alone (window_of,
//   group_of): the float32 instances compile without them.
// - Grouped K/V heads (a.group G > 1): K4's and the dQ kernel's blocks of
//   query head h read K/V head h / G; the dK/dV kernel's grid runs over the
//   K/V heads and a block walks the query tiles of each of its G query heads
//   in turn, one ring, so dK and dV sum over the group in registers.
// - A left window (a.window W > 0, causal): query i sees keys i - W < j <= i.
//   A block's walk starts at the first key tile any of its queries sees (K4,
//   dQ) or ends after the last query tile that sees any of its keys (dK/dV):
//   tiles wholly outside the window are neither copied nor computed; a
//   warpgroup skips the tiles wholly outside its own rows' window as it
//   skips those above the diagonal, and masks those that cross the window's
//   edge.
//
// Rounding points: the forward's are the reference's (q * sm_scale rounded to
// bf16 with the scale rounded first; float32 scores; masked scores -1e30;
// float32 online softmax; p rounded to bf16 before P.V; out = acc /
// max(l, 1e-30); lse = m + log l; no visible key: zeros and lse -1e30). The
// backward computes S from the raw bf16 q with a float32 sum and multiplies
// by the float32 scale afterwards, rounds P (for dV) and dS (for dQ, dK) to
// bf16 before the second products, and scales dQ and dK at the end; masked
// terms are selected away, never multiplied by zero. The JAX core's backward
// (attention_core.py:160-197) feeds float32 operands to every product: the
// core here rounds P and dS to bf16 as K5 does, a difference that the
// tolerance of the bf16 comparison covers (chip_smoke.TOL_DQKV_REL).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "attention_core_args.cuh"
#include "flash_attention_args.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kSentinel = -1e29f;  // lse at or below it: a row that sees no key

// A tile of rows of HD bf16 values: a row is one 32-, 64- or 128-byte
// swizzle span (HD = 16, 32, 64), or two (HD = 128), each span a column
// block of its own: [rows, 64] then [rows, 64].
template <int HD> struct Cfg {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128,
                "a tile row is one 32-, 64- or 128-byte swizzle span, or two 128-byte ones");
  static constexpr int ROWB = HD * 2;                    // bytes a tile row
  static constexpr int SPAN = ROWB < 128 ? ROWB : 128;   // bytes a row of a column block
  static constexpr int BLOCKS = ROWB / SPAN;             // column blocks a tile
  static constexpr int CHUNKS = ROWB / 16;               // 16-byte chunks a row
  static constexpr uint32_t XOR_MASK = SPAN == 128 ? 7u : SPAN == 64 ? 3u : 1u;
  static constexpr uint64_t SWIZZLE = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;  // 128B, 64B, 32B
  static constexpr int GROUP = 8 * SPAN;                 // 8 rows of a column block
};

// Byte offset (before the swizzle) of 16-byte chunk c of row r in a tile of
// R rows.
template <int HD, int R> __device__ __forceinline__ int tile_off(int r, int c) {
  if constexpr (Cfg<HD>::BLOCKS == 1) {
    return r * Cfg<HD>::ROWB + c * 16;
  } else {
    constexpr int SC = Cfg<HD>::SPAN / 16;
    return (c / SC) * R * Cfg<HD>::SPAN + r * Cfg<HD>::SPAN + (c % SC) * 16;
  }
}

// Byte offset of k-step kk (16 columns) of a K-major operand tile of R rows.
template <int HD, int R> __device__ __forceinline__ constexpr int k_step(int kk) {
  return Cfg<HD>::BLOCKS == 1 ? kk * 32 : (kk / 4) * R * Cfg<HD>::SPAN + (kk % 4) * 32;
}

// The (b, h) head of a strided [B, H, T, HD] tensor.
template <typename P>
__device__ __forceinline__ P* head(P* base, const long long* s, int b, int h) {
  return base + b * s[0] + h * s[1];
}

// The window and the K/V group of an instance of NP-piece operands: the
// arguments' for bf16 (NP = 1); none for float32's pieces, which are laid
// out at the query heads and take no window (run() refuses both), so its
// instances compile without either.
template <int NP> __device__ __forceinline__ int window_of(const MstFlashArgs& a) {
  return NP == 1 ? a.window : 0;
}
template <int NP> __device__ __forceinline__ int group_of(const MstFlashArgs& a) {
  return NP == 1 && a.group > 1 ? a.group : 1;
}

// The K/V head of query head h (group_of query heads a K/V head).
template <int NP> __device__ __forceinline__ int kv_head(const MstFlashArgs& a, int h) {
  return h / group_of<NP>(a);
}

// Whether key `col` is visible to query `row` (beside key_lens): causal and
// in the window W.
__device__ __forceinline__ bool sees(const MstFlashArgs& a, int W, int row, int col) {
  return (!a.causal || col <= row) && (W <= 0 || col > row - W);
}

// Adds a block's loaded tiles to tile_stats[at].
__device__ __forceinline__ void add_tile_stats(const MstFlashArgs& a, int at, int loaded) {
  if (a.tile_stats != nullptr) atomicAdd(a.tile_stats + at, (unsigned long long)loaded);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// Operands of NP pieces: NP = 1, a bf16 operand itself; NP = 3, a float32
// one as bf16 hi, mid, lo. The element type the kernels write out.
template <int NP> using OutT = typename std::conditional<NP == 3, float, bf16>::type;

// The products of two operands of NP pieces: product i multiplies piece
// piece_a(i) of A by piece_b(i) of B (0 hi, 1 mid, 2 lo), smallest first.
template <int NP> constexpr int kProducts = NP == 3 ? 6 : 1;
template <int NP> __device__ __forceinline__ constexpr int piece_a(int i) {
  return NP == 1 ? 0 : i == 0 ? 2 : (i == 2 || i == 3) ? 1 : 0;
}
template <int NP> __device__ __forceinline__ constexpr int piece_b(int i) {
  return NP == 1 ? 0 : i == 1 ? 2 : (i == 2 || i == 4) ? 1 : 0;
}

// x as hi + mid + lo, each bf16; explicit roundings, so that no multiply-add
// contracts a difference (split_bf16x3_reference in flash_attention.py does
// the same in the same order, and the two agree bit for bit).
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& mid, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = __fsub_rn(x, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
}

__device__ __forceinline__ uint32_t pack_bf(bf16 lo, bf16 hi) {
  __nv_bfloat162 t = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Two neighbouring output values, rounded to bf16 or stored as float32.
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Tile shapes: keys (queries in the dK/dV kernel) a tile and consumer
// warpgroups a block, for each kernel (K4/K5, then the core's K2/K3), and
// the stages of a block's ring. PERF.md lists what else was tried on the
// card.
constexpr int kFwdTile = 128, kFwdGroups = 2;
constexpr int kDqTile = 64, kDqGroups = 2;
constexpr int kDkvTile = 64, kDkvGroups = 2;
constexpr int kCoreFwdTile = 128, kCoreFwdGroups = 2;
constexpr int kCoreDqTile = 64, kCoreDqGroups = 1;
constexpr int kCoreDkvTile = 64, kCoreDkvGroups = 1;
constexpr int kStages = 4;
constexpr float kLog2e = 1.4426950408889634f;
// Stages of a ring: a float32 stage holds three planes a tile, so two fit
// at HD=64 (the forward's two 128-key tiles: 96 KB a stage) and four at
// HD=32.
template <int HD, int NP> constexpr int kStagesOf = NP == 1 ? kStages : HD == 64 ? 2 : 4;
// K4's key tiles: 64 at HD=128, where a 128-key tile would give its S and
// P.V products one wgmma shape (see fwd_consume); 32 KB a stage, as the
// backward's.
template <int HD> constexpr int kFwdTileOf = HD == 128 ? 64 : kFwdTile;

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
// byte aligned: address bits [7, 10) (or [7, 9), or bit 7) are xor-ed into the
// 16-byte chunk bits [4, 7) (or [4, 6), or bit 4), as the wgmma descriptor's
// swizzle mode reads.
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
    const uint32_t dst = tile + swz<HD>(tile_off<HD, R>(r, c));
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
// address (in 16-byte units) and the leading offset `lbo` (the bytes from one
// column block to the next, read only by an MN-major operand two blocks
// wide: HD=128), the high word the stride offset (8 rows) and the swizzle
// mode. Tiles are 1024-byte aligned, so a step inside a tile adds to the low
// word without a carry into the next field.
template <int HD> __device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo = 16) {
  return ((addr & 0x3FFFFu) >> 4) | ((lbo >> 4) << 16);
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
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
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

// D[64, 64] (+)= A[64, 16] B[16, 64], both from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A B^T, contraction over HD: A fragments a[piece][HD / 16], B the
// K-major [N, HD] tile at `tile` (NP planes of N rows, one after the other).
template <int HD, int NP, int NR>
__device__ __forceinline__ void mma_nt(float (&d)[NR], const uint32_t (&a)[NP][HD / 16][4],
                                       uint32_t tile) {
  constexpr int PLANE = 2 * NR * Cfg<HD>::ROWB;
  const uint32_t lo = desc_lo<HD>(tile);
#pragma unroll
  for (int i = 0; i < kProducts<NP>; ++i)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_rs<0>(d, a[piece_a<NP>(i)][kk],
                  make_desc<HD>(lo, piece_b<NP>(i) * PLANE + k_step<HD, 2 * NR>(kk)),
                  i > 0 || kk > 0);
}

// The same with A from shared memory too: NP planes of [64, HD] at `atile`,
// laid out as a tile; B's tile of 64 rows.
template <int HD, int NP>
__device__ __forceinline__ void mma_nt_ss(float (&d)[32], uint32_t atile, uint32_t tile) {
  constexpr int PLANE = 64 * Cfg<HD>::ROWB;
  const uint32_t alo = desc_lo<HD>(atile), lo = desc_lo<HD>(tile);
#pragma unroll
  for (int i = 0; i < kProducts<NP>; ++i)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(d, make_desc<HD>(alo, piece_a<NP>(i) * PLANE + k_step<HD, 64>(kk)),
               make_desc<HD>(lo, piece_b<NP>(i) * PLANE + k_step<HD, 64>(kk)), i > 0 || kk > 0);
}

// d += A B, contraction over the KT rows of the [KT, HD] tile at `tile`
// (MN-major B, NP planes of PR >= KT rows): A fragments a[piece][KT / 16].
// At HD=128 the product's 128 columns are the tile's two column blocks, PR
// rows apart (the descriptor's leading offset).
template <int HD, int KT, int NP, int PR = KT>
__device__ __forceinline__ void mma_nn(float (&d)[HD / 2], const uint32_t (&a)[NP][KT / 16][4],
                                       uint32_t tile) {
  constexpr int PLANE = PR * Cfg<HD>::ROWB;
  const uint32_t lo =
      Cfg<HD>::BLOCKS == 1 ? desc_lo<HD>(tile) : desc_lo<HD>(tile, PR * Cfg<HD>::SPAN);
#pragma unroll
  for (int i = 0; i < kProducts<NP>; ++i)
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_rs<1>(d, a[piece_a<NP>(i)][kk],
                  make_desc<HD>(lo, piece_b<NP>(i) * PLANE + kk * 16 * Cfg<HD>::SPAN), 1);
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

// The pieces of a head's operand: NP planes of [B, H, T, HD], `plane`
// elements apart ([3, B, H, T, HD] contiguous for float32 inputs).
__device__ __forceinline__ long long plane_of(const MstFlashArgs& a) {
  return (long long)a.B * a.H * a.T * a.HD;
}

template <int HD, int NP>
__device__ __forceinline__ void load_pieces(uint32_t (&a)[NP][HD / 16][4], const bf16* rows,
                                            long long stride, long long plane, int first, int end,
                                            Frag f) {
#pragma unroll
  for (int p = 0; p < NP; ++p) load_frags<HD>(a[p], rows + p * plane, stride, first, end, f);
}

// An accumulator (rounded to bf16; or as three pieces) as the A fragments
// of the next product.
template <int N, int NP>
__device__ __forceinline__ void to_frags(uint32_t (&a)[NP][N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = 4 * (2 * kk + (i >> 1)) + 2 * (i & 1);
      if constexpr (NP == 1) {
        a[0][kk][i] = pack(d[at], d[at + 1]);
      } else {
        bf16 h0, m0, l0, h1, m1, l1;
        split3(d[at], h0, m0, l0);
        split3(d[at + 1], h1, m1, l1);
        a[0][kk][i] = pack_bf(h0, h1);
        a[1][kk][i] = pack_bf(m0, m1);
        a[2][kk][i] = pack_bf(l0, l1);
      }
    }
}

// Write an accumulator as rows first + f.row (+ 8) of a head, rows below
// `end`; with bf16 rows and `lo`, laid out as `rows`, also what rounding it
// to bf16 left over, rounded to bf16, beside each pair.
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* rows, long long stride, int first, int end, Frag f,
                                           const float (&d)[HD / 2], bf16* lo = nullptr) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = first + f.row + 8 * half;
      if (row < end) {
        const long long at = (long long)row * stride + 8 * j + f.col;
        const float x = d[4 * j + 2 * half], y = d[4 * j + 2 * half + 1];
        if constexpr (std::is_same<T, bf16>::value) {
          const uint32_t hi = pack(x, y);
          *reinterpret_cast<uint32_t*>(rows + at) = hi;
          if (lo != nullptr) {
            const float2 h = unpack(hi);
            store2(lo + at, x - h.x, y - h.y);
          }
        } else {
          store2(rows + at, x, y);
        }
      }
    }
}

// The rows first.. of a head's NP pieces (rows at or past `end` as zeros)
// into this warpgroup's [64, HD] tiles at `dst`, one plane after the other,
// ready for the tensor cores once it returns: the A operands of the SS
// products.
template <int HD, int NP>
__device__ __forceinline__ void load_own_rows(uint32_t dst, const bf16* rows, long long stride,
                                              long long plane, int first, int end) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
    load_tile_async<HD, 64, 128>(dst + p * 64 * Cfg<HD>::ROWB, rows + p * plane, stride, first,
                                 end, threadIdx.x % 128);
}
__device__ __forceinline__ void own_rows_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_async_proxy();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)threadIdx.x / 128) : "memory");
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
// matrix products. The ring counts its tiles `it` over the block's whole
// life, so a block that takes several items (the core's kernels) keeps
// copying the next item's tiles while its consumers finish the last one.

// Registers a thread: a block of two consumer warpgroups and one producer
// starts every thread with the same count (168); the producers give most of
// theirs back and the consumers take them (setmaxnreg). 2 * 232 + 40 <= 512,
// the 64 K registers of an SM over the 128 lanes of a warpgroup. A block of
// one consumer warpgroup runs two to an SM: 2 * (216 + 40) = 512.
constexpr int kProducerRegs = 40;
template <int NWG> constexpr int kConsumerRegs = NWG == 2 ? 232 : 216;
template <int N> __device__ __forceinline__ void regs_give_back() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int NWG, int ST = kStages> struct Ring {
  static_assert(NWG == 1 || NWG == 2, "the register split above is for one or two consumer warpgroups");
  // 1024-byte aligned: the barriers, then from base + 1024 the stages
  uint32_t base;
  __device__ explicit Ring(const uint8_t* raw)
      : base(((uint32_t)__cvta_generic_to_shared(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 8 * (ST + s); }
  __device__ uint32_t stages() const { return base + 1024; }
  // Every thread of the block, before the roles part.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < ST; ++s) {
        mbar_init(full(s), 128);
        mbar_init(empty(s), NWG * 128);
      }
    }
    __syncthreads();
  }
  // Producer: the stage of tile `it` is free again.
  __device__ void wait_empty(int it) const {
    if (it >= ST) mbar_wait(empty(it % ST), (it / ST + 1) & 1);
  }
  // Producer: full[s] completes once this thread's copies so far have landed.
  __device__ void commit_full(int it) const { cp_async_mbar_arrive(full(it % ST)); }
  // Consumer: tile `it` has landed and the tensor cores may read it.
  __device__ void wait_full(int it) const {
    mbar_wait(full(it % ST), (it / ST) & 1);
    fence_async_proxy();
  }
  __device__ void release(int it) const { mbar_arrive(empty(it % ST)); }
};

// A generic pointer to shared-memory address `addr` of the block.
__device__ __forceinline__ uint8_t* smem_ptr(uint8_t* raw, uint32_t addr) {
  return raw + (addr - (uint32_t)__cvta_generic_to_shared(raw));
}

// ----------------------------------------------------------------------------
// The order of the core's items. An item is one (row b, head h, tile x of
// 64 NWG rows). K4/K5 launch one block an item. The core's kernels launch as
// many blocks as fit on the card at once, each looping over items: at its
// short T (256 <= T < 1024) a block holds 1-9 tiles of work against ~9k
// clocks of prologue and epilogue (PERF.md), so a block that stays on its SM
// hides the next item's copies behind the last one's work. The items with
// work come first, from the longest row of the batch (by key length) to the
// shortest and within a row from the heaviest tile; then the items that only
// write zeros (a dK/dV tile at or past key_lens, a row of key length 0).
// Block j of G takes items j, 2G-1-j, 2G+j, ... of that order, so every
// block gets a like share of the heavy ones.

constexpr int kMaxSortedRows = 160;  // rows the order holds; past it, items in plain order
constexpr int kScheduleBytes = 2048;  // its shared memory, after the ring's stages
static_assert(4 * (3 * kMaxSortedRows + 2) <= kScheduleBytes, "the order's three arrays");

struct Schedule {
  int n, H, nx, B;
  bool reverse_x, key_tiles;
  // By rank (rows by key length, longest first): the row, and the items with
  // work (zeros) of the rows before it, [B + 1] each.
  int *order, *work_before, *zero_before;

  // Every thread of the block, before Ring::init's barrier. `rows` rows an
  // item; `key_tiles`: an item's rows are keys (dK/dV), and a tile has work
  // if it starts below key_lens; else they are queries, and every tile of a
  // row with a key has work. `reverse`: the heaviest tile of a row is its
  // last (causal queries).
  __device__ Schedule(const MstFlashArgs& a, uint8_t* raw, uint32_t at, int rows, bool keys,
                      bool reverse)
      : H(a.H), nx((a.T + rows - 1) / rows), B(a.B), reverse_x(reverse), key_tiles(keys) {
    n = a.B * a.H * nx;
    order = reinterpret_cast<int*>(smem_ptr(raw, at));
    work_before = order + kMaxSortedRows;
    zero_before = work_before + kMaxSortedRows + 1;
    const int t = threadIdx.x;
    if (a.B <= kMaxSortedRows && t < a.B) {
      const int vt = min(max(a.key_lens[t], 0), a.T);
      int rank = 0, w = 0, z = 0;
      for (int u = 0; u < a.B; ++u) {
        const int vu = min(max(a.key_lens[u], 0), a.T);
        if (vu > vt || (vu == vt && u < t)) {
          ++rank;
          w += work(vu, rows);
          z += nx - work(vu, rows);
        }
      }
      order[rank] = t;
      work_before[rank] = w * H;
      zero_before[rank] = z * H;
      if (rank == a.B - 1) {
        work_before[a.B] = (w + work(vt, rows)) * H;
        zero_before[a.B] = (z + nx - work(vt, rows)) * H;
      }
    }
  }
  // Tiles with work of a row of key length v.
  __device__ int work(int v, int rows) const {
    return key_tiles ? (v + rows - 1) / rows : (v > 0 ? nx : 0);
  }
  // The k-th item of this block, or -1 past the last.
  __device__ int index(int k) const {
    const int i = k * (int)gridDim.x + ((k & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
    return i < n ? i : -1;
  }
  __device__ void item(int i, int& b, int& h, int& x) const {
    int xi;
    if (B > kMaxSortedRows) {
      h = i % H;
      xi = (i / H) % nx;
      b = i / (H * nx);
    } else {
      const bool has_work = i < work_before[B];
      const int* before = has_work ? work_before : zero_before;
      const int j = has_work ? i : i - work_before[B];
      int r = 0;
      while (before[r + 1] <= j) ++r;
      const int local = j - before[r];
      h = local % H;
      // A row's tiles with work are its first ones, the rest follow them.
      xi = local / H + (has_work ? 0 : (work_before[r + 1] - work_before[r]) / H);
      b = order[r];
    }
    x = reverse_x ? nx - 1 - xi : xi;
  }
};

// ----------------------------------------------------------------------------
// K4: forward. A warpgroup owns 64 queries of the item's 64 NWG and walks
// BN-key tiles of K and V.

// Key tiles [t0, the return value) of the query tile from q0: those below
// key_lens (and, causal, up to the tile's last query; with a window, from
// the first key its first query sees; none where key_lens ends before it).
template <int BN, int BM, int NP>
__device__ __forceinline__ int fwd_tiles(const MstFlashArgs& a, int b, int q0, int& valid,
                                         int& t0) {
  valid = min(max(a.key_lens[b], 0), a.T);
  const int kend = a.causal ? min(valid, min(a.T, q0 + BM)) : valid;
  const int W = window_of<NP>(a), first = W > 0 ? max(q0 - W + 1, 0) : 0;
  t0 = first / BN;
  return kend > first ? (kend + BN - 1) / BN : t0;
}

// A stage of K4's and the dQ kernel's rings: the K tile's NP planes, then
// V's.
template <int HD, int BN, int NP> constexpr int kKvStage = 2 * NP * BN * Cfg<HD>::ROWB;

template <int HD, int BN, int NWG, int NP, int ST>
__device__ __forceinline__ int fwd_produce(const MstFlashArgs& a, const Ring<NWG, ST>& ring, int b,
                                           int h, int q0, int it) {
  constexpr int PLANE = BN * Cfg<HD>::ROWB, TILE = NP * PLANE;
  int valid, t0;
  const int ntiles = fwd_tiles<BN, NWG * 64, NP>(a, b, q0, valid, t0);
  const bf16* kh = head(static_cast<const bf16*>(a.k), a.sk, b, kv_head<NP>(a, h));
  const bf16* vh = head(static_cast<const bf16*>(a.v), a.sv, b, kv_head<NP>(a, h));
  const long long plane = plane_of(a);
  const int lane = threadIdx.x % 128;
  if (lane == 0 && ntiles > t0) add_tile_stats(a, 0, ntiles - t0);
  for (int t = t0; t < ntiles; ++t, ++it) {
    const uint32_t ks = ring.stages() + (it % ST) * 2 * TILE;
    ring.wait_empty(it);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      load_tile_async<HD, BN, 128>(ks + p * PLANE, kh + p * plane, a.sk[2], t * BN, a.T, lane);
      load_tile_async<HD, BN, 128>(ks + TILE + p * PLANE, vh + p * plane, a.sv[2], t * BN, a.T,
                                   lane);
    }
    ring.commit_full(it);
  }
  return it;
}

// The forward's accumulator as the running maximum grows: the running
// maximum of most rows stops growing after a few tiles.
template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
  }
}

template <int HD, int BN, int NWG, int NP, int ST>
__device__ __forceinline__ int fwd_consume(const MstFlashArgs& a, const Ring<NWG, ST>& ring, int b,
                                           int h, int q0, int it) {
  // Measured wrong on the card, K4 and K2 alike, whenever S = Q K^T and
  // O += P V are one wgmma shape (m64nNk16, N = BN = HD: 64-key tiles at
  // HD=64, 128-key tiles at HD=128): ctx off by ~3, lse by ~7, from the
  // second key tile on. Either product split into two of half the width,
  // so that the shapes differ, is right (scripts/flash-tc-variants.py).
  // The dQ kernel's products share a shape at HD=64 and are right: no
  // instruction touches its accumulator between them, where the forward
  // rescales O.
  static_assert(BN != HD, "the forward's S and P.V products must differ in shape");
  constexpr int TILE = NP * BN * Cfg<HD>::ROWB;
  const int Tn = a.T;
  int valid, t0;
  const int ntiles = fwd_tiles<BN, NWG * 64, NP>(a, b, q0, valid, t0);
  const int w0 = q0 + (threadIdx.x / 128) * 64, W = window_of<NP>(a);
  const Frag f;
  // q * sm_scale: rounded to bf16 here; for float32 inputs the pieces of
  // the product rounded to float32, which the split wrote.
  uint32_t qf[NP][HD / 16][4];
  load_pieces<HD, NP>(qf, head(static_cast<const bf16*>(a.q), a.sq, b, h), a.sq[2], plane_of(a),
                      w0, Tn, f);
  if constexpr (NP == 1) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack(qf[0][kk][i]);
        qf[0][kk][i] = pack(x.x * a.fwd_scale, x.y * a.fwd_scale);
      }
  }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum

  for (int t = t0; t < ntiles; ++t, ++it) {
    const int k0 = t * BN;
    const uint32_t ks = ring.stages() + (it % ST) * 2 * TILE, vs = ks + TILE;
    // else the tile is above the diagonal, or before every row's window
    const bool active = (!a.causal || k0 <= w0 + 63) && (W <= 0 || k0 + BN - 1 > w0 - W);
    float s[BN / 2];
    ring.wait_full(it);
    if (active) {
      wgmma_fence();
      mma_nt<HD, NP>(s, qf, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Mask the tiles that cross key_lens, the diagonal or the window's
      // edge; a masked score is -1e30 and its p = 2^(-1e30 log2e - ...) an
      // exact zero.
      if (k0 + BN > valid || (a.causal && k0 + BN - 1 > w0) ||
          (W > 0 && k0 <= w0 + 63 - W)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = w0 + f.row + 8 * (e >> 1), col = k0 + 8 * j + f.col + (e & 1);
            if (!(col < valid && sees(a, W, row, col))) s[4 * j + e] = kNegInf;
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
      if constexpr (NP == 1) {
        uint32_t pf[1][BN / 16][4];
        to_frags<BN, 1>(pf, s);
        rescale<HD>(o, alpha);
        wgmma_fence();
        mma_nn<HD, BN, 1>(o, pf, vs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      } else {
        rescale<HD>(o, alpha);
        // P's pieces half a tile at a time (48 registers at BN = 128, not
        // 96): each half's products end before the next half is split.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t pf[NP][BN / 32][4];
          to_frags<BN / 2, NP>(pf, *reinterpret_cast<const float(*)[BN / 4]>(s + half * BN / 4));
          wgmma_fence();
          mma_nn<HD, BN / 2, NP, BN>(o, pf, vs + half * (BN / 2) * Cfg<HD>::ROWB);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
        }
      }
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
  store_rows<HD>(head(static_cast<OutT<NP>*>(a.out), a.so, b, h), a.so[2], w0, Tn, f, o,
                 a.out_lo == nullptr ? nullptr : head(static_cast<bf16*>(a.out_lo), a.so, b, h));
  if (f.col == 0) {
    float* lse = a.lse + ((size_t)b * a.H + h) * Tn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + f.row + 8 * r;
      if (row < Tn) lse[row] = m[r] + logf(lm[r]);
    }
  }
  return it;
}

// grid (ceil(T / (64 NWG)), H, B), one item a block; operands of NP pieces.
template <int HD, int BN, int NWG, int NP>
__global__ void __launch_bounds__(NWG * 128 + 128, 1) flash_fwd_kernel_tc(const MstFlashArgs a) {
  constexpr int ST = kStagesOf<HD, NP>;
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG, ST> ring(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y;
  // Causal blocks near the end of the sequence have the most keys: first.
  const int q0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * NWG * 64;
  ring.init();
  if (threadIdx.x >= NWG * 128) {  // the producer warpgroup
    regs_give_back<kProducerRegs>();
    fwd_produce<HD, BN, NWG, NP, ST>(a, ring, b, h, q0, 0);
    return;
  }
  regs_take<kConsumerRegs<NWG>>();
  fwd_consume<HD, BN, NWG, NP, ST>(a, ring, b, h, q0, 0);
}

// K2: the same items, a block looping over them in the core's order.
template <int HD, int BN, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 128, 3 - NWG) core_fwd_kernel_tc(const MstFlashArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG> ring(smem_raw);
  const Schedule sched(a, smem_raw, ring.stages() + kStages * kKvStage<HD, BN, 1>, NWG * 64,
                       false, a.causal);
  ring.init();
  int it = 0, b, h, x;
  if (threadIdx.x >= NWG * 128) {  // the producer warpgroup
    regs_give_back<kProducerRegs>();
    for (int k = 0, i; (i = sched.index(k)) >= 0; ++k) {
      sched.item(i, b, h, x);
      it = fwd_produce<HD, BN, NWG, 1, kStages>(a, ring, b, h, x * NWG * 64, it);
    }
    return;
  }
  regs_take<kConsumerRegs<NWG>>();
  for (int k = 0, i; (i = sched.index(k)) >= 0; ++k) {
    sched.item(i, b, h, x);
    it = fwd_consume<HD, BN, NWG, 1, kStages>(a, ring, b, h, x * NWG * 64, it);
  }
}

// ----------------------------------------------------------------------------
// K5, first kernel: delta = rowsum(dO * O) - g_lse from the inputs as they
// are (bf16 or float32); 16 bytes a thread, HD / 8 (bf16) or HD / 4 threads
// a row. grid ceil(B H T / rows a block) blocks of 256 threads. (K3 computes
// delta in its dQ kernel instead.) With bf16 inputs and K4's out_lo, O is
// out + out_lo: D from the bf16 out alone misses up to 2^-9 of O, which
// rowsum(P dP) does not, and a row's every dS = P (dP - D) then carries
// that shared error (of the order of 3% of dQ on 2047-key rows, PERF.md).

template <int HD, typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel_tc(const MstFlashArgs a) {
  constexpr int EPT = 16 / sizeof(T), TPR = HD / EPT;  // elements a thread, threads a row
  const size_t rows = (size_t)a.B * a.H * a.T;
  const size_t row = (size_t)blockIdx.x * (256 / TPR) + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  float s = 0.f;
  if (row < rows) {
    const int t = row % a.T, h = (row / a.T) % a.H, b = row / ((size_t)a.T * a.H);
    const T* o = head(static_cast<const T*>(a.out), a.so, b, h) + t * a.so[2] + part * EPT;
    const T* g = head(static_cast<const T*>(a.dout), a.sdo, b, h) + t * a.sdo[2] + part * EPT;
    const uint4 ov = *reinterpret_cast<const uint4*>(o), gv = *reinterpret_cast<const uint4*>(g);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
    if constexpr (!std::is_same<T, float>::value) {
      if (a.out_lo != nullptr) {
        const uint4 lv = *reinterpret_cast<const uint4*>(
            head(static_cast<const T*>(a.out_lo), a.so, b, h) + t * a.so[2] + part * EPT);
        const uint32_t lw[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = unpack(lw[i]), y = unpack(gw[i]);
          s = fmaf(y.y, x.y, fmaf(y.x, x.x, s));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same<T, float>::value) {
        s = fmaf(__uint_as_float(gw[i]), __uint_as_float(ow[i]), s);
      } else {
        const float2 x = unpack(ow[i]), y = unpack(gw[i]);
        s = fmaf(y.x, x.x, s);
        s = fmaf(y.y, x.y, s);
      }
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && part == 0) a.delta[row] = a.g_lse != nullptr ? s - a.g_lse[row] : s;
}

// ----------------------------------------------------------------------------
// K5, second kernel: dQ. A warpgroup owns 64 queries and walks BN-key tiles
// of K and V as the forward does. With DELTA it also computes delta for its
// queries (from its own rows of O and dO) and writes it for the dK/dV
// kernel, in place of the delta kernel.

// The rows' own operands of the backward's first products (Q and dO in
// the dQ kernel, K and V in the dK/dV kernel) in shared memory (OWN), each
// consumer warpgroup's NP planes of 64 rows of both, after the ring's
// stages: for float32 inputs in both kernels, whose three pieces of two
// operands do not fit beside the accumulators; and in the dK/dV kernel at
// HD=128, where dK and dV take 128 registers.
template <int HD, int NP> constexpr bool kDkvOwn = NP == 3 || HD == 128;
template <int HD, int NP, bool OWN = (NP == 3)>
constexpr int kOwnBytes = OWN ? 2 * NP * 64 * Cfg<HD>::ROWB : 0;

template <int HD, int BN, int NWG, int NP, int ST, bool DELTA>
__device__ __forceinline__ int dq_consume(const MstFlashArgs& a, const Ring<NWG, ST>& ring, int b,
                                          int h, int q0, int it) {
  static_assert(NP == 1 || (BN == 64 && !DELTA), "the SS products are m64n64, K5's dQ kernel");
  constexpr int TILE = NP * BN * Cfg<HD>::ROWB;
  const int Tn = a.T;
  int valid, t0;
  const int ntiles = fwd_tiles<BN, NWG * 64, NP>(a, b, q0, valid, t0);
  const int w0 = q0 + (threadIdx.x / 128) * 64, W = window_of<NP>(a);
  const Frag f;
  // q (bf16: unscaled; float32: the pieces of q * sm_scale) and dO: A
  // fragments (NP = 1), or planes in this warpgroup's part of shared memory.
  uint32_t qf[1][HD / 16][4], gf[1][HD / 16][4];
  const uint32_t own = ring.stages() + ST * kKvStage<HD, BN, NP> +
                       (threadIdx.x / 128) * kOwnBytes<HD, NP>;
  if constexpr (NP == 1) {
    load_frags<HD>(qf[0], head(static_cast<const bf16*>(a.q), a.sq, b, h), a.sq[2], w0, Tn, f);
    load_frags<HD>(gf[0], head(static_cast<const bf16*>(a.dout), a.sdo, b, h), a.sdo[2], w0, Tn,
                   f);
  } else {
    load_own_rows<HD, NP>(own, head(static_cast<const bf16*>(a.q), a.sq, b, h), a.sq[2],
                          plane_of(a), w0, Tn);
    load_own_rows<HD, NP>(own + kOwnBytes<HD, NP> / 2,
                          head(static_cast<const bf16*>(a.dout), a.sdo, b, h), a.sdo[2],
                          plane_of(a), w0, Tn);
    own_rows_landed();
  }
  // lse2 = lse log2 e, so that p = 2^(s scale log2 e - lse2); a row without
  // terms (past T, or one that saw no key) gets 1e30 and with it p = 0.
  float lse2[2], delta[2];
  const float scale2 = (NP == 1 ? a.bwd_scale : 1.f) * kLog2e;
  if (DELTA) {  // this thread's share of rowsum(dO * O) for its two rows
    uint32_t of[HD / 16][4];
    load_frags<HD>(of, head(static_cast<const bf16*>(a.out), a.so, b, h), a.so[2], w0, Tn, f);
    delta[0] = delta[1] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack(of[kk][i]), y = unpack(gf[0][kk][i]);
        delta[i & 1] = fmaf(y.y, x.y, fmaf(y.x, x.x, delta[i & 1]));
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + f.row + 8 * r;
    const size_t at = ((size_t)b * a.H + h) * Tn + row;
    const float lse = row < Tn ? a.lse[at] : kNegInf;
    lse2[r] = lse > kSentinel ? lse * kLog2e : -kNegInf;
    if (DELTA) {
      delta[r] = quad_sum(delta[r]);
      if (row < Tn && a.g_lse != nullptr) delta[r] -= a.g_lse[at];
      if (row < Tn && f.col == 0) a.delta[at] = delta[r];
    } else {
      delta[r] = row < Tn ? a.delta[at] : 0.f;
    }
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  for (int t = t0; t < ntiles; ++t, ++it) {
    const int k0 = t * BN;
    const uint32_t ks = ring.stages() + (it % ST) * 2 * TILE, vs = ks + TILE;
    const bool active = (!a.causal || k0 <= w0 + 63) && (W <= 0 || k0 + BN - 1 > w0 - W);
    float s[BN / 2], dp[BN / 2];
    ring.wait_full(it);
    if (active) {
      wgmma_fence();
      if constexpr (NP == 1) {
        mma_nt<HD, 1>(s, qf, ks);
        mma_nt<HD, 1>(dp, gf, vs);
      } else {
        mma_nt_ss<HD, NP>(s, own, ks);
        mma_nt_ss<HD, NP>(dp, own + kOwnBytes<HD, NP> / 2, vs);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // dS = P (dP - delta), P = exp(scale S - lse); on the tiles that cross
      // key_lens, the diagonal or the window's edge the masked terms are
      // selected away.
      if (k0 + BN > valid || (a.causal && k0 + BN - 1 > w0) ||
          (W > 0 && k0 <= w0 + 63 - W)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, row = w0 + f.row + 8 * r, col = k0 + 8 * j + f.col + (e & 1);
            const bool ok = col < valid && sees(a, W, row, col);
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
      uint32_t dsf[NP][BN / 16][4];
      to_frags<BN, NP>(dsf, s);
      wgmma_fence();
      mma_nn<HD, BN, NP>(dq, dsf, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    ring.release(it);
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] *= a.bwd_scale;
  store_rows<HD>(head(static_cast<OutT<NP>*>(a.dq), a.sdq, b, h), a.sdq[2], w0, Tn, f, dq);
  return it;
}

// grid (ceil(T / (64 NWG)), H, B), one item a block; operands of NP pieces.
template <int HD, int BN, int NWG, int NP>
__global__ void __launch_bounds__(NWG * 128 + 128, 1)
    flash_bwd_dq_kernel_tc(const MstFlashArgs a) {
  constexpr int ST = kStagesOf<HD, NP>;
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG, ST> ring(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * NWG * 64;
  ring.init();
  if (threadIdx.x >= NWG * 128) {  // the producer warpgroup: K and V, as in the forward
    regs_give_back<kProducerRegs>();
    fwd_produce<HD, BN, NWG, NP, ST>(a, ring, b, h, q0, 0);
    return;
  }
  regs_take<kConsumerRegs<NWG>>();
  dq_consume<HD, BN, NWG, NP, ST, false>(a, ring, b, h, q0, 0);
}

// K3's dQ kernel, delta folded in: the same items, a block looping over
// them in the core's order.
template <int HD, int BN, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 128, 3 - NWG)
    core_bwd_dq_kernel_tc(const MstFlashArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG> ring(smem_raw);
  const Schedule sched(a, smem_raw, ring.stages() + kStages * kKvStage<HD, BN, 1>, NWG * 64,
                       false, a.causal);
  ring.init();
  int it = 0, b, h, x;
  if (threadIdx.x >= NWG * 128) {
    regs_give_back<kProducerRegs>();
    for (int k = 0, i; (i = sched.index(k)) >= 0; ++k) {
      sched.item(i, b, h, x);
      it = fwd_produce<HD, BN, NWG, 1, kStages>(a, ring, b, h, x * NWG * 64, it);
    }
    return;
  }
  regs_take<kConsumerRegs<NWG>>();
  for (int k = 0, i; (i = sched.index(k)) >= 0; ++k) {
    sched.item(i, b, h, x);
    it = dq_consume<HD, BN, NWG, 1, kStages, true>(a, ring, b, h, x * NWG * 64, it);
  }
}

// A stage of the dK/dV kernel: the Q and dO tiles (NP planes each), then lse
// and delta of the tile's queries, rounded up so that the next stage's tiles
// stay aligned.
template <int HD, int BN, int NP = 1> struct DkvStage {
  static constexpr int BYTES = 2 * NP * BN * Cfg<HD>::ROWB + (2 * BN * 4 + 1023) / 1024 * 1024;
};

// ----------------------------------------------------------------------------
// K5, third kernel: dK and dV. A warpgroup owns 64 keys and walks the
// BN-query tiles of Q and dO that can see them, with the tiles' lse and
// delta beside them. The tiles are transposed: S^T = K Q^T and dP^T = V
// dO^T, rows keys, columns queries.

// The first query of the walk and its tiles: keys at or past key_lens get
// nothing; causal queries before k0 see none of the item's keys, and with a
// window those from its last key below key_lens + W on none either.
template <int BN, int BK, int NP>
__device__ __forceinline__ int dkdv_tiles(const MstFlashArgs& a, int b, int k0, int& valid,
                                          int& qbegin) {
  valid = min(max(a.key_lens[b], 0), a.T);
  qbegin = k0 < valid ? (a.causal ? (k0 / BN) * BN : 0) : a.T;
  const int W = window_of<NP>(a);
  const int qend = W > 0 ? min(a.T, min(k0 + BK, valid) - 1 + W) : a.T;
  return qend > qbegin ? (qend - qbegin + BN - 1) / BN : 0;
}

template <int HD, int BN, int NWG, int NP, int ST>
__device__ __forceinline__ int dkdv_produce(const MstFlashArgs& a, const Ring<NWG, ST>& ring, int b,
                                            int h, int k0, int it) {
  constexpr int PLANE = BN * Cfg<HD>::ROWB, TILE = NP * PLANE, STAGE = DkvStage<HD, BN, NP>::BYTES;
  const int Tn = a.T;
  int valid, qbegin;
  const int ntiles = dkdv_tiles<BN, NWG * 64, NP>(a, b, k0, valid, qbegin);
  if (threadIdx.x % 128 == 0 && ntiles > 0) add_tile_stats(a, 1, ntiles);
  const bf16* qh = head(static_cast<const bf16*>(a.q), a.sq, b, h);
  const bf16* gh = head(static_cast<const bf16*>(a.dout), a.sdo, b, h);
  const float* lse = a.lse + ((size_t)b * a.H + h) * Tn;
  const float* delta = a.delta + ((size_t)b * a.H + h) * Tn;
  const long long plane = plane_of(a);
  const int lane = threadIdx.x % 128;
  for (int t = 0; t < ntiles; ++t, ++it) {
    const uint32_t qs = ring.stages() + (it % ST) * STAGE;
    const int i0 = qbegin + t * BN;
    ring.wait_empty(it);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      load_tile_async<HD, BN, 128>(qs + p * PLANE, qh + p * plane, a.sq[2], i0, Tn, lane);
      load_tile_async<HD, BN, 128>(qs + TILE + p * PLANE, gh + p * plane, a.sdo[2], i0, Tn, lane);
    }
#pragma unroll
    for (int e = lane; e < 2 * BN; e += 128) {  // lse, then delta; past T as zeros
      const int qi = i0 + e % BN;
      const float* src = (e < BN ? lse : delta) + (qi < Tn ? qi : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(qs + 2 * TILE + e * 4),
                   "l"(src), "r"(qi < Tn ? 4 : 0));
    }
    ring.commit_full(it);
  }
  return it;
}

// The walk of one key tile over query head h's tiles, into dk and dv; the
// K and V rows (A fragments kf, vf, or OWN planes at `own`) loaded by the
// caller.
template <int HD, int BN, int NWG, int NP, int ST>
__device__ __forceinline__ int dkdv_walk(const MstFlashArgs& a, const Ring<NWG, ST>& ring,
                                         uint8_t* smem_raw, int b, int k0, int it,
                                         const uint32_t (&kf)[1][HD / 16][4],
                                         const uint32_t (&vf)[1][HD / 16][4], uint32_t own,
                                         float (&dk)[HD / 2], float (&dv)[HD / 2]) {
  constexpr bool OWN = kDkvOwn<HD, NP>;
  constexpr int OWN_BYTES = kOwnBytes<HD, NP, OWN>;
  static_assert(!OWN || BN == 64, "the SS products are m64n64");
  constexpr int TILE = NP * BN * Cfg<HD>::ROWB, STAGE = DkvStage<HD, BN, NP>::BYTES;
  static_assert((NWG * 64) % BN == 0 || BN % (NWG * 64) == 0,
                "the causal walk starts at the item's first key");
  const int Tn = a.T;
  int valid, qbegin;
  const int ntiles = dkdv_tiles<BN, NWG * 64, NP>(a, b, k0, valid, qbegin);
  const int w0 = k0 + (threadIdx.x / 128) * 64, W = window_of<NP>(a);
  const Frag f;
  const uint8_t* const stage_ptr = smem_ptr(smem_raw, ring.stages());
  // float32: the Q tiles hold the pieces of q * sm_scale, so S^T and dK
  // come out scaled.
  const float scale2 = (NP == 1 ? a.bwd_scale : 1.f) * kLog2e;

  for (int t = 0; t < ntiles; ++t, ++it) {
    const int i0 = qbegin + t * BN;
    const uint32_t qs = ring.stages() + (it % ST) * STAGE, gs = qs + TILE;
    // else every query is before the keys, or past every key's window
    const bool active = (!a.causal || i0 + BN - 1 >= w0) && (W <= 0 || i0 < w0 + 63 + W);
    float s[BN / 2], dp[BN / 2];
    ring.wait_full(it);
    if (active) {
      wgmma_fence();
      if constexpr (!OWN) {
        mma_nt<HD, 1>(s, kf, qs);
        mma_nt<HD, 1>(dp, vf, gs);
      } else {
        mma_nt_ss<HD, NP>(s, own, qs);
        mma_nt_ss<HD, NP>(dp, own + OWN_BYTES / 2, gs);
      }
      wgmma_commit();
      wgmma_wait<0>();
      const float* lses =
          reinterpret_cast<const float*>(stage_ptr + (it % ST) * STAGE + 2 * TILE);
      const float* deltas = lses + BN;
      fence_regs(s);
      fence_regs(dp);
      // P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T - delta), lse and
      // delta by column; on the tiles that cross key_lens, T, the diagonal or
      // the window's edge the masked terms are selected away.
      if (w0 + 64 > valid || i0 + BN > Tn || (a.causal && i0 < w0 + 63) ||
          (W > 0 && i0 + BN - 1 >= w0 + W)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 lj = *reinterpret_cast<const float2*>(lses + 8 * j + f.col);
          const float2 dj = *reinterpret_cast<const float2*>(deltas + 8 * j + f.col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = w0 + f.row + 8 * (e >> 1), qi = i0 + 8 * j + f.col + (e & 1);
            const float le = (e & 1) ? lj.y : lj.x, de = (e & 1) ? dj.y : dj.x;
            const bool ok = key < valid && qi < Tn && le > kSentinel && sees(a, W, qi, key);
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
      if constexpr (NP == 1) {
        uint32_t pf[1][BN / 16][4], dsf[1][BN / 16][4];
        to_frags<BN, 1>(pf, s);
        to_frags<BN, 1>(dsf, dp);
        wgmma_fence();
        mma_nn<HD, BN, 1>(dv, pf, gs);
        mma_nn<HD, BN, 1>(dk, dsf, qs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      } else {
        // One operand's pieces at a time: P^T's for dV, then dS^T's for dK.
        {
          uint32_t pf[NP][BN / 16][4];
          to_frags<BN, NP>(pf, s);
          wgmma_fence();
          mma_nn<HD, BN, NP>(dv, pf, gs);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
        }
        uint32_t dsf[NP][BN / 16][4];
        to_frags<BN, NP>(dsf, dp);
        wgmma_fence();
        mma_nn<HD, BN, NP>(dk, dsf, qs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
      }
    }
    ring.release(it);
  }
  return it;
}

// dK and dV of the key tile from k0 of K/V head hk: the walks of its group's
// query heads, one after the other.
template <int HD, int BN, int NWG, int NP, int ST>
__device__ __forceinline__ int dkdv_consume(const MstFlashArgs& a, const Ring<NWG, ST>& ring,
                                            uint8_t* smem_raw, int b, int hk, int k0, int it) {
  constexpr bool OWN = kDkvOwn<HD, NP>;
  constexpr int OWN_BYTES = kOwnBytes<HD, NP, OWN>, STAGE = DkvStage<HD, BN, NP>::BYTES;
  const int Tn = a.T, w0 = k0 + (threadIdx.x / 128) * 64;
  const Frag f;
  // K and V: A fragments, or (OWN) planes in this warpgroup's part of
  // shared memory.
  uint32_t kf[1][HD / 16][4], vf[1][HD / 16][4];
  const uint32_t own = ring.stages() + ST * STAGE + (threadIdx.x / 128) * OWN_BYTES;
  if constexpr (!OWN) {
    load_frags<HD>(kf[0], head(static_cast<const bf16*>(a.k), a.sk, b, hk), a.sk[2], w0, Tn, f);
    load_frags<HD>(vf[0], head(static_cast<const bf16*>(a.v), a.sv, b, hk), a.sv[2], w0, Tn, f);
  } else {
    load_own_rows<HD, NP>(own, head(static_cast<const bf16*>(a.k), a.sk, b, hk), a.sk[2],
                          plane_of(a), w0, Tn);
    load_own_rows<HD, NP>(own + OWN_BYTES / 2, head(static_cast<const bf16*>(a.v), a.sv, b, hk),
                          a.sv[2], plane_of(a), w0, Tn);
    own_rows_landed();
  }
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  const int G = group_of<NP>(a);
  for (int g = 0; g < G; ++g)
    it = dkdv_walk<HD, BN, NWG, NP, ST>(a, ring, smem_raw, b, k0, it, kf, vf, own, dk, dv);
  if constexpr (NP == 1) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] *= a.bwd_scale;
  }
  store_rows<HD>(head(static_cast<OutT<NP>*>(a.dk), a.sdk, b, hk), a.sdk[2], w0, Tn, f, dk);
  store_rows<HD>(head(static_cast<OutT<NP>*>(a.dv), a.sdv, b, hk), a.sdv[2], w0, Tn, f, dv);
  return it;
}

// The producer of dkdv_consume's walks: the query tiles of each head of K/V
// head hk's group.
template <int HD, int BN, int NWG, int NP, int ST>
__device__ __forceinline__ int dkdv_produce_group(const MstFlashArgs& a, const Ring<NWG, ST>& ring,
                                                  int b, int hk, int k0, int it) {
  const int G = group_of<NP>(a);
  for (int g = 0; g < G; ++g) it = dkdv_produce<HD, BN, NWG, NP, ST>(a, ring, b, hk * G + g, k0, it);
  return it;
}

// grid (ceil(T / (64 NWG)), H / group, B), one item (a key tile of a K/V
// head) a block; operands of NP pieces.
template <int HD, int BN, int NWG, int NP>
__global__ void __launch_bounds__(NWG * 128 + 128, 1)
    flash_bwd_dkdv_kernel_tc(const MstFlashArgs a) {
  constexpr int ST = kStagesOf<HD, NP>;
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG, ST> ring(smem_raw);
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * NWG * 64;
  ring.init();
  if (threadIdx.x >= NWG * 128) {  // the producer warpgroup
    regs_give_back<kProducerRegs>();
    dkdv_produce_group<HD, BN, NWG, NP, ST>(a, ring, b, hk, k0, 0);
    return;
  }
  regs_take<kConsumerRegs<NWG>>();
  dkdv_consume<HD, BN, NWG, NP, ST>(a, ring, smem_raw, b, hk, k0, 0);
}

// K3's dK/dV kernel: the same items, a block looping over them in the
// core's order (key tiles in order: under causal the first walk the most
// queries).
template <int HD, int BN, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 128, 3 - NWG)
    core_bwd_dkdv_kernel_tc(const MstFlashArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<NWG> ring(smem_raw);
  const Schedule sched(a, smem_raw, ring.stages() + kStages * DkvStage<HD, BN>::BYTES, NWG * 64,
                       true, false);
  ring.init();
  int it = 0, b, h, x;
  if (threadIdx.x >= NWG * 128) {
    regs_give_back<kProducerRegs>();
    for (int k = 0, i; (i = sched.index(k)) >= 0; ++k) {
      sched.item(i, b, h, x);
      it = dkdv_produce<HD, BN, NWG, 1, kStages>(a, ring, b, h, x * NWG * 64, it);
    }
    return;
  }
  regs_take<kConsumerRegs<NWG>>();
  for (int k = 0, i; (i = sched.index(k)) >= 0; ++k) {
    sched.item(i, b, h, x);
    it = dkdv_consume<HD, BN, NWG, 1, kStages>(a, ring, smem_raw, b, h, x * NWG * 64, it);
  }
}

// ----------------------------------------------------------------------------

// Dynamic shared memory of a kernel: the slack that aligns it to 1024 bytes,
// the barriers' 1024 bytes, the stages; above 48 KB a kernel must be told.
template <typename K> cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD, int BN, int NP = 1>
constexpr int kTileSmem = 2048 + kStagesOf<HD, NP> * kKvStage<HD, BN, NP>;
template <int HD, int BN, int NP = 1>
constexpr int kDkvSmem = 2048 + kStagesOf<HD, NP> * DkvStage<HD, BN, NP>::BYTES;
// K5's dK/dV kernel: its stages and its warpgroups' own rows.
template <int HD, int NP>
constexpr int kFlashDkvSmem =
    kDkvSmem<HD, kDkvTile, NP> + kDkvGroups * kOwnBytes<HD, NP, kDkvOwn<HD, NP>>;
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100
static_assert(kTileSmem<64, kFwdTile, 3> <= kMaxSmem && kTileSmem<32, kFwdTile, 3> <= kMaxSmem,
              "K4's float32 stages");
static_assert(kTileSmem<64, kDqTile, 3> + kDqGroups * kOwnBytes<64, 3> <= kMaxSmem &&
                  kFlashDkvSmem<64, 3> <= kMaxSmem && kFlashDkvSmem<128, 1> <= kMaxSmem,
              "K5's float32 stages and own rows, and its bf16 ones at HD=128");

// Blocks of `kernel` (NWG consumer warpgroups, `smem` bytes) that the card
// holds at once, or 0 if the runtime cannot tell.
template <int NWG, typename K> int resident_blocks(K kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NWG * 128 + 128, smem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

// Launch `kernel` with NWG consumer warpgroups: K4/K5's grid of one block an
// item (over `heads` heads, 0 meaning a.H), or with `blocks` > 0 the core's
// grid of that many blocks, at most one an item.
template <int NWG, typename K>
cudaError_t launch(K kernel, int smem, const MstFlashArgs& a, int blocks, cudaStream_t stream,
                   int heads = 0) {
  constexpr int threads = NWG * 128 + 128;
  const int nx = (a.T + 64 * NWG - 1) / (64 * NWG);
  if (blocks == 0) {
    kernel<<<dim3(nx, heads > 0 ? heads : a.H, a.B), threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  const long long items = (long long)a.B * a.H * nx;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<items < blocks ? (int)items : blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// float32 inputs as the kernels read them: q, k, v and dout replaced by
// their bf16 pieces ([3, B, H, T, HD] contiguous), out, lse, delta and the
// gradients as they are.
MstFlashArgs pieces_view(const MstFlashArgs& a) {
  MstFlashArgs p = a;
  const long long s[3] = {(long long)a.H * a.T * a.HD, (long long)a.T * a.HD, a.HD};
  p.q = a.q3;
  p.k = a.k3;
  p.v = a.v3;
  p.dout = a.dout3;
  for (int i = 0; i < 3; ++i) p.sq[i] = p.sk[i] = p.sv[i] = p.sdo[i] = s[i];
  return p;
}

// NP = 1: bf16 inputs; NP = 3: float32 inputs (`a` with their pieces).
template <int HD, int NP> cudaError_t launch_forward(const MstFlashArgs& a, cudaStream_t stream) {
  constexpr int BN = kFwdTileOf<HD>, NWG = kFwdGroups, smem = kTileSmem<HD, BN, NP>;
  auto kernel = flash_fwd_kernel_tc<HD, BN, NWG, NP>;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  return launch<NWG>(kernel, smem, NP == 1 ? a : pieces_view(a), 0, stream);
}

template <int HD, int NP> cudaError_t launch_backward(const MstFlashArgs& a, cudaStream_t stream) {
  using T = OutT<NP>;
  const size_t rows = (size_t)a.B * a.H * a.T;
  constexpr int rows_a_block = 256 / (HD / (16 / (int)sizeof(T)));
  flash_bwd_delta_kernel_tc<HD, T>
      <<<(unsigned)((rows + rows_a_block - 1) / rows_a_block), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const MstFlashArgs ap = NP == 1 ? a : pieces_view(a);
  {
    constexpr int BN = kDqTile, NWG = kDqGroups;
    constexpr int smem = kTileSmem<HD, BN, NP> + NWG * kOwnBytes<HD, NP>;
    auto kernel = flash_bwd_dq_kernel_tc<HD, BN, NWG, NP>;
    static const cudaError_t allowed = allow_smem(kernel, smem);
    if (allowed != cudaSuccess) return allowed;
    err = launch<NWG>(kernel, smem, ap, 0, stream);
    if (err != cudaSuccess) return err;
  }
  constexpr int BN = kDkvTile, NWG = kDkvGroups, smem = kFlashDkvSmem<HD, NP>;
  auto kernel = flash_bwd_dkdv_kernel_tc<HD, BN, NWG, NP>;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  return launch<NWG>(kernel, smem, ap, 0, stream, a.H / (a.group > 1 ? a.group : 1));
}

// The core's kernels: as many blocks as the card holds at once (counted on
// the card of the first launch), each looping over items.
template <int HD> cudaError_t launch_core_forward(const MstFlashArgs& a, cudaStream_t stream) {
  constexpr int BN = kCoreFwdTile, NWG = kCoreFwdGroups, smem = kTileSmem<HD, BN> + kScheduleBytes;
  auto kernel = core_fwd_kernel_tc<HD, BN, NWG>;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  static const int blocks = resident_blocks<NWG>(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  if (blocks == 0) return cudaErrorInvalidConfiguration;
  return launch<NWG>(kernel, smem, a, blocks, stream);
}

template <int HD> cudaError_t launch_core_backward(const MstFlashArgs& a, cudaStream_t stream) {
  {
    constexpr int BN = kCoreDqTile, NWG = kCoreDqGroups, smem = kTileSmem<HD, BN> + kScheduleBytes;
    auto kernel = core_bwd_dq_kernel_tc<HD, BN, NWG>;
    static const cudaError_t allowed = allow_smem(kernel, smem);
    static const int blocks = resident_blocks<NWG>(kernel, smem);
    if (allowed != cudaSuccess) return allowed;
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    const cudaError_t err = launch<NWG>(kernel, smem, a, blocks, stream);
    if (err != cudaSuccess) return err;
  }
  constexpr int BN = kCoreDkvTile, NWG = kCoreDkvGroups, smem = kDkvSmem<HD, BN> + kScheduleBytes;
  auto kernel = core_bwd_dkdv_kernel_tc<HD, BN, NWG>;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  static const int blocks = resident_blocks<NWG>(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  if (blocks == 0) return cudaErrorInvalidConfiguration;
  return launch<NWG>(kernel, smem, a, blocks, stream);
}

// bf16 at HD = 16, 32, 64, 128; float32 (NP = 3) at 32 and 64, anything
// else cudaErrorInvalidValue.
template <int NP> cudaError_t run_hd(const MstFlashArgs& a, bool backward, cudaStream_t s) {
  switch (a.HD) {
    case 32: return backward ? launch_backward<32, NP>(a, s) : launch_forward<32, NP>(a, s);
    case 64: return backward ? launch_backward<64, NP>(a, s) : launch_forward<64, NP>(a, s);
  }
  if constexpr (NP == 1) {
    switch (a.HD) {
      case 16: return backward ? launch_backward<16, 1>(a, s) : launch_forward<16, 1>(a, s);
      case 128: return backward ? launch_backward<128, 1>(a, s) : launch_forward<128, 1>(a, s);
    }
  }
  return cudaErrorInvalidValue;
}

cudaError_t run(const MstFlashArgs* a, bool backward, void* stream) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->H > 65535 || a->B > 65535 || a->window < 0 ||
      (a->window > 0 && !a->causal) || (a->group > 1 && a->H % a->group != 0))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_bf16) return run_hd<1>(*a, backward, s);
  // float32: the pieces of q, k, v (and dout) must be there, at the query
  // heads, without a window
  if (a->group > 1 || a->window > 0 || a->q3 == nullptr || a->k3 == nullptr || a->v3 == nullptr ||
      (backward && a->dout3 == nullptr))
    return cudaErrorInvalidValue;
  return run_hd<3>(*a, backward, s);
}

// ----------------------------------------------------------------------------
// The split of float32 inputs: out[p] = piece p (hi, mid, lo) of x * scale,
// x a strided [B, H, T, HD] float32 tensor (16-byte aligned rows), out
// [3, B, H, T, HD] bf16 contiguous. One thread a 16-byte piece of a row. What
// bounds it: bytes (4 read and 6 written an element).

__global__ void __launch_bounds__(256)
    split_bf16x3_kernel(const float* x, long long s0, long long s1, long long s2, int H, int T,
                        int HD, float scale, size_t n4, bf16* out) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const int q4 = HD / 4;
  const size_t row = i / q4;
  const int c = (int)(i % q4) * 4, t = (int)(row % T), h = (int)((row / T) % H);
  const size_t b = row / ((size_t)T * H);
  const float4 v = *reinterpret_cast<const float4*>(x + b * s0 + h * s1 + t * s2 + c);
  const float y[4] = {__fmul_rn(v.x, scale), __fmul_rn(v.y, scale), __fmul_rn(v.z, scale),
                      __fmul_rn(v.w, scale)};
  bf16 p[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split3(y[e], p[0][e], p[1][e], p[2][e]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    *reinterpret_cast<uint2*>(out + k * (n4 * 4) + i * 4) =
        make_uint2(pack_bf(p[k][0], p[k][1]), pack_bf(p[k][2], p[k][3]));
}

cudaError_t run_split(const float* x, const long long* st, int B, int H, int T, int HD, float scale,
                      bf16* out, cudaStream_t stream) {
  if (B < 1 || H < 1 || T < 1 || HD < 4 || HD % 4 != 0) return cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)out % 16 != 0 || st[0] % 4 != 0 || st[1] % 4 != 0 ||
      st[2] % 4 != 0)
    return cudaErrorMisalignedAddress;
  const size_t n4 = (size_t)B * H * T * HD / 4;
  const size_t blocks = (n4 + 255) / 256;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  split_bf16x3_kernel<<<(unsigned)blocks, 256, 0, stream>>>(x, st[0], st[1], st[2], H, T, HD,
                                                            scale, n4, out);
  return cudaGetLastError();
}

// The core's interleaved layout as strided [B, H, T, HD] heads: q, k and v of
// head h are the columns 3 h HD + {0, HD, 2 HD} of qkv [B, T, 3 H HD], with
// (b, h, t) strides (T W, 3 HD, W), W = 3 H HD; out and dout [B, T, H HD]
// are [B, T, H, HD]; dq, dk and dv the three column groups of dqkv.
MstFlashArgs flash_view(const MstCoreArgs& c) {
  MstFlashArgs a{};
  const long long W = 3LL * c.H * c.HD, Wo = (long long)c.H * c.HD;
  const long long sqkv[3] = {c.T * W, 3LL * c.HD, W}, so[3] = {c.T * Wo, c.HD, Wo};
  const bf16* qkv = static_cast<const bf16*>(c.qkv);
  bf16* dqkv = static_cast<bf16*>(c.dqkv);
  a.q = qkv;
  a.k = qkv + c.HD;
  a.v = qkv + 2 * c.HD;
  a.key_lens = c.key_lens;
  a.out = c.out;
  a.lse = c.lse;
  a.dout = c.dout;
  a.delta = c.delta;
  if (dqkv != nullptr) {
    a.dq = dqkv;
    a.dk = dqkv + c.HD;
    a.dv = dqkv + 2 * c.HD;
  }
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = a.sk[i] = a.sv[i] = a.sdq[i] = a.sdk[i] = a.sdv[i] = sqkv[i];
    a.so[i] = a.sdo[i] = so[i];
  }
  a.B = c.B;
  a.H = c.H;
  a.T = c.T;
  a.HD = c.HD;
  a.causal = c.causal;
  a.is_bf16 = c.is_bf16;
  a.fwd_scale = c.fwd_scale;
  a.bwd_scale = c.bwd_scale;
  a.group = 1;
  return a;
}

cudaError_t run_core(const MstCoreArgs* c, bool backward, void* stream) {
  if (c->B < 1 || c->T < 1 || c->H < 1 || !c->is_bf16) return cudaErrorInvalidValue;
  // 16-byte rows: the bases here, the strides by HD (flash_view)
  if (((uintptr_t)c->qkv | (uintptr_t)c->out | (uintptr_t)c->dout | (uintptr_t)c->dqkv) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const MstFlashArgs a = flash_view(*c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c->HD) {
    case 32: return backward ? launch_core_backward<32>(a, s) : launch_core_forward<32>(a, s);
    case 64: return backward ? launch_core_backward<64>(a, s) : launch_core_forward<64>(a, s);
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

extern "C" int mst_split_bf16x3(const void* x, const long long* strides, int B, int H, int T,
                                int HD, float scale, void* out, void* stream) {
  return (int)run_split(static_cast<const float*>(x), strides, B, H, T, HD, scale,
                        static_cast<bf16*>(out), static_cast<cudaStream_t>(stream));
}

extern "C" int mst_core_tc_forward(const MstCoreArgs* a, void* stream) {
  return (int)run_core(a, false, stream);
}

extern "C" int mst_core_tc_backward(const MstCoreArgs* a, void* stream) {
  return (int)run_core(a, true, stream);
}

extern "C" const char* mst_core_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
