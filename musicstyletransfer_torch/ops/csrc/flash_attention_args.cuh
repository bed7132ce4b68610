// The argument block of the flash attention kernels (K4 forward, K5
// backward), shared by flash_attention.cu (CUDA-core float32 arithmetic) and
// flash_attention_tc.cu (tensor cores: bf16 operands, and float32 ones as
// three bf16 pieces each).
#pragma once

extern "C" {
// Mirrored by _Args in flash_attention.py; keep the two in the same order.
// Strides are in elements, for the (b, h, t) dimensions of a [B, H, T, HD]
// tensor whose last dimension is contiguous.
struct MstFlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* key_lens;  // [B] int32 valid (prefix) key counts
  void* out;            // K4 writes it, K5 reads it
  float* lse;           // [B, H, T] float32: K4 writes it, K5 reads it
  const void* dout;     // cotangent of out (K5)
  const float* g_lse;   // [B, H, T] float32 cotangent of lse, or null (K5)
  float* delta;         // [B, H, T] float32 scratch (K5)
  void* dq;
  void* dk;
  void* dv;
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int B, H, T, HD, causal, is_bf16;
  float fwd_scale;  // sm_scale rounded to the input type
  float bwd_scale;  // sm_scale in float32
  // float32 inputs on the tensor cores (flash_attention_tc.cu): the bf16
  // pieces hi, mid, lo of q * sm_scale, k, v and dout (K5), each
  // [3, B, H, T, HD] contiguous (mst_split_bf16x3); null otherwise.
  const void* q3;
  const void* k3;
  const void* v3;
  const void* dout3;
  // flash_attention_tc.cu's bf16 kernels only (the wrapper sends the rest
  // 0, 1, null): window W > 0 with causal, query i sees keys i - W < j <= i;
  // group G, query head h reads K/V head h / G of k and v (H / G heads), and
  // dk, dv are [B, H / G, T, HD], summed over each group; tile_stats, when
  // not null, gathers int64 [2]: the key tiles K4 and the dQ kernel loaded,
  // then the dK/dV kernel's query tiles.
  int window;
  int group;
  unsigned long long* tile_stats;
  // bf16 inputs on the tensor cores: K4 writes here, when not null, what
  // rounding out to bf16 left over (out32 - out, rounded to bf16), strided as
  // out; K5's delta then sums dout * (out + out_lo), the float32 out to 2^-16.
  void* out_lo;
};
}
