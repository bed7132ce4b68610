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
};
}
