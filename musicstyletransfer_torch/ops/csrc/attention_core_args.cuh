// The argument block of the attention core (K2 forward, K3 backward), shared
// by attention_core.cu (CUDA-core arithmetic, float32 and bf16, any head
// dimension) and the core's entry points in flash_attention_tc.cu (tensor
// cores, bf16 at head dimension 32 or 64).
#pragma once

extern "C" {
// Mirrored by _Args in attention_core.py; keep the two in the same order.
struct MstCoreArgs {
  const void* qkv;      // [B, T, H*3*HD] T
  const int* key_lens;  // [B] int32 valid (prefix) key counts
  void* out;            // [B, T, H*HD] T: K2 writes it, K3 reads it
  float* lse;           // [B, H, T] float32: K2 writes it, K3 reads it
  const void* dout;     // [B, T, H*HD] T cotangent of out (K3)
  float* delta;         // [B, H, T] float32 scratch (K3)
  void* dqkv;           // [B, T, H*3*HD] T (K3)
  int B, T, H, HD, causal, is_bf16;
  float fwd_scale;  // sm_scale rounded to T
  float bwd_scale;  // sm_scale in float32
};
}
