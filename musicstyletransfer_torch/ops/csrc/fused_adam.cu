// Adam's update on Hopper as one pass over the optimizer's flat float32
// buffers (training/optimizer.py), and the reduction pass over the gradient
// before it.
//
// Replaces no Pallas kernel: the JAX package's update is optax's chain
// (musicstyletransfer_tpu/training/optimizer.py), which XLA fuses into a few
// passes. In the port the chain is some two dozen whole-buffer torch ops a
// piece of the buffers (Optimizer._update_piece), each reading and writing
// device memory, plus a bool tensor for the non-finite guard and a
// temporary for the logged norm: ~330 GB a step at 1.69B parameters. The
// work needs far less, and is bound by bytes alone (~10 operations an
// element against the 295 a byte the card needs before its arithmetic is the
// limit):
//
// - grad_stats (kernel A): reads g once (4 bytes an element) and writes the
//   sum of squares and whether every element is finite;
// - adam_update (kernel B): reads g, p, mu, nu and writes p, mu, nu (28
//   bytes an element): 47.3 GB, 14.1 ms at 3.35 TB/s for 1.69B elements.
//
// Design. Both kernels stream 16-byte pieces (four floats; the wrapper
// checks the alignment), a scalar tail for the last n % 4 elements, a grid
// sized from the vector's length and the card's SMs (ops/fused_adam.grid_of)
// walked with a grid stride, and 64-bit indices, so one launch takes any
// length. Nothing is kept between elements, so nothing but the stream
// touches device memory.
//
// Kernel B is the chain's arithmetic element by element, bit for bit: each
// rounding of the chain in the chain's order, written with the _rn
// intrinsics so that nothing is contracted into an FMA; the constants are
// the Python floats cast to float32 as TensorIterator casts them; the values
// that change from step to step (the rate, the two bias corrections, the
// guard's decision, the global norm) are read from device memory, so a CUDA
// graph that captured the launch replays it for every later step. It covers
// adam and adamw with clip_gradient, clip_global_norm, wd and
// skip_nonfinite; accumulate_steps > 1, sgd and rmsprop stay on the chain
// (Optimizer decides from its settings; no cell or recipe default runs them).
//
// Kernel A sums (double) g * g: each thread in its elements' index order
// (the square of a float is exact in double), then the warp by shuffles, the
// block in warp order and the blocks in block order in a second launch of one
// block, in double, rounded to float32 once at the end. The order is fixed,
// so the sum repeats bit for bit at a given grid. Its error follows from
// that order. The squares are exact in double (48 significant bits) and
// not negative, so the sum's relative error in double is at most h * 2^-53,
// h the most additions any square passes through: 3 in its float4, one a
// float4 the thread sums in sequence (at most n / (1024 * grid) + 1: 1,561 at
// 1.69B elements and the H100's 1,056 blocks), 5 + 5 in the block's shuffle
// trees, at most grid / 256 + 1 in the last block's sequence (5) and 5 + 5
// there: h < 2^11, so under 2^-42 for any n below 2^31 at that grid. The one
// rounding to float32 at the end adds at most 2^-24, so the result lies within
// 2^-24 + 2^-42 < 2^-23 of the exact sum. torch.sum of g * g in float32
// rounds each square and each partial sum to float32, so the two agree to
// float32's accumulation error (the tests hold them within 1e-5). A finite
// square never overflows double, so the sum is finite exactly when every
// element is: that is the finite flag.

#include <cuda_runtime.h>

struct MstAdamConsts {  // the chain's Python floats, cast to float32 (ctypes: _Consts)
  float b1, one_minus_b1, b2, one_minus_b2, eps;
  float clip;      // clamp(-clip, clip) where has_clip
  float max_norm;  // clip_global_norm where a norm is given
  float wd;        // MXNet's decay, added to the gradient (0: none)
  float adamw_wd;  // adamw's decoupled decay (0: none)
  int has_clip;
};

namespace {

constexpr int kThreads = 256;

struct StepValues {  // read from device memory once a launch
  float rate, bc1, bc2, norm;
  bool apply, scale_by_norm;
};

__device__ __forceinline__ float clamp_like_torch(float v, float lo, float hi) {
  // torch.clamp: max with lo, then min with hi; NaN falls through both
  float m = v < lo ? lo : v;
  return m > hi ? hi : m;
}

// One element of the chain (Optimizer._update_piece, name adam/adamw, no emit).
__device__ __forceinline__ void adam_element(float g, float& p, float& m, float& v,
                                             const MstAdamConsts& c, const StepValues& s) {
  float u = g;
  if (c.has_clip) u = clamp_like_torch(u, -c.clip, c.clip);
  // where(norm < max_norm, u, u / norm * max_norm)
  if (s.scale_by_norm) u = __fmul_rn(__fdiv_rn(u, s.norm), c.max_norm);
  if (c.wd != 0.0f) u = __fadd_rn(u, __fmul_rn(c.wd, p));
  const float mu = __fadd_rn(__fmul_rn(c.one_minus_b1, u), __fmul_rn(c.b1, m));
  const float nu = __fadd_rn(__fmul_rn(c.one_minus_b2, __fmul_rn(u, u)), __fmul_rn(c.b2, v));
  const float mu_hat = __fdiv_rn(mu, s.bc1);
  const float nu_hat = __fdiv_rn(nu, s.bc2);
  float step = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), c.eps));
  if (c.adamw_wd != 0.0f) step = __fadd_rn(step, __fmul_rn(c.adamw_wd, p));
  const float update = __fmul_rn(s.rate, step);
  if (s.apply) {  // where(keep, new, old): the guard keeps the old moments
    m = mu;
    v = nu;
  }
  p = __fadd_rn(p, s.apply ? update : 0.0f);  // add_(where(apply, update, 0))
}

__global__ void __launch_bounds__(kThreads, 4)
adam_update_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                   const float* __restrict__ g, long long n, MstAdamConsts c,
                   const float* __restrict__ rate, const float* __restrict__ bc1,
                   const float* __restrict__ bc2, const unsigned char* __restrict__ apply,
                   const float* __restrict__ norm) {
  StepValues s;
  s.rate = *rate;
  s.bc1 = *bc1;
  s.bc2 = *bc2;
  s.apply = apply == nullptr || *apply != 0;
  s.norm = norm == nullptr ? 0.0f : *norm;
  s.scale_by_norm = norm != nullptr && !(s.norm < c.max_norm);
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = first; i < n4; i += stride) {
    const float4 gg = g4[i];
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    adam_element(gg.x, pp.x, mm.x, vv.x, c, s);
    adam_element(gg.y, pp.y, mm.y, vv.y, c, s);
    adam_element(gg.z, pp.z, mm.z, vv.z, c, s);
    adam_element(gg.w, pp.w, mm.w, vv.w, c, s);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  const long long t = (n4 << 2) + first;  // the last n % 4 elements
  if (t < n) adam_element(g[t], p[t], m[t], v[t], c, s);
}

__device__ __forceinline__ double square_sum4(float4 a) {
  const double x = a.x, y = a.y, z = a.z, w = a.w;
  return ((x * x + y * y) + z * z) + w * w;
}

__device__ __forceinline__ double block_sum(double acc) {
  __shared__ double warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  acc = 0.0;
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  return acc;  // thread 0's is the block's
}

__global__ void __launch_bounds__(kThreads, 8)
grad_sq_partial_kernel(const float* __restrict__ g, long long n, double* __restrict__ partial) {
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  double acc = 0.0;
  for (long long i = first; i < n4; i += 2 * stride) {  // two loads in flight a thread
    const float4 a = g4[i];
    const float4 b = i + stride < n4 ? g4[i + stride] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc += square_sum4(a);
    acc += square_sum4(b);
  }
  const long long t = (n4 << 2) + first;
  if (t < n) {
    const double x = g[t];
    acc += x * x;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
grad_sq_final_kernel(const double* __restrict__ partial, int count, float* __restrict__ sq,
                     unsigned char* __restrict__ finite) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    *sq = __double2float_rn(acc);
    *finite = isfinite(acc) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Kernel B on `stream`: p, mu, nu updated in place from g, all n floats,
// 16-byte aligned. rate, bc1, bc2: float32 scalars on the device; apply: a
// bool scalar on the device or null (always); norm: a float32 scalar on the
// device or null (no global-norm clip).
int mst_adam_update(float* p, float* mu, float* nu, const float* g, long long n,
                    const MstAdamConsts* k, const float* rate, const float* bc1,
                    const float* bc2, const unsigned char* apply, const float* norm, int grid,
                    void* stream) {
  if (n <= 0) return 0;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  adam_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, mu, nu, g, n, *k, rate, bc1, bc2, apply, norm);
  return (int)cudaGetLastError();
}

// Kernel A on `stream`: sq (a float32 scalar) = the sum of g * g over n
// floats, finite (a bool scalar) = every element finite; partial holds at
// least `grid` doubles of scratch.
int mst_grad_stats(const float* g, long long n, double* partial, int grid, float* sq,
                   unsigned char* finite, void* stream) {
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grad_sq_partial_kernel<<<grid, kThreads, 0, s>>>(g, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_sq_final_kernel<<<1, kThreads, 0, s>>>(partial, grid, sq, finite);
  return (int)cudaGetLastError();
}

const char* mst_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
