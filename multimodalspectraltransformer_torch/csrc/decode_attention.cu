// Single-query causal self-attention for one KV-cached decode step (kernel K1).
//
// Replaces the Pallas TPU kernel multimodalspectraltransformer_tpu/ops/
// decode_attention.py::_kernel (pallas_call in decode_attention): for every
// (lane b, head h), scores = q . K[:, t] over the cached columns t <= pos,
// an f32 softmax, and the weighted sum of V. The cache keeps the JAX
// package's merged layout [B, H, 2*Dh, T] (K in rows 0:Dh, V in Dh:2*Dh);
// the kernel reads it and writes only out [B, H, Dh].
//
// What bounds it on the H100: device memory. Per (b, h) it reads
// 2*Dh*(pos+1) cache values and does about 4*Dh*(pos+1) flops, under one
// flop per byte, far below the ~20 flop/byte where the f32 units would be
// the limit. So the design reads each live cache value exactly once and
// nothing else:
//   - one warp per (b, h); lane l takes columns t = l, l+32, ... <= pos, so
//     for each of the 2*Dh rows the warp's loads are consecutive addresses
//     (T is the minor axis) and coalesce; columns past pos are never read;
//   - an online softmax per lane (running max, running sum, running Dh-wide
//     accumulator in registers), merged across the warp with shuffles, so
//     the scores never leave registers;
//   - f32 math for fp32 and bf16 storage alike; bf16 rounds once, at the
//     output (as the Pallas kernel does).
// A first, simple version: no shared memory, no tensor cores (Dh = 8 is far
// below an MMA tile and the work is memory bound anyway). Head sizes 8, 16,
// 32 and 64 are instantiated (ModelConfig's hidden_size / num_heads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int kWarpsPerBlock = 8;

template <typename T, int DH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                        T* __restrict__ out, int BH, int T_len, int pos) {
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= BH) return;
  const T* qp = q + (size_t)warp * DH;
  const T* kp = kv + (size_t)warp * 2 * DH * T_len;
  const T* vp = kp + (size_t)DH * T_len;

  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = to_f(qp[d]);

  float m = -INFINITY, l = 0.f, acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  for (int t = lane; t <= pos; t += 32) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) s += qr[d] * to_f(kp[(size_t)d * T_len + t]);
    const float m_new = fmaxf(m, s);
    const float c = expf(m - m_new);  // 0 on the first column (m = -inf)
    const float p = expf(s - m_new);
    l = l * c + p;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = acc[d] * c + p * to_f(vp[(size_t)d * T_len + t]);
    m = m_new;
  }

  // merge the 32 partial softmaxes; lane 0 always holds column 0, so M is finite
  float M = m;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  const float c = (m == -INFINITY) ? 0.f : expf(m - M);
  l *= c;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] *= c;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  if (lane == 0) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) store(out + (size_t)warp * DH + d, acc[d] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kv, void* out, int BH, int T_len, int Dh, int pos,
                   cudaStream_t stream) {
  const dim3 grid((BH + kWarpsPerBlock - 1) / kWarpsPerBlock), block(kWarpsPerBlock * 32);
  const T* qp = static_cast<const T*>(q);
  const T* kvp = static_cast<const T*>(kv);
  T* op = static_cast<T*>(out);
  switch (Dh) {  // 8: the model's head size (d_model 128 / 16 heads)
    case 8: decode_attention_kernel<T, 8><<<grid, block, 0, stream>>>(qp, kvp, op, BH, T_len, pos);
      break;
    case 16: decode_attention_kernel<T, 16><<<grid, block, 0, stream>>>(qp, kvp, op, BH, T_len, pos);
      break;
    case 32: decode_attention_kernel<T, 32><<<grid, block, 0, stream>>>(qp, kvp, op, BH, T_len, pos);
      break;
    case 64: decode_attention_kernel<T, 64><<<grid, block, 0, stream>>>(qp, kvp, op, BH, T_len, pos);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q [B, H, Dh] (pre-scaled), kv [B, H, 2*Dh, T], out [B, H, Dh]; all contiguous,
// fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). Keys 0..pos are live.
extern "C" int mmt_decode_attention(const void* q, const void* kv, void* out, int B, int H,
                                    int T_len, int Dh, int pos, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || pos < 0 || pos >= T_len) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(q, kv, out, B * H, T_len, Dh, pos, s)
                                  : launch<float>(q, kv, out, B * H, T_len, Dh, pos, s);
  return (int)err;
}
