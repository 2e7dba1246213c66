// Ancestry-masked self-attention for one beam-search decode step (kernel K3).
//
// Replaces the Pallas TPU kernel multimodalspectraltransformer_tpu/ops/
// beam_attention.py::_kernel (pallas_call in beam_attention): for every batch
// element b, head h and beam query k,
//     out[b, h, k] = softmax_m(q[b, h, k] . K[b, h, :, m] + bias[b, k, m]) . V[b, h, :, m]
// over the cache columns m. The beam cache is append-only: column t*K + l
// holds what lane l wrote at step t, and the additive bias (0 or -inf) keeps,
// for each past step, the one lane that held beam k's ancestor then. The cache
// keeps the merged layout [B, H, 2*Dh, M] (K in rows 0:Dh, V in Dh:2*Dh).
//
// What bounds it on the H100: device memory. Per (b, h) the live cache is
// 2*Dh*n_live values, and each column costs about 4*Dh flops per query: at
// Dh = 8 and K = 5 beams that is about one flop per byte, far below the
// ~20 flop/byte where the f32 units would be the limit. So the design reads
// each live cache value exactly once and keeps everything else on chip:
//   - one block per batch element b (and group of heads), one warp per head;
//     lane l takes columns m = l, l+32, ... < n_live, so the loads of each of
//     the 2*Dh cache rows are consecutive addresses (M is the minor axis) and
//     coalesce; columns at or past n_live (later steps) are never read;
//   - the bias rows [K, n_live] are shared by all heads of b: the block stages
//     them in shared memory a tile of columns at a time, so device memory
//     sees the bias once per block and not once per head; the block's queries
//     [heads, K, Dh] sit in shared memory too (every lane of a warp reads the
//     same address, a broadcast);
//   - each lane keeps K online softmaxes (running max, running sum, Dh-wide
//     accumulator) in registers, merged across the warp with shuffles, so the
//     [K, n_live] scores never leave registers;
//   - f32 math for fp32 and bf16 storage alike, one rounding at the output.
//     The Pallas kernel rounds the probabilities to the cache's type before
//     the P.V product; an online softmax cannot, so at bf16 the two differ by
//     about one bf16 rounding (the plain PyTorch version follows Pallas).
// A row whose bias is -inf everywhere gives NaN here, as in the JAX function;
// it does not occur on the beam path, where column (t = 0, lane k) is always
// beam k's own.
// A first, simple version: no tensor cores (Dh = 8 is far below an MMA tile),
// no TMA, and every live column is read, including the lanes that are no
// beam's ancestor (an ancestry-indexed gather would read 1/K of the bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int kDh = 8;      // the model's head size (d_model 128 / 16 heads)
constexpr int kTile = 256;  // cache columns whose bias a block stages at once
constexpr int kMaxBeams = 16;

// KMAX is the number of softmaxes each lane keeps (K <= KMAX runs K of them):
// 8 for up to 8 beams, with 16 heads a block (512 threads, <= 128 registers
// each), 16 above that, with 8 heads a block so the 16 accumulators fit.
template <int KMAX>
struct Shape {
  static constexpr int kHeads = KMAX <= 8 ? 16 : 8;
  static constexpr int kThreads = kHeads * 32;
};

template <typename T, int KMAX>
__global__ void __launch_bounds__(Shape<KMAX>::kThreads)
beam_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                      const T* __restrict__ bias, T* __restrict__ out, int H, int K, int M,
                      int n_live) {
  constexpr int kHeads = Shape<KMAX>::kHeads;
  __shared__ float qs[kHeads * KMAX * kDh];
  __shared__ float bs[KMAX][kTile];

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int heads = min(kHeads, H - h0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = h0 + warp;

  const T* qb = q + ((size_t)b * H + h0) * K * kDh;
  for (int i = threadIdx.x; i < heads * K * kDh; i += blockDim.x) qs[i] = to_f(qb[i]);
  const float* qh = qs + warp * K * kDh;
  const T* kp = kv + ((size_t)b * H + h) * 2 * kDh * M;
  const T* vp = kp + (size_t)kDh * M;
  const T* bb = bias + (size_t)b * K * M;

  float m[KMAX], l[KMAX], acc[KMAX][kDh];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    m[k] = -INFINITY;
    l[k] = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; ++d) acc[k][d] = 0.f;
  }

  for (int base = 0; base < n_live; base += kTile) {
    const int width = min(kTile, n_live - base);
    __syncthreads();  // the queries are staged and the previous tile is consumed
    for (int i = threadIdx.x; i < K * kTile; i += blockDim.x) {
      const int k = i / kTile, c = i % kTile;
      bs[k][c] = c < width ? to_f(bb[(size_t)k * M + base + c]) : -INFINITY;
    }
    __syncthreads();
    if (warp >= heads) continue;
    for (int c = lane; c < width; c += 32) {
      const int col = base + c;
      float kc[kDh], vc[kDh];
#pragma unroll
      for (int d = 0; d < kDh; ++d) {
        kc[d] = to_f(kp[(size_t)d * M + col]);
        vc[d] = to_f(vp[(size_t)d * M + col]);
      }
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k >= K) break;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kDh; ++d) s += qh[k * kDh + d] * kc[d];
        s += bs[k][c];
        if (s > -INFINITY) {  // a masked column leaves the softmax unchanged
          const float m_new = fmaxf(m[k], s);
          const float corr = expf(m[k] - m_new);  // 0 on the first live column
          const float p = expf(s - m_new);
          l[k] = l[k] * corr + p;
#pragma unroll
          for (int d = 0; d < kDh; ++d) acc[k][d] = acc[k][d] * corr + p * vc[d];
          m[k] = m_new;
        }
      }
    }
  }
  if (warp >= heads) return;

  // merge the 32 partial softmaxes of each query
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    float mx = m[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float corr = (m[k] == -INFINITY) ? 0.f : expf(m[k] - mx);
    float lk = l[k] * corr;
    float a[kDh];
#pragma unroll
    for (int d = 0; d < kDh; ++d) a[d] = acc[k][d] * corr;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lk += __shfl_xor_sync(0xffffffffu, lk, off);
#pragma unroll
      for (int d = 0; d < kDh; ++d) a[d] += __shfl_xor_sync(0xffffffffu, a[d], off);
    }
    if (lane == 0) {
      const float inv = 1.f / lk;
      T* op = out + (((size_t)b * H + h) * K + k) * kDh;
#pragma unroll
      for (int d = 0; d < kDh; ++d) store(op + d, a[d] * inv);
    }
  }
}

template <typename T, int KMAX>
cudaError_t launch_k(const void* q, const void* kv, const void* bias, void* out, int B, int H,
                     int K, int M, int n_live, cudaStream_t stream) {
  constexpr int kHeads = Shape<KMAX>::kHeads;
  const dim3 grid(B, (H + kHeads - 1) / kHeads), block(Shape<KMAX>::kThreads);
  beam_attention_kernel<T, KMAX><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const T*>(bias),
      static_cast<T*>(out), H, K, M, n_live);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kv, const void* bias, void* out, int B, int H,
                   int K, int M, int n_live, cudaStream_t stream) {
  if (K <= 8) return launch_k<T, 8>(q, kv, bias, out, B, H, K, M, n_live, stream);
  return launch_k<T, kMaxBeams>(q, kv, bias, out, B, H, K, M, n_live, stream);
}

}  // namespace

// q [B, H, K, Dh] (pre-scaled), kv [B, H, 2*Dh, M], bias [B, K, M] (additive,
// the cache's type), out [B, H, K, Dh]; all contiguous, fp32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1). Columns 0..n_live-1 are read; the bias is taken to be
// -inf beyond them.
extern "C" int mmt_beam_attention(const void* q, const void* kv, const void* bias, void* out,
                                  int B, int H, int K, int M, int Dh, int n_live, int is_bf16,
                                  void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || K > kMaxBeams || Dh != kDh || n_live <= 0 || n_live > M)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, kv, bias, out, B, H, K, M, n_live, s)
              : launch<float>(q, kv, bias, out, B, H, K, M, n_live, s);
  return (int)err;
}
