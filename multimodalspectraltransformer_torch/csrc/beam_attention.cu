// Ancestry-masked self-attention for one beam-search decode step (kernel K3).
//
// Replaces the Pallas TPU kernel multimodalspectraltransformer_tpu/ops/
// beam_attention.py:34 (_kernel, pallas_call in beam_attention): for every
// batch element b, head h and beam query k,
//     out[b, h, k] = softmax_m(q[b, h, k] . K[b, h, :, m] + bias[b, k, m]) . V[b, h, :, m]
// over the cache columns m < n_live. The beam cache is append-only: column
// t*K + l holds what lane l wrote at step t, and the additive bias (0 or -inf
// on the beam path; any value works) keeps, for each past step, the one lane
// that held beam k's ancestor then. The cache keeps the merged layout
// [B, H, 2*Dh, M] (K in rows 0:Dh, V in Dh:2*Dh), M minor.
//
// What bounds it on the H100: bytes, at sector granularity. Per (b, h) the
// live cache is 2*Dh*n_live values and each kept (column, beam) costs about
// 4*Dh flops, about one flop per byte. Each beam needs only its ancestors'
// columns, and the K beams of b together need their union, but with M minor
// a 32-byte sector holds 16 bf16 (8 f32) consecutive columns, about three
// steps of K = 5 lanes, and every step has a needed column: every sector of
// the live range is fetched whatever a kernel skips. So the reachable aim on
// this layout is the bound of all live columns.
// The design keeps many bytes in flight and does no needless arithmetic:
//   - one block per (b, h, group of at most 16 beams), one warp per beam of
//     the group: 2048 blocks of 5 warps at beam mode's shape. A warp needs
//     only its beam's online softmax (max, sum, 8-wide accumulator) and its
//     query in registers, about 40 in all, so many blocks are resident per
//     SM and their copies overlap each other's arithmetic and merges;
//   - the block copies each tile of 512 bytes of each of the 2*Dh cache rows
//     (256 bf16 or 128 f32 columns at Dh = 8), with the group's bias rows,
//     into shared memory with cp.async (16-byte copies; every row is
//     contiguous, and M*elt must be a multiple of 16, else plain loads), two
//     stages: the next tile is in flight while this one is computed, and the
//     copies hold no registers;
//   - the bias first: a warp scans its beam's bias row 32 columns at a time
//     and queues (ballot, popc) the columns where it is finite, on the beam
//     path one of K per step; it computes the score and the online-softmax
//     update (base-2 exponentials) only for queued columns, a full warp of
//     them at a time, so its lanes stay busy however few columns it keeps;
//   - G = Dh/8 lanes share a column, each holding 8 of its dims, so the
//     per-lane state is the same at every head size; scores are summed over
//     the G lanes by shuffles;
//   - each warp merges its lanes' partial softmaxes by shuffles and writes its
//     beam's output: no merge across warps. f32 math, one rounding at the
//     output. The Pallas kernel rounds the probabilities to the cache's type
//     before the P.V product; an online softmax cannot, so at bf16 the two
//     differ by about one bf16 rounding (the plain PyTorch version follows
//     Pallas);
//   - more than 16 beams run as several groups over a grid dimension; each
//     group reads the cache again, which is correct (off the measured path).
// What limits it now is shared memory, not device memory: a warp gathers
// its beam's kept columns, which lie about K apart, so the 32 columns of a
// pass span about 2.5 banks each (bf16) and every row read is a 2-3 way bank
// conflict; the K warps of a block together read each tile about K times.
// A layout that holds a column's 2*Dh values together would cut that.
// Tensor cores do not serve: the work is about one flop per byte, and Dh = 8
// is a single k-step of mma.m16n8k8. TMA would do the copies cp.async does
// with fewer instructions; at a few KB a tile the copy instructions are not
// the limit, so the simpler cp.async is used.
// A row whose bias is -inf everywhere gives NaN, as in the JAX function; it
// does not occur on the beam path, where column (t = 0, lane k) is beam k's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGroup = 16;  // beams per group: one warp each
constexpr int kDims = 8;       // dims of a column each lane holds

template <typename T, int DH>
struct Geo {
  static constexpr int G = DH / kDims;                      // lanes per column
  static constexpr int kTile = 512 / (DH / 8) / sizeof(T);  // columns per stage: 512 B a row at Dh 8
  static constexpr int kStride = kTile + 16 / sizeof(T);    // 16 bytes of padding keep rows aligned
  static constexpr int kSlots = 32 / G;                     // columns a warp covers at once
  __host__ __device__ static size_t stage_elems(int group) { return (size_t)(2 * DH + group) * kStride; }
  __host__ __device__ static size_t smem(int group) { return 2 * stage_elems(group) * sizeof(T); }
};

// Copy columns [base, base + width) of the 2*DH cache rows and the kc bias
// rows into the stage `st` (row r at st + r * kStride), as one cp.async group.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* st, const T* kvp, const T* bp, int M, int base,
                                          int width, int kc, bool vec) {
  using S = Geo<T, DH>;
  const int rows = 2 * DH + kc;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = (width + E - 1) / E;  // 16-byte chunks per row; the last may pass n_live, not M
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * E;
      const T* src = r < 2 * DH ? kvp + (size_t)r * M : bp + (size_t)(r - 2 * DH) * M;
      cp_async16(st + r * S::kStride + c, src + base + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width, c = i - r * width;
      const T* src = r < 2 * DH ? kvp + (size_t)r * M : bp + (size_t)(r - 2 * DH) * M;
      st[r * S::kStride + c] = src[base + c];
    }
  }
  cp_async_commit();
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMaxGroup * 32)
beam_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                      const T* __restrict__ bias, T* __restrict__ out, int H, int K, int M,
                      int n_live, int group, bool vec) {
  using S = Geo<T, DH>;
  constexpr int G = S::G;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  __shared__ int queues[kMaxGroup][2 * S::kSlots];  // each warp's kept columns, not yet computed

  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * group, kc = min(group, K - k0);
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;  // this warp's beam in the group
  const int slot = lane / G, g = lane % G;
  const unsigned gmask = ((1u << G) - 1u) << (lane & ~(G - 1));
  const bool beam = k < kc;  // the last group may have fewer beams than warps
  const size_t stage_elems = S::stage_elems(kc);
  int* queue = queues[k];

  const T* kvp = kv + (size_t)bh * 2 * DH * M;
  const T* bp = bias + ((size_t)b * K + k0) * M;
  float qr[kDims];  // the query, scaled so that scores are in base 2
#pragma unroll
  for (int i = 0; i < kDims; ++i)
    qr[i] = beam ? to_f(q[((size_t)bh * K + k0 + k) * DH + g + G * i]) * kLog2e : 0.f;

  float m = -INFINITY, l = 0.f, acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  const int n_tiles = (n_live + S::kTile - 1) / S::kTile;
  load_tile<T, DH>(stage, kvp, bp, M, 0, min(S::kTile, n_live), kc, vec);
  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * S::kTile, width = min(S::kTile, n_live - base);
    if (t + 1 < n_tiles) {
      load_tile<T, DH>(stage + ((t + 1) & 1) * stage_elems, kvp, bp, M, base + S::kTile,
                       min(S::kTile, n_live - base - S::kTile), kc, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile is in shared memory
    const T* st = stage + (t & 1) * stage_elems;
    const T* sb = st + (2 * DH + k) * S::kStride;  // this beam's bias row
    // score and update for column c of the tile (all G lanes of a column)
    auto update = [&](int c) {
      float s = 0.f, vcol[kDims];
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        s += qr[i] * to_f(st[(g + G * i) * S::kStride + c]);
        vcol[i] = to_f(st[(DH + g + G * i) * S::kStride + c]);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(gmask, s, off);
      s += to_f(sb[c]) * kLog2e;
      const float m_new = fmaxf(m, s);
      const float corr = exp2f(m - m_new);  // 0 on the lane's first kept column
      const float p = exp2f(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] = acc[i] * corr + p * vcol[i];
      m = m_new;
    };
    if (beam) {
      // The bias first: the columns whose bias is finite for this beam go to
      // the warp's queue, and the warp computes them kSlots at a time, so
      // its lanes stay busy however few columns the beam keeps.
      int pending = 0;
      for (int cb = 0; cb < width; cb += S::kSlots) {
        const int c = cb + slot;
        const bool keep = c < width && to_f(sb[c]) > -INFINITY;
        const unsigned vote = __ballot_sync(kFull, keep);  // a column's G lanes vote alike
        if (keep && g == 0) queue[pending + __popc(vote & ((1u << lane) - 1u)) / G] = c;
        pending += __popc(vote) / G;
        if (pending >= S::kSlots) {
          __syncwarp();
          update(queue[slot]);
          const int rest = pending - S::kSlots;
          const int moved = slot < rest ? queue[S::kSlots + slot] : 0;
          __syncwarp();
          if (g == 0 && slot < rest) queue[slot] = moved;
          __syncwarp();
          pending = rest;
        }
      }
      __syncwarp();
      if (slot < pending) update(queue[slot]);  // uniform over the column's G lanes
      __syncwarp();
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // merge the partial softmaxes of the lanes that hold the same dims
  float mx = m;
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  const float corr = m == -INFINITY ? 0.f : exp2f(m - mx);
  l *= corr;
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] *= corr;
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) {
    l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
  }
  if (beam && lane < G) {
    const float inv = 1.f / l;
    T* op = out + ((size_t)bh * K + k0 + k) * DH;
#pragma unroll
    for (int i = 0; i < kDims; ++i) store(op + g + G * i, acc[i] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* kv, const void* bias, void* out, int B, int H,
                      int K, int M, int n_live, int group, cudaStream_t stream) {
  using S = Geo<T, DH>;
  const bool vec = (M * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(kv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const dim3 grid(B * H, (K + group - 1) / group);
  beam_attention_kernel<T, DH><<<grid, group * 32, S::smem(group), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const T*>(bias),
      static_cast<T*>(out), H, K, M, n_live, group, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kv, const void* bias, void* out, int B, int H,
                   int K, int M, int Dh, int n_live, int group, cudaStream_t stream) {
  switch (Dh) {
    case 8: return launch_dh<T, 8>(q, kv, bias, out, B, H, K, M, n_live, group, stream);
    case 16: return launch_dh<T, 16>(q, kv, bias, out, B, H, K, M, n_live, group, stream);
    case 32: return launch_dh<T, 32>(q, kv, bias, out, B, H, K, M, n_live, group, stream);
    case 64: return launch_dh<T, 64>(q, kv, bias, out, B, H, K, M, n_live, group, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, K, Dh] (pre-scaled), kv [B, H, 2*Dh, M], bias [B, K, M] (additive,
// the cache's type), out [B, H, K, Dh]; all contiguous, fp32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1); Dh in {8, 16, 32, 64}. Columns 0..n_live-1 are read; the
// bias is taken to be -inf beyond them. Beams run in groups of `group` (at
// most 16; the wrapper chooses it, ops/beam_attention.py::beam_groups).
extern "C" int mmt_beam_attention(const void* q, const void* kv, const void* bias, void* out,
                                  int B, int H, int K, int M, int Dh, int n_live, int group,
                                  int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || group <= 0 || group > kMaxGroup || n_live <= 0 || n_live > M)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(q, kv, bias, out, B, H, K, M, Dh, n_live, group, s)
                       : launch<float>(q, kv, bias, out, B, H, K, M, Dh, n_live, group, s));
}
