// Batched eps-scaled forward auction: total optimal-assignment cost (kernel K2).
//
// Replaces the Pallas TPU kernel multimodalspectraltransformer_tpu/ops/
// auction.py:30 (_auction_kernel, pallas_call in auction_assignment_cost_pallas):
// cost [B, N, N] f32 -> total [B] f32. Per problem: benefit = -cost; eps0 =
// max(max - min, eps_final) / 2, divided by scale_factor after each of
// n_phases phases (never below eps_final); each phase resets ownership, keeps
// prices and runs at most iters_per_phase bid/assign rounds (the wrapper's
// default is 64N where Pallas has 8N, see ops/auction.py), stopping once
// every object is owned. In a round (Jacobi) each bidder that owns nothing
// bids top1 - top2 + eps on its best object (lowest index on ties) and each
// object goes to its highest bid (lowest bidder index on ties). Unowned
// objects fall back to the diagonal. A converged result is within
// N * (last phase's eps) of the optimum.
//
// What bounds it on the H100: a latency chain. Device memory sees N*N*4
// bytes in and 4 bytes out per problem, and the arithmetic is ~7N^2 flops a
// round; the time goes to the rounds, each of which depends on the last. So
// the lever is the latency of one round, and the design cuts its barriers
// and serial scans:
//   - N <= 32 (the harness's HSQC and COSY problems): one warp per problem,
//     several problems per block and no block barrier at all. Lane i (i < N)
//     is object i, and bidder i is shared by the 32/NP lanes i, i + NP, ...
//     (NP: N rounded up to 8, 16 or 32), each holding NP^2/32 entries of its
//     cost row in registers: prices come by __shfl_sync, top1, its index and
//     top2 by a register tree, then by shuffles across the bidder's lanes.
//     Which bidders own an object is one __reduce_or_sync of owner bits,
//     convergence one __any_sync.
//   - The object side needs no scan over bidders: each bidder does a
//     shared-memory atomicMax of its bid's order-preserving bits into its
//     object's slot, then, if its bid is the maximum, an atomicMin of its
//     index. Max and min are order-free, so the result is deterministic and
//     the highest bid wins with ties to the lowest bidder, as in the plain
//     version: the same assignment and the same rounds per problem.
//   - N > 32: one block per problem, one thread per bidder and per object
//     (strided above 1024), two barriers a round (a __syncthreads_or that is
//     also the convergence test, and one between bids and assignment); the
//     objects resolve by one atomicMax of a 64-bit key (bid bits, then
//     ~bidder index), which needs no barrier between two atomics; each bidder's owned object is tracked in
//     shared memory, so ownership needs no sweep. The cost sits in shared
//     memory, transposed so a warp's sweep hits 32 banks, while it fits
//     (N <= 238, 227 KB); above that it is read from device memory, where it
//     stays L2-resident, so any N up to 11,596 runs (the bookkeeping arrays
//     fill shared memory there).
//   - The total is summed in double, so it does not depend on the order.
// Tensor cores and TMA do not serve: a round is a max-reduction with
// data-dependent control, not a product, and the cost is read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.0e38f;  // "no bid" / minus infinity; finite, as in the plain version
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
// a block's shared memory on the H100 (227 KB), less the block kernel's 512 static bytes
constexpr int kMaxDynSmem = 232448 - 512;

// Float bits whose unsigned order is the float order; 0 for no finite float.
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
// 64-bit key: larger key = higher bid, then lower bidder index; 0 = no bid.
__device__ __forceinline__ unsigned long long bid_key(float bid, int bidder) {
  return ((unsigned long long)ordered(bid) << 32) | (unsigned)(~bidder);
}
__device__ __forceinline__ float key_bid(unsigned long long key) {
  return from_ordered((unsigned)(key >> 32));
}
__device__ __forceinline__ int key_bidder(unsigned long long key) {
  return (int)(~(unsigned)key);
}

// A bidder's best value t1, its first index idx and the best value at
// another index t2 (kNeg when there is none), over a range of objects.
struct Top2 {
  float t1, t2;
  int idx;
};
// a covers lower object indices than b; ties keep a's index, as a scan in
// index order does
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool gt = b.t1 > a.t1;
  return Top2{gt ? b.t1 : a.t1, gt ? fmaxf(a.t1, b.t2) : fmaxf(a.t2, b.t1), gt ? b.idx : a.idx};
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// ---------------------------------------------------------------- N <= 32

// NP (8, 16 or 32) is N rounded up to a power of two: lane `lane % NP` is
// bidder i, and the 32 / NP lanes of a bidder each hold NP^2 / 32 of its
// row, so a round's sweep is spread over the whole warp.
template <int NP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
auction_warp_kernel(const float* __restrict__ cost, float* __restrict__ total,
                    int* __restrict__ rounds, int B, int N, int n_phases, int iters_per_phase,
                    float eps_final, float scale_factor) {
  constexpr int kSeg = NP * NP / 32;  // objects a lane sweeps
  __shared__ unsigned slot_bid[kWarpsPerBlock][32], slot_bidder[kWarpsPerBlock][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int prob = blockIdx.x * kWarpsPerBlock + warp;
  if (prob >= B) return;  // the whole warp: no block barrier below
  unsigned* sbid = slot_bid[warp];
  unsigned* sbidder = slot_bidder[warp];
  const float* c = cost + (size_t)prob * N * N;
  const int i = lane % NP, j0 = (lane / NP) * kSeg;  // bidder, first object of the segment
  const bool obj = lane < N;                         // lane `lane` is also object `lane`

  float seg[kSeg];  // cost[i][j0 + t]
  float cmax = kNeg, cmin = -kNeg;
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    const bool in = i < N && j0 + t < N;
    seg[t] = in ? c[i * N + j0 + t] : 0.f;
    cmax = in ? fmaxf(cmax, seg[t]) : cmax;
    cmin = in ? fminf(cmin, seg[t]) : cmin;
  }
  for (int off = 16; off > 0; off >>= 1) {
    cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, off));
    cmin = fminf(cmin, __shfl_xor_sync(kFull, cmin, off));
  }
  float eps_cur = fmaxf(cmax - cmin, eps_final) * 0.5f;
  float price = 0.f;  // object lane's price
  int owner = -1;     // object lane's owner
  int n_rounds = 0;

  for (int phase = 0; phase < n_phases; ++phase) {
    const float eps = fmaxf(eps_final, eps_cur);
    owner = -1;
    for (int it = 0; it < iters_per_phase; ++it) {
      if (!__any_sync(kFull, obj && owner < 0)) break;
      ++n_rounds;
      const unsigned owned = __reduce_or_sync(kFull, (obj && owner >= 0) ? (1u << owner) : 0u);
      // this lane's segment: values, then top1, its first index and top2 by a tree
      Top2 t[kSeg];
#pragma unroll
      for (int x = 0; x < kSeg; ++x) {
        const float p = __shfl_sync(kFull, price, j0 + x);
        t[x] = Top2{j0 + x < N ? -seg[x] - p : -INFINITY, kNeg, j0 + x};
      }
#pragma unroll
      for (int w = 1; w < kSeg; w *= 2) {
#pragma unroll
        for (int x = 0; x < kSeg; x += 2 * w) t[x] = merge(t[x], t[x + w]);
      }
      // then across the bidder's lanes, lower objects on the left
      Top2 best = t[0];
#pragma unroll
      for (int off = NP; off < 32; off *= 2) {
        const Top2 o{__shfl_xor_sync(kFull, best.t1, off), __shfl_xor_sync(kFull, best.t2, off),
                     __shfl_xor_sync(kFull, best.idx, off)};
        best = (lane & off) ? merge(o, best) : merge(best, o);
      }
      // the object side: the highest bid, then the lowest bidder
      sbid[lane] = 0u;
      sbidder[lane] = 32u;
      __syncwarp();
      const bool bids = lane < N && !((owned >> lane) & 1u);  // lane < N <= NP: lane is bidder i
      const unsigned ob = ordered(best.t1 - best.t2 + eps);
      if (bids) atomicMax(&sbid[best.idx], ob);
      __syncwarp();
      if (bids && sbid[best.idx] == ob) atomicMin(&sbidder[best.idx], (unsigned)lane);
      __syncwarp();
      if (obj && sbid[lane]) {
        price = price + from_ordered(sbid[lane]);
        owner = (int)sbidder[lane];
      }
    }
    eps_cur = eps / scale_factor;
  }
  double sum = obj ? (double)c[(owner >= 0 ? owner : lane) * N + lane] : 0.0;
  sum = warp_sum(sum);
  if (lane == 0) {
    total[prob] = (float)sum;
    if (rounds) rounds[prob] = n_rounds;
  }
}

// ---------------------------------------------------------------- N > 32

template <bool kSharedCost>
__global__ void __launch_bounds__(1024)
auction_block_kernel(const float* __restrict__ cost, float* __restrict__ total,
                     int* __restrict__ rounds, int N, int n_phases, int iters_per_phase,
                     float eps_final, float scale_factor) {
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* slot = smem_u64;                   // [N] best key per object
  float* price = reinterpret_cast<float*>(slot + N);     // [N]
  int* owner = reinterpret_cast<int*>(price + N);        // [N] owner of object j, -1: none
  int* assign = owner + N;                               // [N] object of bidder i, -1: none
  float* cT = reinterpret_cast<float*>(assign + N);      // [N*N] cT[j*N + i] = cost[i][j]
  __shared__ float red_max[32], red_min[32];
  __shared__ double red_sum[32];

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const float* c = cost + (size_t)blockIdx.x * N * N;

  float lmax = kNeg, lmin = -kNeg;
  for (int k = tid; k < N * N; k += nt) {
    const float v = c[k];
    if (kSharedCost) {
      const int i = k / N, j = k - i * N;
      cT[j * N + i] = v;
    }
    lmax = fmaxf(lmax, v);
    lmin = fminf(lmin, v);
  }
  for (int r = tid; r < N; r += nt) {
    price[r] = 0.f;
    slot[r] = 0ull;
  }
  for (int off = 16; off > 0; off >>= 1) {
    lmax = fmaxf(lmax, __shfl_xor_sync(kFull, lmax, off));
    lmin = fminf(lmin, __shfl_xor_sync(kFull, lmin, off));
  }
  if (lane == 0) {
    red_max[warp] = lmax;
    red_min[warp] = lmin;
  }
  __syncthreads();
  float cmax = red_max[0], cmin = red_min[0];
  for (int w = 1; w < nt >> 5; ++w) {
    cmax = fmaxf(cmax, red_max[w]);
    cmin = fminf(cmin, red_min[w]);
  }
  float eps_cur = fmaxf(cmax - cmin, eps_final) * 0.5f;
  int n_rounds = 0;

  for (int phase = 0; phase < n_phases; ++phase) {
    const float eps = fmaxf(eps_final, eps_cur);
    for (int r = tid; r < N; r += nt) {
      owner[r] = -1;
      assign[r] = -1;
    }
    for (int it = 0;; ++it) {
      int open = 0;  // this thread's objects: owner[r] is written by this thread only
      for (int r = tid; r < N; r += nt) open |= owner[r] < 0;
      if (!__syncthreads_or(open) || it >= iters_per_phase) break;
      ++n_rounds;
      // bidders
      for (int i = tid; i < N; i += nt) {
        if (assign[i] >= 0) continue;
        float top1 = kNeg, top2 = kNeg;
        int best = 0;
        for (int j = 0; j < N; ++j) {
          const float cij = kSharedCost ? cT[j * N + i] : __ldg(c + (size_t)i * N + j);
          const float v = -cij - price[j];
          if (j == 0) {
            top1 = v;
          } else if (v > top1) {
            top2 = top1;
            top1 = v;
            best = j;
          } else {
            top2 = fmaxf(top2, v);
          }
        }
        atomicMax(&slot[best], bid_key(top1 - top2 + eps, i));
      }
      __syncthreads();
      // objects: a winner owned nothing and a displaced owner bid nowhere,
      // so no two threads write the same assign[] entry
      for (int j = tid; j < N; j += nt) {
        const unsigned long long key = slot[j];
        if (key) {
          const int w = key_bidder(key), prev = owner[j];
          if (prev >= 0) assign[prev] = -1;
          assign[w] = j;
          owner[j] = w;
          price[j] = price[j] + key_bid(key);
          slot[j] = 0ull;
        }
      }
    }
    eps_cur = eps / scale_factor;
  }
  double sum = 0.0;
  for (int j = tid; j < N; j += nt) {
    const int i = owner[j] >= 0 ? owner[j] : j;
    sum += kSharedCost ? (double)cT[j * N + i] : (double)c[(size_t)i * N + j];
  }
  sum = warp_sum(sum);
  if (lane == 0) red_sum[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < nt >> 5; ++w) s += red_sum[w];
    total[blockIdx.x] = (float)s;
    if (rounds) rounds[blockIdx.x] = n_rounds;
  }
}

size_t block_smem(int N, bool shared_cost) {
  return (size_t)N * (8 + 4 + 4 + 4) + (shared_cost ? (size_t)N * N * 4 : 0);
}

template <bool kSharedCost>
cudaError_t launch_block(const float* cost, float* total, int* rounds, int B, int N, int n_phases,
                         int iters_per_phase, float eps_final, float scale_factor,
                         cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;  // dynamic shared memory above 48 KB needs the attribute
  const size_t smem = block_smem(N, kSharedCost);
  if (smem > (size_t)kMaxDynSmem) return cudaErrorInvalidValue;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_block_kernel<kSharedCost>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int threads = N >= 1024 ? 1024 : ((N + 31) / 32) * 32;
  auction_block_kernel<kSharedCost><<<B, threads, smem, stream>>>(
      cost, total, rounds, N, n_phases, iters_per_phase, eps_final, scale_factor);
  return cudaGetLastError();
}

}  // namespace

// cost [B, N, N] f32 contiguous -> total [B] f32, and the rounds each problem
// ran into rounds [B] int32 unless it is null. variant: 0 = one warp per
// problem (N <= 32), 1 = one block per problem with the cost in shared
// memory, 2 = one block per problem with the cost in device memory; the
// wrapper chooses it (ops/auction.py::auction_variant).
extern "C" int mmt_auction(const void* cost, void* total, void* rounds, int B, int N,
                           int n_phases, int iters_per_phase, float eps_final, float scale_factor,
                           int variant, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cost);
  float* t = static_cast<float*>(total);
  int* r = static_cast<int*>(rounds);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    if (N > 32) return (int)cudaErrorInvalidValue;
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (N <= 8)
      auction_warp_kernel<8><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
          c, t, r, B, N, n_phases, iters_per_phase, eps_final, scale_factor);
    else if (N <= 16)
      auction_warp_kernel<16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
          c, t, r, B, N, n_phases, iters_per_phase, eps_final, scale_factor);
    else
      auction_warp_kernel<32><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
          c, t, r, B, N, n_phases, iters_per_phase, eps_final, scale_factor);
    return (int)cudaGetLastError();
  }
  if (variant == 1)
    return (int)launch_block<true>(c, t, r, B, N, n_phases, iters_per_phase, eps_final,
                                   scale_factor, s);
  if (variant == 2)
    return (int)launch_block<false>(c, t, r, B, N, n_phases, iters_per_phase, eps_final,
                                    scale_factor, s);
  return (int)cudaErrorInvalidValue;
}
