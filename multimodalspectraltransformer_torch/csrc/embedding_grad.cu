// The gradient of an embedding lookup, summed in a fixed order (kernel E1).
//
// Replaces no Pallas kernel: it is the backward of the lookup tables that are
// trained (the MMT's MF, MS, target-token and target-position tables, the
// CLIP text tower's word and position tables, the Q-Former's word table),
// which the JAX package leaves to XLA's scatter-add. PyTorch's own CUDA
// backward of a lookup sums a table row's contributions in an order that can
// change from run to run, so two runs of the same training steps could end a
// float rounding apart. This kernel computes
//     out[v, :] = sum of grad[i, :] over the rows i with ids[i] == v
// with every sum taken in one order fixed by the data alone.
//
// The wrapper (ops/embedding_grad.py) sorts the flat ids with a stable sort,
// so that `order` lists the rows of each id in increasing row index. Then:
//   - one block per (table row v, 32 columns); the block finds v's run
//     [lo, hi) in the sorted ids by two binary searches;
//   - thread (x, y) of the 32 x 8 block takes column x and the rows
//     lo + y, lo + y + 8, ... of the run, in that order, and sums them in
//     float32 with Neumaier's compensation (a running sum and the running
//     sum of what its roundings lost); the 8 threads' sums and compensations
//     of a column are then added, compensated, in the order y = 0..7 by
//     thread (x, 0). Which thread adds which row, and in what order, depends
//     only on the ids, never on the scheduling;
//   - float32 and bfloat16 gradients alike are summed so, and the sum is
//     rounded once to the output's type (the gradient's); a float64
//     gradient (the tensor-parallel check's float64 step) is summed in
//     float64. A row no id reaches is 0. The compensation keeps a run of
//     thousands of rows (a padding id) within about one float32 rounding of
//     the exact sum, where a plain float32 sum drifts by 1e-6 of the row's
//     largest element.
//
// What bounds it on the H100: device memory. Each gradient row is read once
// and each table row written once; there is one add per element read. Reads
// of a warp are 32 consecutive columns of one row (128 bytes in float32).
// A first, simple version: a long run (a padding id) is summed by 8 threads
// a column, so its time grows with the run's length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the sum's type: float32 for float32 and bfloat16 gradients, float64 for float64
template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(double* p, double x) { *p = x; }
__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ double mag(double x) { return fabs(x); }

constexpr int kCols = 32;  // columns of a block (one warp wide)
constexpr int kRows = 8;   // threads that share one column's run

// Neumaier's compensated addition of x into (sum, comp): comp gathers the
// low-order bits each rounding of sum loses; the value is sum + comp
template <typename A>
__device__ __forceinline__ void add(A& sum, A& comp, A x) {
  const A t = sum + x;
  comp += mag(sum) >= mag(x) ? (sum - t) + x : (x - t) + sum;
  sum = t;
}

// first k in [0, n) with sorted[k] >= v (n when there is none)
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ sorted, int64_t n,
                                               int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (sorted[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kCols * kRows)
embedding_grad_kernel(const T* __restrict__ grad, const int64_t* __restrict__ sorted_ids,
                      const int64_t* __restrict__ order, T* __restrict__ out, int64_t n,
                      int dim) {
  using A = typename Acc<T>::type;
  __shared__ int64_t run[2];
  __shared__ A part[kRows][kCols], lost[kRows][kCols];
  const int64_t v = blockIdx.x;
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (threadIdx.y == 0 && threadIdx.x < 2)
    run[threadIdx.x] = lower_bound(sorted_ids, n, v + threadIdx.x);
  __syncthreads();
  const int64_t lo = run[0], hi = run[1];

  A sum = 0, comp = 0;
  if (c < dim) {
#pragma unroll 4
    for (int64_t k = lo + threadIdx.y; k < hi; k += kRows)
      add<A>(sum, comp, to_acc(grad[order[k] * dim + c]));
  }
  part[threadIdx.y][threadIdx.x] = sum;
  lost[threadIdx.y][threadIdx.x] = comp;
  __syncthreads();
  if (threadIdx.y == 0 && c < dim) {
    A s = 0, e = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      add<A>(s, e, part[r][threadIdx.x]);
      add<A>(s, e, lost[r][threadIdx.x]);
    }
    store(out + v * dim + c, s + e);
  }
}

template <typename T>
cudaError_t launch(const void* grad, const void* sorted_ids, const void* order, void* out,
                   int64_t n, int num_weights, int dim, cudaStream_t s) {
  const dim3 grid(num_weights, (dim + kCols - 1) / kCols);
  const dim3 block(kCols, kRows);
  embedding_grad_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(grad), static_cast<const int64_t*>(sorted_ids),
      static_cast<const int64_t*>(order), static_cast<T*>(out), n, dim);
  return cudaGetLastError();
}

}  // namespace

// grad [n, dim] (dtype 0 float32, 1 bfloat16, 2 float64), sorted_ids [n] and
// order [n] int64 (the stable sort of the flat ids and its permutation), out
// [num_weights, dim] in grad's type.
extern "C" int mmt_embedding_grad(const void* grad, const void* sorted_ids, const void* order,
                                  void* out, long long n, int num_weights, int dim, int dtype,
                                  void* stream) {
  if (n < 0 || num_weights <= 0 || dim <= 0 || (dim + kCols - 1) / kCols > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(grad, sorted_ids, order, out, n, num_weights, dim, s);
    case 1:
      return (int)launch<__nv_bfloat16>(grad, sorted_ids, order, out, n, num_weights, dim, s);
    case 2: return (int)launch<double>(grad, sorted_ids, order, out, n, num_weights, dim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
