// Fisher-vector product kernel (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this product in
// mjrl_tpu/algos/functional.py::make_hvp as a jvp of the KL's gradient and
// leaves it to XLA.  The port's first version was a retained double
// backward through autograd: the KL's first-order graph over every row kept
// for the whole CG solve, and each product some twenty launches streaming N
// x width float32 tensors through device memory.  This kernel computes the
// same product, F v = mean_i m_i J_i^T diag(coef) J_i v (the Gaussian's
// closed-form metric at equality; fvp_body.cuh), in one pass over the rows
// and one small reduction, in the working precision (no TF32).
//
// What bounds it on this card: operations.  A row costs about five
// matrix-vector products of the network's size (the forward, the two
// halves of the tangent forward, the backward and the outer products);
// the only bytes it must read are the observations (and the mask), under a
// millisecond at 16.4 M rows.  Nothing of size N touches device memory
// beyond them: the forward is recomputed from the observation, not cached.
//
// What the design does about it: a persistent grid of a few blocks per SM
// walks tiles of ROWS rows.  Each block keeps W, the tangent of W (the
// direction v) and its accumulators in shared memory; per tile, the
// forward, the tangent and the backward run layer by layer as small matrix
// products over the tile's rows, each thread on 4 rows x 4 outputs in
// registers from 128-bit loads, the activations and gradients in shared
// memory; then every thread sums the tile's outer products for its own
// 4 x 2 blocks of output entries.  The blocks' partials go to a scratch
// buffer that the reduce kernel sums in a fixed order: deterministic, no
// atomics.
//
// Built by mjrl_tpu_torch/ops/cuda_fvp.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -DFVP_T=float|double -DFVP_ROWS=R -DFVP_THREADS=N -DFVP_MIN_BLOCKS=B
// (no --use_fast_math) next to a generated fvp_model.cuh that defines struct
// FvpModel (depth, widths, nonlinearity), one library per shape, dtype and
// R; plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include "fvp_model.cuh"
#include "fvp_body.cuh"

#if !defined(FVP_ROWS) || !defined(FVP_THREADS) || !defined(FVP_MIN_BLOCKS)
#error "build with -DFVP_ROWS=R -DFVP_THREADS=N -DFVP_MIN_BLOCKS=B"
#endif

namespace {

using T = FVP_T;
constexpr int kRows = FVP_ROWS;
constexpr int kThreads = FVP_THREADS;
using Body = fvp::Body<T, FvpModel, kRows, kThreads>;
constexpr int kSmem = Body::SIZE * static_cast<int>(sizeof(T));
constexpr int kReduceBlock = 128;

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads, FVP_MIN_BLOCKS)
fvp_kernel(const T* __restrict__ obs, const T* __restrict__ mask,
           long long n, const T* __restrict__ theta, const T* __restrict__ v,
           const T* __restrict__ shift, const T* __restrict__ scale,
           const T* __restrict__ coef, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Body body{reinterpret_cast<T*>(smem_raw)};
  const int t = threadIdx.x;
  body.setup(theta, v, coef, shift, scale, t, kThreads);
  const long long tiles = (n + kRows - 1) / kRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    __syncthreads();  // the last tile's outer products are read
    body.load_tile(obs, mask, n, row0, t);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < Body::STEPS; ++st) {
      body.step(st, t);
      __syncthreads();
    }
    body.outer<0>(t, kThreads);
  }
  __syncthreads();
  body.store(partial + static_cast<long long>(blockIdx.x) * Body::NACC, t,
             kThreads);
}

extern "C" __global__ void __launch_bounds__(kReduceBlock)
fvp_reduce(const T* __restrict__ partial, int nblocks,
           const T* __restrict__ v, const T* __restrict__ cls,
           T* __restrict__ out) {
  const int p = blockIdx.x * kReduceBlock + threadIdx.x;
  if (p < FvpModel::P) {
    out[p] = fvp::reduce_entry<T, FvpModel>(p, partial, nblocks, v, cls);
  }
}

// Blocks of the persistent grid on the current device: resident blocks per
// SM times SMs.  Sets the kernel's dynamic shared memory first.  Returns a
// CUDA error code (0 on success).
extern "C" int fvp_max_grid(int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fvp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fvp_kernel,
                                                        kThreads, kSmem);
  }
  *grid = sms * per_sm;
  if (err == cudaSuccess && *grid < 1) err = cudaErrorInvalidConfiguration;
  return static_cast<int>(err);
}

// One product: the main launch on min(grid, tiles) blocks, then the
// reduction into out (P entries).  On the given stream, no
// synchronisation; returns cudaGetLastError() after each launch, so a
// refused launch is seen by the caller.
extern "C" int fvp_launch(const void* obs, const void* mask, long long n,
                          const void* theta, const void* v, const void* shift,
                          const void* scale, const void* coef,
                          const void* cls, void* partial, int grid, void* out,
                          void* stream) {
  const long long tiles = (n + kRows - 1) / kRows;
  const int blocks = static_cast<int>(tiles < grid ? tiles : grid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fvp_kernel<<<blocks, kThreads, kSmem, st>>>(
      static_cast<const T*>(obs), static_cast<const T*>(mask), n,
      static_cast<const T*>(theta), static_cast<const T*>(v),
      static_cast<const T*>(shift), static_cast<const T*>(scale),
      static_cast<const T*>(coef), static_cast<T*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fvp_reduce<<<(FvpModel::P + kReduceBlock - 1) / kReduceBlock, kReduceBlock,
               0, st>>>(static_cast<const T*>(partial), blocks,
                        static_cast<const T*>(v), static_cast<const T*>(cls),
                        static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// (parameters, accumulator entries a block, rows a tile, threads a block,
// bytes of shared memory, bytes of T) the library was built for
extern "C" void fvp_dims(int* out) {
  out[0] = FvpModel::P;
  out[1] = Body::NACC;
  out[2] = kRows;
  out[3] = kThreads;
  out[4] = kSmem;
  out[5] = static_cast<int>(sizeof(T));
}
