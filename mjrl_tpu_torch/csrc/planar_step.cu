// Planar whole-control-step kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mjrl_tpu/ops/pallas_planar.py::_kernel (smooth
// branch), launched by pallas_step_n_batched: one launch advances every
// environment of the batch by one control step = n semi-implicit Euler
// substeps of the planar chain (the swimmer: nv 7, 5 bodies, 4 actuators,
// 4 limited hinges, n 5).
//
// What bounds it on this card: not bytes.  A launch reads and writes
// (4 nv + nu) values per environment — about half a megabyte at 4096
// environments, well under a microsecond of HBM time — while each
// environment needs a few thousand DEPENDENT scalar operations per substep
// (FK -> mass matrix -> Cholesky -> 12 Gauss-Seidel sweeps -> solve).  The
// time is instruction latency along that serial chain, with only
// B threads to hide it.
//
// What the design does about it: one thread per environment with the whole
// state in registers (the per-environment body, planar_body.cuh, is fully
// unrolled against constexpr model tables, so there is no indexing and no
// local memory), no shared memory and no synchronisation; small blocks of
// 32 threads so that a batch of 4096 spreads over 128 of the 132 SMs
// instead of filling 16 of them; a tail guard so any B >= 1 works.  The TPU
// kernel's (8, 128) lane-minor tiling and its B % 1024 rule are not carried
// over: rows are read as they lie in the public (B, nv) layout.
//
// Built by mjrl_tpu_torch/ops/cuda_planar.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (no --use_fast_math) next to a generated planar_model.cuh that defines
// struct PlanarModel; plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include "planar_model.cuh"
#include "planar_body.cuh"

namespace {

constexpr int kBlock = 32;

template <typename T>
__device__ __forceinline__ void step_env(const T* __restrict__ qpos,
                                         const T* __restrict__ qvel,
                                         const T* __restrict__ ctrl,
                                         T* __restrict__ qout,
                                         T* __restrict__ vout, int B, int n) {
  constexpr int NV = PlanarModel::NV, NU = PlanarModel::NU;
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  T q[NV], v[NV], u[NU];
#pragma unroll
  for (int d = 0; d < NV; ++d) {
    q[d] = qpos[env * NV + d];
    v[d] = qvel[env * NV + d];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = ctrl[env * NU + i];
  for (int s = 0; s < n; ++s) planar::substep<T, PlanarModel>(q, v, u);
#pragma unroll
  for (int d = 0; d < NV; ++d) {
    qout[env * NV + d] = q[d];
    vout[env * NV + d] = v[d];
  }
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kBlock)
planar_step_kernel_f32(const float* qpos, const float* qvel,
                       const float* ctrl, float* qout, float* vout, int B,
                       int n) {
  step_env<float>(qpos, qvel, ctrl, qout, vout, B, n);
}

extern "C" __global__ void __launch_bounds__(kBlock)
planar_step_kernel_f64(const double* qpos, const double* qvel,
                       const double* ctrl, double* qout, double* vout, int B,
                       int n) {
  step_env<double>(qpos, qvel, ctrl, qout, vout, B, n);
}

// C interface: launch on the given stream, no synchronisation; returns
// cudaGetLastError() so a refused launch is seen by the caller.
extern "C" int planar_step_f32(const void* qpos, const void* qvel,
                               const void* ctrl, void* qout, void* vout,
                               int B, int n, void* stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  planar_step_kernel_f32<<<grid, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qpos), static_cast<const float*>(qvel),
      static_cast<const float*>(ctrl), static_cast<float*>(qout),
      static_cast<float*>(vout), B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int planar_step_f64(const void* qpos, const void* qvel,
                               const void* ctrl, void* qout, void* vout,
                               int B, int n, void* stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  planar_step_kernel_f64<<<grid, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(qpos), static_cast<const double*>(qvel),
      static_cast<const double*>(ctrl), static_cast<double*>(qout),
      static_cast<double*>(vout), B, n);
  return static_cast<int>(cudaGetLastError());
}

// (nv, nbody, nu, nlim) the library was built for
extern "C" void planar_model_dims(int* out) {
  out[0] = PlanarModel::NV;
  out[1] = PlanarModel::NB;
  out[2] = PlanarModel::NU;
  out[3] = PlanarModel::NL;
}
