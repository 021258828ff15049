// Planar whole-control-step kernel (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mjrl_tpu/ops/pallas_planar.py::_kernel (smooth
// branch, lines 52-53), launched by pallas_step_n_batched through the
// pallas_call at line 85: one launch advances every environment of the
// batch by one control step = n semi-implicit Euler substeps of the planar
// chain (the swimmer: nv 7, 5 bodies, 4 actuators, 4 limited hinges, n 5).
//
// What bounds it on this card: not bytes.  A launch reads and writes
// (4 nv + nu) values per environment — about half a megabyte at 4096
// environments, well under a microsecond of HBM time — while each
// environment needs a few thousand scalar operations per substep, most of
// them in one dependent chain (FK -> mass matrix -> Cholesky -> the limit
// dual's 12 Gauss-Seidel sweeps -> solve).  The time is the latency of that
// chain: on an H100 it hardly moves from 1024 to 16384 environments.
//
// What the design does about it.  The first design: one thread per
// environment, all state in registers, blocks of 32, so 4096 environments
// were 128 warps: one per SM, one of its four schedulers busy, and some 190
// IEEE divisions per substep on the chain.  This design:
// - takes each reciprocal once (Cholesky pivots, the Gauss-Seidel divisors,
//   the impedance ramp's constants, baked into the model header) and
//   multiplies: a division costs many instructions and has a slow path;
// - skips what only multiplies by exact zeros (the rows of M^-1's unit
//   right-hand sides before the unit entry, the rows of those solves that are
//   never read, the rotation part of the bias's avp);
// - steps each environment on a group of L consecutive lanes of a warp
//   (PLANAR_LANES, fixed per build; planar_body.cuh::substep): the
//   mass-matrix entries, the bodies' forces and the five triangular solves
//   of the limit dual are split over the lanes, each lane running the same
//   instructions on its own item, and sums and broadcasts over the group go
//   by xor butterfly (group_sum); what is serial (FK, Cholesky, Gauss-Seidel,
//   the final solve) runs on every lane.  Blocks of 128 threads (32 for
//   L = 1, so that 4096 environments still spread over 128 SMs); a group
//   past the batch's end steps a copy of the last environment and stores
//   nothing, since the shuffles need every lane of the warp.  No shared
//   memory, no local arrays: every index is a constant after unrolling.
// Measured (PERF.md): the reciprocals took the swimmer from 57 to 19 us per
// launch of 4096; no L > 1 is faster than L = 1, because the split work is
// off the serial chain and the selects and butterflies cost what it saves,
// so the swimmer runs at L = 1 (ops/cuda_planar.py::CHOSEN_SMOOTH_LANES).
// The TPU kernel's (8, 128) lane-minor tiling and its B % 1024 rule are not
// carried over: rows are read as they lie in the public (B, nv) layout.
//
// Built by mjrl_tpu_torch/ops/cuda_planar.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -DPLANAR_LANES=L
// (no --use_fast_math) next to a generated planar_model.cuh that defines
// struct PlanarModel, one library per model and L; plain C interface,
// loaded with ctypes.

#include <cuda_runtime.h>

#include "planar_model.cuh"
#include "planar_body.cuh"

#ifndef PLANAR_LANES
#error "build with -DPLANAR_LANES=L, L in {1, 2, 4, 8}"
#endif

namespace {

constexpr int kLanes = PLANAR_LANES;
static_assert(kLanes >= 1 && 32 % kLanes == 0, "L must divide 32");
constexpr int kBlock = kLanes == 1 ? 32 : 128;

template <typename T>
__device__ __forceinline__ void step_env(const T* __restrict__ qpos,
                                         const T* __restrict__ qvel,
                                         const T* __restrict__ ctrl,
                                         T* __restrict__ qout,
                                         T* __restrict__ vout, int B, int n) {
  constexpr int NV = PlanarModel::NV, NU = PlanarModel::NU;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int group = tid / kLanes, lane = tid % kLanes;
  // a group past the end steps the last environment and stores nothing: no
  // lane may leave before the shuffles
  const int env = group < B ? group : B - 1;
  T q[NV], v[NV], u[NU];
#pragma unroll
  for (int d = 0; d < NV; ++d) {
    q[d] = qpos[env * NV + d];
    v[d] = qvel[env * NV + d];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = ctrl[env * NU + i];
  for (int s = 0; s < n; ++s) {
    planar::substep<T, PlanarModel, kLanes>(q, v, u, lane);
  }
  if (group < B && lane == 0) {
#pragma unroll
    for (int d = 0; d < NV; ++d) {
      qout[env * NV + d] = q[d];
      vout[env * NV + d] = v[d];
    }
  }
}

int grid_for(int B) {
  return static_cast<int>(
      (static_cast<long long>(B) * kLanes + kBlock - 1) / kBlock);
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
  planar_step_kernel_f32<<<grid_for(B), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qpos), static_cast<const float*>(qvel),
      static_cast<const float*>(ctrl), static_cast<float*>(qout),
      static_cast<float*>(vout), B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int planar_step_f64(const void* qpos, const void* qvel,
                               const void* ctrl, void* qout, void* vout,
                               int B, int n, void* stream) {
  planar_step_kernel_f64<<<grid_for(B), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(qpos), static_cast<const double*>(qvel),
      static_cast<const double*>(ctrl), static_cast<double*>(qout),
      static_cast<double*>(vout), B, n);
  return static_cast<int>(cudaGetLastError());
}

// (nv, nbody, nu, nlim, lanes per environment) the library was built for
extern "C" void planar_model_dims(int* out) {
  out[0] = PlanarModel::NV;
  out[1] = PlanarModel::NB;
  out[2] = PlanarModel::NU;
  out[3] = PlanarModel::NL;
  out[4] = kLanes;
}
