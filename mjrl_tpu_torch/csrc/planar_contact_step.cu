// Planar contact / RK4 control-step kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the CONTACT branch of the TPU kernel
// mjrl_tpu/ops/pallas_planar.py::_kernel (lines 47-51, launched by
// pallas_step_n_batched through the pallas_call at line 85), i.e.
// mjrl_tpu/physics/planar.py::planar_contact_step_n_comp: one launch
// advances every environment of the batch by one control step of a planar
// tree with ground contacts (Hopper: nv 6, 38 constraint rows, 4 substeps x
// 4 RK4 stages; Walker2d: nv 9, 62 rows; HalfCheetah: nv 9, 70 rows, 5
// Euler substeps).  The arithmetic is in planar_contact.cuh.
//
// What bounds it on this card: operations, not bytes.  A launch moves
// (4 nv + nu) values per environment, under half a megabyte for 4096
// environments, while one Hopper control step is 16 dual solves = 403
// applications of the dual operator (2 C nv multiply-adds each) plus 16 x 38
// triangular solves: some 10^6 scalar operations per environment, most of
// them in dependent chains, which one thread per environment leaves B
// threads to hide.
//
// Divisions: an IEEE-rounded division costs many instructions on this card
// and has a slow path for operands near the ends of the range.  A first
// version of this kernel divided wherever the plain version does (two
// divisions per row in every application of the dual operator) and spent
// four fifths of its time there: 7.4 ms per launch of 4096 hoppers on an
// H100 (700 W), 4.2 ms on states that took the slow path less often.  This
// version keeps IEEE arithmetic (no --use_fast_math, no -prec-div=false)
// but takes each reciprocal once and multiplies (planar_contact.cuh):
// 1.3 ms, whatever the states.
//
// What the design does about it: one environment per group of L lanes of a
// warp (PLANAR_LANES, fixed per build; planar_contact.cuh).  With one thread
// per environment (L = 1, the first design) 4096 environments are 128 warps,
// one per SM and one of its four schedulers busy, and the working set (rows,
// M^-1 J^T and the per-row vectors, 3 to 8 KB per environment) lives in
// thread-local memory.  With L lanes the group's rows are spread over its
// lanes, ceil(C / L) or a few more per lane, so a lane's share of the working
// set fits in registers; the dual operator's sum over rows becomes per-lane
// partial sums and a log2(L)-step shuffle butterfly of nv values; and the
// card holds L times as many warps.  What every lane of a group repeats
// (smooth dynamics, Cholesky, row assembly, the integrator) is the price.
// Blocks of 128 threads (32 for L = 1, as the first
// design, so that 4096 environments still spread over 128 SMs); a group past
// the batch's end steps a copy of the last environment and stores nothing,
// since the shuffles need every lane of the warp.  Sweeps, power iterations
// and stages are run-time loops around one inlined copy of the solve, so the
// code stays small; only the model's structure and a lane's slots are
// unrolled.  Work is fixed: no convergence test, no early exit, so every
// lane of a warp follows the same path.
//
// Built by mjrl_tpu_torch/ops/cuda_planar.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -DPLANAR_LANES=L
// (no --use_fast_math) next to a generated planar_model.cuh, one library per
// model and L; plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include "planar_model.cuh"
#include "planar_contact.cuh"

#ifndef PLANAR_LANES
#error "build with -DPLANAR_LANES=L, L in {1, 8, 16, 32}"
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
  planar::contact_step_n<T, PlanarModel, kLanes>(q, v, u, n, lane);
  if (group < B && lane == 0) {
#pragma unroll
    for (int d = 0; d < NV; ++d) {
      qout[env * NV + d] = q[d];
      vout[env * NV + d] = v[d];
    }
  }
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kBlock)
planar_contact_kernel_f32(const float* qpos, const float* qvel,
                          const float* ctrl, float* qout, float* vout, int B,
                          int n) {
  step_env<float>(qpos, qvel, ctrl, qout, vout, B, n);
}

extern "C" __global__ void __launch_bounds__(kBlock)
planar_contact_kernel_f64(const double* qpos, const double* qvel,
                          const double* ctrl, double* qout, double* vout,
                          int B, int n) {
  step_env<double>(qpos, qvel, ctrl, qout, vout, B, n);
}

namespace {

// thread-local arrays (L = 1) and spills are local memory, and the kernel
// uses no shared memory: prefer L1
template <typename K>
int prefer_l1(K kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1));
}

int grid_for(int B) {
  return static_cast<int>(
      (static_cast<long long>(B) * kLanes + kBlock - 1) / kBlock);
}

}  // namespace

// C interface: launch on the given stream, no synchronisation; returns
// cudaGetLastError() so a refused launch is seen by the caller.
extern "C" int planar_contact_step_f32(const void* qpos, const void* qvel,
                                       const void* ctrl, void* qout,
                                       void* vout, int B, int n,
                                       void* stream) {
  static const int carve = prefer_l1(planar_contact_kernel_f32);
  if (carve != 0) return carve;
  planar_contact_kernel_f32<<<grid_for(B), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qpos), static_cast<const float*>(qvel),
      static_cast<const float*>(ctrl), static_cast<float*>(qout),
      static_cast<float*>(vout), B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int planar_contact_step_f64(const void* qpos, const void* qvel,
                                       const void* ctrl, void* qout,
                                       void* vout, int B, int n,
                                       void* stream) {
  static const int carve = prefer_l1(planar_contact_kernel_f64);
  if (carve != 0) return carve;
  planar_contact_kernel_f64<<<grid_for(B), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(qpos), static_cast<const double*>(qvel),
      static_cast<const double*>(ctrl), static_cast<double*>(qout),
      static_cast<double*>(vout), B, n);
  return static_cast<int>(cudaGetLastError());
}

// (nv, nbody, nu, constraint rows, lanes per environment) the library was
// built for
extern "C" void planar_model_dims(int* out) {
  out[0] = PlanarModel::NV;
  out[1] = PlanarModel::NB;
  out[2] = PlanarModel::NU;
  out[3] = PlanarModel::NROWS;
  out[4] = kLanes;
}
