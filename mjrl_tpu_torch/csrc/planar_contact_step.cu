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
// them in dependent chains, with only B threads to hide their latency.
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
// What the design does about it: one thread per environment, as in the
// smooth kernel, in blocks of 32 so that 4096 environments spread over 128
// of the 132 SMs.  The working set (rows, M^-1 J^T and the per-row vectors,
// 3 to 8 KB per environment) does not fit in registers; it lives in
// thread-local arrays, which the hardware interleaves across the threads of
// a warp (coalesced) and which stay in L1 (about 100 to 250 KB per warp; the
// kernel asks for the largest L1 carve-out) and L2.  Sweeps, power
// iterations and stages are run-time loops around one inlined copy of the
// solve, so the code stays small and builds in under a minute; only the model's
// structure is unrolled.  Work is fixed: no convergence test, no early
// exit, so every thread of a warp follows the same path.
//
// Built by mjrl_tpu_torch/ops/cuda_planar.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (no --use_fast_math) next to a generated planar_model.cuh; plain C
// interface, loaded with ctypes.

#include <cuda_runtime.h>

#include "planar_model.cuh"
#include "planar_contact.cuh"

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
  planar::contact_step_n<T, PlanarModel>(q, v, u, n);
#pragma unroll
  for (int d = 0; d < NV; ++d) {
    qout[env * NV + d] = q[d];
    vout[env * NV + d] = v[d];
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

// the per-thread arrays are local memory: prefer L1 over shared memory
template <typename K>
int prefer_l1(K kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1));
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
  const int grid = (B + kBlock - 1) / kBlock;
  planar_contact_kernel_f32<<<grid, kBlock, 0,
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
  const int grid = (B + kBlock - 1) / kBlock;
  planar_contact_kernel_f64<<<grid, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(qpos), static_cast<const double*>(qvel),
      static_cast<const double*>(ctrl), static_cast<double*>(qout),
      static_cast<double*>(vout), B, n);
  return static_cast<int>(cudaGetLastError());
}

// (nv, nbody, nu, constraint rows) the library was built for
extern "C" void planar_model_dims(int* out) {
  out[0] = PlanarModel::NV;
  out[1] = PlanarModel::NB;
  out[2] = PlanarModel::NU;
  out[3] = PlanarModel::NROWS;
}
