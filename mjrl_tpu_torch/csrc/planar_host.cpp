// Host harness for the planar kernel body: compiles planar_body.cuh with
// g++ and steps a batch of environments in a plain loop, so the kernel's
// arithmetic can be held against the plain PyTorch version without a GPU
// (tests/test_torch_kernel_host.py).  Same C interface as planar_step.cu,
// minus the stream.

#include "planar_model.cuh"
#include "planar_body.cuh"

namespace {

template <typename T>
void step_batch(const T* qpos, const T* qvel, const T* ctrl, T* qout,
                T* vout, int B, int n) {
  constexpr int NV = PlanarModel::NV, NU = PlanarModel::NU;
  for (int env = 0; env < B; ++env) {
    T q[NV], v[NV], u[NU];
    for (int d = 0; d < NV; ++d) {
      q[d] = qpos[env * NV + d];
      v[d] = qvel[env * NV + d];
    }
    for (int i = 0; i < NU; ++i) u[i] = ctrl[env * NU + i];
    for (int s = 0; s < n; ++s) planar::substep<T, PlanarModel>(q, v, u);
    for (int d = 0; d < NV; ++d) {
      qout[env * NV + d] = q[d];
      vout[env * NV + d] = v[d];
    }
  }
}

}  // namespace

extern "C" void planar_host_step_f32(const float* qpos, const float* qvel,
                                     const float* ctrl, float* qout,
                                     float* vout, int B, int n) {
  step_batch<float>(qpos, qvel, ctrl, qout, vout, B, n);
}

extern "C" void planar_host_step_f64(const double* qpos, const double* qvel,
                                     const double* ctrl, double* qout,
                                     double* vout, int B, int n) {
  step_batch<double>(qpos, qvel, ctrl, qout, vout, B, n);
}
