// Host harness for the Fisher-vector product kernel (K3): compiles
// fvp_body.cuh with g++ and runs one block's work in plain loops (the
// tile load, then every thread's part of each layer step, then every
// thread's outer products, tile after tile; then the reduction over that
// one block's partials), so the kernel's
// arithmetic can be held against the plain PyTorch version without a GPU
// (tests/test_torch_fvp_host.py).  Same C interface as fvp.cu's launch,
// minus the grid and the stream.

#include <vector>

#include "fvp_model.cuh"
#include "fvp_body.cuh"

namespace {

template <typename T, int ROWS, int NT>
void product(const T* obs, const T* mask, long long n, const T* theta,
             const T* v, const T* shift, const T* scale, const T* coef,
             const T* cls, T* out) {
  using Body = fvp::Body<T, FvpModel, ROWS, NT>;
  std::vector<T> smem(Body::SIZE), partial(Body::NACC);
  const Body body{smem.data()};
  for (int t = 0; t < NT; ++t) {
    body.setup(theta, v, coef, shift, scale, t, NT);
  }
  for (long long row0 = 0; row0 < n; row0 += ROWS) {
    for (int t = 0; t < NT; ++t) body.load_tile(obs, mask, n, row0, t);
    for (int st = 0; st < Body::STEPS; ++st) {
      for (int t = 0; t < NT; ++t) body.step(st, t);
    }
    for (int t = 0; t < NT; ++t) body.template outer<0>(t, NT);
  }
  for (int t = 0; t < NT; ++t) body.store(partial.data(), t, NT);
  for (int p = 0; p < FvpModel::P; ++p) {
    out[p] = fvp::reduce_entry<T, FvpModel>(p, partial.data(), 1, v, cls);
  }
}

}  // namespace

extern "C" void fvp_host_f32(const float* obs, const float* mask, long long n,
                             const float* theta, const float* v,
                             const float* shift, const float* scale,
                             const float* coef, const float* cls, float* out) {
  product<float, FVP_ROWS, FVP_THREADS>(obs, mask, n, theta, v, shift, scale,
                                        coef, cls, out);
}

extern "C" void fvp_host_f64(const double* obs, const double* mask,
                             long long n, const double* theta, const double* v,
                             const double* shift, const double* scale,
                             const double* coef, const double* cls,
                             double* out) {
  product<double, FVP_ROWS, FVP_THREADS>(obs, mask, n, theta, v, shift,
                                         scale, coef, cls, out);
}
