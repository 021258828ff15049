// Host harness for the kernel bodies at L > 1 lanes per environment (the
// smooth body at L = 2, 4, 8; the contact body at L = 8, 16, 32): the L
// lanes of a group are L fibers (ucontext) on one thread, and group_sum's
// xor butterfly is done step by step as the warp shuffles do it — every lane
// posts its value, the lanes take turns, every lane reads its partner's
// (lane ^ o), the lanes take turns again, every lane adds.  Built with g++
// next to the generated planar_model.cuh (mjrl_tpu_torch/ops/cuda_planar.py::
// load_host_body), so the lane-group code — the split of work over the
// lanes, row ownership, triple groups, the group reductions and the rule
// that every lane of a group ends with the same bits — is tested where
// there is no GPU (tests/test_torch_kernel_host.py).  One thread, fixed
// turns: the run does not depend on how the machine schedules threads.

#include <ucontext.h>

#include <cstring>
#include <vector>

namespace planar_host_lanes {

// the L fibers of one group, run in turns: a lane that calls turn() passes
// to the next lane that has not finished
struct Group {
  int lanes = 0, current = 0;
  ucontext_t main_ctx;
  ucontext_t ctx[32];
  bool done[32];
  long reductions[32];     // group_sum steps per lane: must all agree
  double buf[32];

  void turn() {
    const int from = current;
    int next = from;
    do {
      next = (next + 1) % lanes;
    } while (done[next] && next != from);
    current = next;
    if (next != from) swapcontext(&ctx[from], &ctx[next]);
  }

  void finish() {              // this lane is done: go on with another
    done[current] = true;
    for (int k = 1; k <= lanes; ++k) {
      const int next = (current + k) % lanes;
      if (!done[next]) {
        current = next;
        setcontext(&ctx[next]);
      }
    }
    setcontext(&main_ctx);
  }
};

Group* group = nullptr;

template <int L, typename T>
T exchange_sum(T x) {
  Group& g = *group;
  const int lane = g.current;
  for (int o = L / 2; o > 0; o >>= 1) {
    g.buf[lane] = static_cast<double>(x);   // exact for float and double
    g.turn();                                // every lane has posted
    const T y = static_cast<T>(g.buf[lane ^ o]);
    g.turn();                                // every lane has read
    x = x + y;
    ++g.reductions[lane];
  }
  return x;
}

}  // namespace planar_host_lanes

#define PLANAR_HOST_LANES 1
#include "planar_model.cuh"
#include "planar_contact.cuh"

namespace {

constexpr int NV = PlanarModel::NV, NU = PlanarModel::NU;

// what one lane steps: read by the fiber entry, which takes no arguments
template <typename T>
struct Job {
  const T *q, *v, *u;
  int n;
  T out[32][2 * NV];
};

template <typename T, int L>
Job<T>* job = nullptr;

template <typename T, int L>
void run_lane() {
  planar_host_lanes::Group& g = *planar_host_lanes::group;
  const int lane = g.current;
  Job<T>& jb = *job<T, L>;
  T q[NV], v[NV], u[NU];
  for (int d = 0; d < NV; ++d) {
    q[d] = jb.q[d];
    v[d] = jb.v[d];
  }
  for (int i = 0; i < NU; ++i) u[i] = jb.u[i];
  if constexpr (PlanarModel::CONTACT_PATH) {
    planar::contact_step_n<T, PlanarModel, L>(q, v, u, jb.n, lane);
  } else {
    for (int s = 0; s < jb.n; ++s) {
      planar::substep<T, PlanarModel, L>(q, v, u, lane);
    }
  }
  for (int d = 0; d < NV; ++d) {
    jb.out[lane][d] = q[d];
    jb.out[lane][NV + d] = v[d];
  }
  g.finish();
}

// -> number of environments whose lanes ended with different bits, or -1
// if the lanes of a group made different numbers of group reductions
template <typename T, int L>
int step_batch(const T* qpos, const T* qvel, const T* ctrl, T* qout,
               T* vout, int B, int n) {
  constexpr size_t kStack = 1 << 20;
  std::vector<char> stacks(L * kStack);
  planar_host_lanes::Group g;
  planar_host_lanes::group = &g;
  Job<T> jb;
  job<T, L> = &jb;
  int differ = 0;
  for (int env = 0; env < B; ++env) {
    jb.q = qpos + env * NV;
    jb.v = qvel + env * NV;
    jb.u = ctrl + env * NU;
    jb.n = n;
    g.lanes = L;
    g.current = 0;
    for (int l = 0; l < L; ++l) {
      g.done[l] = false;
      g.reductions[l] = 0;
      getcontext(&g.ctx[l]);
      g.ctx[l].uc_stack.ss_sp = stacks.data() + l * kStack;
      g.ctx[l].uc_stack.ss_size = kStack;
      g.ctx[l].uc_link = nullptr;
      makecontext(&g.ctx[l], run_lane<T, L>, 0);
    }
    swapcontext(&g.main_ctx, &g.ctx[0]);
    for (int l = 1; l < L; ++l) {
      if (g.reductions[l] != g.reductions[0]) return -1;
    }
    for (int d = 0; d < NV; ++d) {
      qout[env * NV + d] = jb.out[0][d];
      vout[env * NV + d] = jb.out[0][NV + d];
    }
    for (int l = 1; l < L; ++l) {
      if (std::memcmp(jb.out[l], jb.out[0], sizeof(jb.out[0])) != 0) {
        ++differ;
        break;
      }
    }
  }
  planar_host_lanes::group = nullptr;
  return differ;
}

template <typename T>
int step_lanes(const T* qpos, const T* qvel, const T* ctrl, T* qout,
               T* vout, int B, int n, int lanes) {
  if constexpr (PlanarModel::CONTACT_PATH) {
    switch (lanes) {
      case 8: return step_batch<T, 8>(qpos, qvel, ctrl, qout, vout, B, n);
      case 16: return step_batch<T, 16>(qpos, qvel, ctrl, qout, vout, B, n);
      case 32: return step_batch<T, 32>(qpos, qvel, ctrl, qout, vout, B, n);
      default: return -2;
    }
  } else {
    switch (lanes) {
      case 2: return step_batch<T, 2>(qpos, qvel, ctrl, qout, vout, B, n);
      case 4: return step_batch<T, 4>(qpos, qvel, ctrl, qout, vout, B, n);
      case 8: return step_batch<T, 8>(qpos, qvel, ctrl, qout, vout, B, n);
      default: return -2;
    }
  }
}

}  // namespace

extern "C" int planar_host_lanes_step_f32(const float* qpos,
                                          const float* qvel,
                                          const float* ctrl, float* qout,
                                          float* vout, int B, int n,
                                          int lanes) {
  return step_lanes<float>(qpos, qvel, ctrl, qout, vout, B, n, lanes);
}

extern "C" int planar_host_lanes_step_f64(const double* qpos,
                                          const double* qvel,
                                          const double* ctrl, double* qout,
                                          double* vout, int B, int n,
                                          int lanes) {
  return step_lanes<double>(qpos, qvel, ctrl, qout, vout, B, n, lanes);
}
