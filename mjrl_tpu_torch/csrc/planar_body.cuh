// Per-environment body of the planar whole-control-step kernel (K1), and
// the smooth dynamics the contact kernel shares.
//
// One call of planar::substep<T, M, L> advances ONE environment of a smooth
// chain by one semi-implicit Euler physics step, on lane `lane` of a group
// of L lanes that step that environment together.  The step: planar FK,
// composite-rigid-body mass matrix + armature, Coriolis bias via cdofdot,
// MuJoCo inertia-box fluid force, gravity / joint springs / damping, clipped
// gear actuation, an unrolled Cholesky factorization, the implicit
// joint-limit dual over the limited dofs (solimp impedance, projected
// Gauss-Seidel) and the solve with M + h diag(damping).  It follows
// mjrl_tpu_torch/physics/planar.py::planar_substep, the plain version it is
// tested against, with five departures, none of which moves a result by
// more than rounding: (1) each reciprocal is taken once and multiplied by (a
// Cholesky pivot, a Gauss-Seidel divisor, the impedance ramp's constants),
// and only the ramp branch that is selected is evaluated; (2) work that only
// multiplies by exact zeros is skipped (the rows of a unit right-hand side
// before its unit entry, the rows of a solve that are never read, the
// rotation part of the bias's avp); (3) pow(t, 2) is t * t; (4) the sums on
// the dependent chain (back-substitution, Gauss-Seidel residual) add the
// newest term last; (5) at L > 1 the sums of the bodies' forces run per lane
// and then over the group.
// planar::smooth<T, M> is the contact kernel's smooth dynamics
// (planar_contact.cuh), the plain version's arithmetic in its order.
//
// T is float or double.  M is a model-traits struct (generated from
// PlanarParams by mjrl_tpu_torch/ops/cuda_planar.py::emit_model_header)
// whose sizes and tables are constexpr, so that after full unrolling every
// index and every structural branch (which dof drives which body, which
// dofs are limited) is a compile-time constant and all state lives in
// registers.  The file has no CUDA-only construct outside the PLANAR_HD
// macro and group_sum, so g++ compiles it for the host test harnesses
// (planar_host.cpp at L = 1, planar_host_lanes.cpp at L > 1).
#pragma once

#include <cmath>

#if defined(__CUDACC__)
#define PLANAR_HD __host__ __device__ __forceinline__
#define PLANAR_UNROLL _Pragma("unroll")
#else
#define PLANAR_HD inline
#define PLANAR_UNROLL
#endif

namespace planar {

// ---- scalar math, true (not fast-math) versions --------------------------
PLANAR_HD void sin_cos(float x, float& s, float& c) {
#if defined(__CUDA_ARCH__)
  sincosf(x, &s, &c);
#else
  s = std::sin(x);
  c = std::cos(x);
#endif
}
PLANAR_HD void sin_cos(double x, double& s, double& c) {
#if defined(__CUDA_ARCH__)
  sincos(x, &s, &c);
#else
  s = std::sin(x);
  c = std::cos(x);
#endif
}
PLANAR_HD float sqrt_(float x) { return sqrtf(x); }
PLANAR_HD double sqrt_(double x) { return sqrt(x); }
PLANAR_HD float pow_(float x, float y) { return powf(x, y); }
PLANAR_HD double pow_(double x, double y) { return pow(x, y); }
PLANAR_HD float abs_(float x) { return fabsf(x); }
PLANAR_HD double abs_(double x) { return fabs(x); }

// clamps that let NaN through, like torch.clamp
template <typename T>
PLANAR_HD T clamp_min(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
PLANAR_HD T clamp(T x, T lo, T hi) { return x < lo ? lo : (x > hi ? hi : x); }

// h = I_b (w, u) for planar motion -> (n_z, f)
template <typename T>
PLANAR_HD void apply_inertia(T mass, T izz, T cx, T cy, T w, T ux, T uy,
                             T& n, T& fx, T& fy) {
  const T pcx = -cy, pcy = cx;
  fx = mass * (ux + w * pcx);
  fy = mass * (uy + w * pcy);
  n = izz * w + (cx * fy - cy * fx);
}

// MuJoCo solimp impedance ramp of limited dof i at a violation >= 0
template <typename T, typename M>
PLANAR_HD T impedance(int i, T violation) {
  const T d0 = T(M::solimp(i, 0)), dw = T(M::solimp(i, 1));
  const T width = T(M::solimp(i, 2)), mid = T(M::solimp(i, 3));
  const T power = T(M::solimp(i, 4));
  const T x = clamp(violation / width, T(0), T(1));
  const T y_lo = mid * pow_(x / mid, power);
  const T y_hi = T(1) - T(1.0 - M::solimp(i, 3))
      * pow_((T(1) - x) / T(1.0 - M::solimp(i, 3)), power);
  const T y = x < mid ? y_lo : y_hi;
  return clamp(d0 + y * T(M::solimp(i, 1) - M::solimp(i, 0)),
               T(1e-4), T(1.0 - 1e-4));
}


// K1's form of the impedance of limited dof i: 1 / width, 1 / mid and
// 1 / (1 - mid) are baked into the model (M::solimp_inv), only the branch
// that x < mid selects is evaluated, and where the model's power is 2,
// pow(t, 2) is t * t (PyTorch computes the plain version's t ** 2.0 so too)
template <typename T, typename M>
PLANAR_HD T impedance_k1(int i, T violation) {
  const T mid = T(M::solimp(i, 3));
  const T x = clamp(violation * T(M::solimp_inv(i, 0)), T(0), T(1));
  const bool lo = x < mid;
  const T t = lo ? x * T(M::solimp_inv(i, 1))
                 : (T(1) - x) * T(M::solimp_inv(i, 2));
  const T tp = M::solimp(i, 4) == 2.0 ? t * t
                                      : pow_(t, T(M::solimp(i, 4)));
  const T y = lo ? mid * tp : T(1) - T(1.0 - M::solimp(i, 3)) * tp;
  return clamp(T(M::solimp(i, 0)) + y * T(M::solimp(i, 1) - M::solimp(i, 0)),
               T(1e-4), T(1.0 - 1e-4));
}

// the constants of body b that its applied force needs
template <typename T>
struct BodyConst {
  T mass, izz;
  T r0[3][3], cv, cw, qf[3], qt[3];   // inertia-box fluid
  T fgx, fgy;                          // weight
};

template <typename T, typename M>
PLANAR_HD BodyConst<T> body_const(int b) {
  BodyConst<T> c;
  c.mass = T(M::mass(b));
  c.izz = T(M::izz(b));
  PLANAR_UNROLL
  for (int i = 0; i < 3; ++i) {
    PLANAR_UNROLL
    for (int k = 0; k < 3; ++k) c.r0[i][k] = T(M::r0(b, i, k));
    c.qf[i] = T(M::fluid_qf(b, i));
    c.qt[i] = T(M::fluid_qt(b, i));
  }
  c.cv = T(M::fluid_cv(b));
  c.cw = T(M::fluid_cw(b));
  c.fgx = T(M::mass(b) * M::gravity(0));
  c.fgy = T(M::mass(b) * M::gravity(1));
  return c;
}

// planar reduction of the inertia-box fluid force on a body with constants
// k, about the world origin -> (n_z, f)
template <typename T>
PLANAR_HD void fluid(const BodyConst<T>& k, T c, T s, T cx, T cy, T w, T ux,
                     T uy, T& nz, T& fwx, T& fwy) {
  const T pcx = -cy, pcy = cx;
  const T vx = ux + w * pcx;
  const T vy = uy + w * pcy;
  const T vrx = c * vx + s * vy;
  const T vry = -s * vx + c * vy;
  T f_l[3], t_l[3];
  PLANAR_UNROLL
  for (int i = 0; i < 3; ++i) {
    const T v_l = k.r0[0][i] * vrx + k.r0[1][i] * vry;
    const T w_l = k.r0[2][i] * w;
    f_l[i] = k.cv * v_l - k.qf[i] * abs_(v_l) * v_l;
    t_l[i] = k.cw * w_l - k.qt[i] * abs_(w_l) * w_l;
  }
  T fr[2];
  PLANAR_UNROLL
  for (int i = 0; i < 2; ++i) {
    T acc = T(0);
    PLANAR_UNROLL
    for (int j = 0; j < 3; ++j) acc = acc + k.r0[i][j] * f_l[j];
    fr[i] = acc;
  }
  T tr2 = T(0);
  PLANAR_UNROLL
  for (int j = 0; j < 3; ++j) tr2 = tr2 + k.r0[2][j] * t_l[j];
  fwx = c * fr[0] - s * fr[1];
  fwy = s * fr[0] + c * fr[1];
  nz = tr2 + (cx * fwy - cy * fwx);
}

// The force on a body, f_b = I avp + v x* (I v) - fluid - weight, about the
// world origin -> (n_tot, ft): k its constants, (c, s) its rotation, (cx, cy)
// its world CoM, (w, ux, uy) its velocity, (aw, aux, auy) its avp.
template <typename T, typename M>
PLANAR_HD void body_force(const BodyConst<T>& k, T c, T s, T cx, T cy, T w,
                          T ux, T uy, T aw, T aux, T auy, T& n_tot, T& ftx,
                          T& fty) {
  T n1, f1x, f1y, nh, fhx, fhy;
  apply_inertia(k.mass, k.izz, cx, cy, aw, aux, auy, n1, f1x, f1y);
  apply_inertia(k.mass, k.izz, cx, cy, w, ux, uy, nh, fhx, fhy);
  const T n2 = ux * fhy - uy * fhx;
  const T f2x = w * -fhy, f2y = w * fhx;
  n_tot = n1 + n2;
  ftx = f1x + f2x;
  fty = f1y + f2y;
  if (M::HAS_FLUID) {
    T nf, ffx, ffy;
    fluid<T>(k, c, s, cx, cy, w, ux, uy, nf, ffx, ffy);
    n_tot = n_tot - nf;
    ftx = ftx - ffx;
    fty = fty - ffy;
  }
  if (M::HAS_GRAVITY) {
    n_tot = n_tot - (cx * k.fgy - cy * k.fgx);
    ftx = ftx - k.fgx;
    fty = fty - k.fgy;
  }
}

// What the constraint code needs of the kinematics: body rotations and
// origins, and the per-dof motion axes (omega, u).
template <typename T, typename M>
struct Kinematics {
  T cph[M::NB], sph[M::NB], orgx[M::NB], orgy[M::NB];
  T sw[M::NV], sx[M::NV], sy[M::NV];
};

// What the dynamics needs besides: world CoMs, body velocities and the
// cdofdot translations (their rotation part is zero).
template <typename T, typename M>
struct Motion {
  T comx[M::NB], comy[M::NB];
  T velw[M::NB], velx[M::NB], vely[M::NB];
  T sdx[M::NV], sdy[M::NV];
};

// Planar FK, the motion axes, body velocities down the tree and cdofdot.
template <typename T, typename M>
PLANAR_HD void kinematics(const T (&q)[M::NV], const T (&v)[M::NV],
                          Kinematics<T, M>& kin, Motion<T, M>& mo) {
  constexpr int NV = M::NV, NB = M::NB;
  const T zero = T(0), one = T(1);
  T (&cph)[NB] = kin.cph;
  T (&sph)[NB] = kin.sph;
  T (&orgx)[NB] = kin.orgx;
  T (&orgy)[NB] = kin.orgy;
  T (&sw)[NV] = kin.sw;
  T (&sx)[NV] = kin.sx;
  T (&sy)[NV] = kin.sy;

  // ---- FK: body angles, origins, hinge anchors, world CoMs ----------------
  T phi[NB], ancx[NB], ancy[NB];
  {
    const T q0 = q[0] - T(M::slide_ref(0));
    const T q1 = q[1] - T(M::slide_ref(1));
    phi[0] = T(M::hinge_sign(0)) * q[M::body_dof(0)];
    orgx[0] = T(M::offset(0, 0)) + q0 * T(M::slide_dir(0, 0))
        + q1 * T(M::slide_dir(1, 0));
    orgy[0] = T(M::offset(0, 1)) + q0 * T(M::slide_dir(0, 1))
        + q1 * T(M::slide_dir(1, 1));
    ancx[0] = orgx[0];
    ancy[0] = orgy[0];
    sin_cos(phi[0], sph[0], cph[0]);
  }
  PLANAR_UNROLL
  for (int b = 1; b < NB; ++b) {
    const int pb = M::parent(b);
    const T c = cph[pb], s = sph[pb];
    const T oxj = T(M::offset(b, 0) + M::jpos(b, 0));
    const T oyj = T(M::offset(b, 1) + M::jpos(b, 1));
    const T jx = T(M::jpos(b, 0)), jy = T(M::jpos(b, 1));
    const T ax = orgx[pb] + c * oxj - s * oyj;
    const T ay = orgy[pb] + s * oxj + c * oyj;
    phi[b] = phi[pb] + T(M::hinge_sign(b)) * q[M::body_dof(b)];
    sin_cos(phi[b], sph[b], cph[b]);
    orgx[b] = ax - (cph[b] * jx - sph[b] * jy);
    orgy[b] = ay - (sph[b] * jx + cph[b] * jy);
    ancx[b] = ax;
    ancy[b] = ay;
  }
  PLANAR_UNROLL
  for (int b = 0; b < NB; ++b) {
    const T cx = T(M::com(b, 0)), cy = T(M::com(b, 1));
    mo.comx[b] = orgx[b] + cph[b] * cx - sph[b] * cy;
    mo.comy[b] = orgy[b] + sph[b] * cx + cph[b] * cy;
  }

  // ---- per-dof motion axes (omega, u) --------------------------------------
  sw[0] = zero; sx[0] = T(M::slide_dir(0, 0)) * one;
  sy[0] = T(M::slide_dir(0, 1)) * one;
  sw[1] = zero; sx[1] = T(M::slide_dir(1, 0)) * one;
  sy[1] = T(M::slide_dir(1, 1)) * one;
  PLANAR_UNROLL
  for (int b = 0; b < NB; ++b) {
    const int d = M::body_dof(b);
    sw[d] = T(M::hinge_sign(b)) * one;
    sx[d] = T(M::hinge_sign(b)) * ancy[b];
    sy[d] = T(-M::hinge_sign(b)) * ancx[b];
  }

  // ---- body velocities down the tree + cdofdot ----------------------------
  T (&velw)[NB] = mo.velw;
  T (&velx)[NB] = mo.velx;
  T (&vely)[NB] = mo.vely;
  mo.sdx[0] = mo.sdx[1] = mo.sdy[0] = mo.sdy[1] = zero;
  const T rootx = v[0] * T(M::slide_dir(0, 0)) + v[1] * T(M::slide_dir(1, 0));
  const T rooty = v[0] * T(M::slide_dir(0, 1)) + v[1] * T(M::slide_dir(1, 1));
  PLANAR_UNROLL
  for (int b = 0; b < NB; ++b) {
    const int d = M::body_dof(b);
    const int pb = M::parent(b);
    const T w_c = pb < 0 ? zero : velw[pb < 0 ? 0 : pb];
    const T ux_c = pb < 0 ? rootx : velx[pb < 0 ? 0 : pb];
    const T uy_c = pb < 0 ? rooty : vely[pb < 0 ? 0 : pb];
    mo.sdx[d] = w_c * -sy[d] - sw[d] * -uy_c;
    mo.sdy[d] = w_c * sx[d] - sw[d] * ux_c;
    velw[b] = w_c + sw[d] * v[d];
    velx[b] = ux_c + sx[d] * v[d];
    vely[b] = uy_c + sy[d] * v[d];
  }
}

// qfrc = damping + springs + clipped gear actuation - bias
template <typename T, typename M>
PLANAR_HD void applied(const T (&q)[M::NV], const T (&v)[M::NV],
                       const T (&u)[M::NU], const T (&bias)[M::NV],
                       T (&qfrc)[M::NV]) {
  PLANAR_UNROLL
  for (int d = 0; d < M::NV; ++d) {
    qfrc[d] = T(-M::damping(d)) * v[d] - bias[d];
    if (M::HAS_SPRINGS && M::stiffness(d) != 0.0) {
      qfrc[d] = qfrc[d] - T(M::stiffness(d)) * (q[d] - T(M::spring_ref(d)));
    }
  }
  PLANAR_UNROLL
  for (int i = 0; i < M::NU; ++i) {
    const T c = M::ctrl_limited(i)
        ? clamp(u[i], T(M::ctrl_lo(i)), T(M::ctrl_hi(i))) : u[i];
    qfrc[M::act_dof(i)] = qfrc[M::act_dof(i)] + T(M::gear(i)) * c;
  }
}

// Smooth dynamics at (q, v) under the (unclipped) control u: the mass
// matrix (upper triangle of m, armature included) and the constraint-free
// applied force qfrc = actuation + damping + springs - bias; kin receives
// the kinematics.  The contact kernel's (planar_contact.cuh); K1 has its
// own, substep below.
template <typename T, typename M>
PLANAR_HD void smooth(const T (&q)[M::NV], const T (&v)[M::NV],
                      const T (&u)[M::NU], Kinematics<T, M>& kin,
                      T (&m)[M::NV][M::NV], T (&qfrc)[M::NV]) {
  constexpr int NV = M::NV, NB = M::NB;
  const T zero = T(0);
  Motion<T, M> mo;
  kinematics<T, M>(q, v, kin, mo);
  const T (&sw)[NV] = kin.sw;
  const T (&sx)[NV] = kin.sx;
  const T (&sy)[NV] = kin.sy;

  // ---- mass matrix (upper triangle) + armature ------------------------------
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) {
    PLANAR_UNROLL
    for (int e = d; e < NV; ++e) {
      T acc = zero;
      PLANAR_UNROLL
      for (int b = 0; b < NB; ++b) {
        if (M::chain(b, d) && M::chain(b, e)) {
          T n, fx, fy;
          apply_inertia(T(M::mass(b)), T(M::izz(b)), mo.comx[b], mo.comy[b],
                        sw[e], sx[e], sy[e], n, fx, fy);
          acc = acc + sw[d] * n + (sx[d] * fx + sy[d] * fy);
        }
      }
      m[d][e] = acc + (d == e ? T(M::armature(d)) : zero);
    }
  }

  // ---- bias: f_b = I avp + v x* (I v), fluid, gravity -----------------------
  T bias[NV];
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) bias[d] = zero;
  PLANAR_UNROLL
  for (int b = 0; b < NB; ++b) {
    T aw = zero, aux = zero, auy = zero;
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      if (M::chain(b, d)) {
        aw = aw + zero * v[d];
        aux = aux + mo.sdx[d] * v[d];
        auy = auy + mo.sdy[d] * v[d];
      }
    }
    T n_tot, ftx, fty;
    body_force<T, M>(body_const<T, M>(b), kin.cph[b], kin.sph[b], mo.comx[b],
                     mo.comy[b], mo.velw[b], mo.velx[b], mo.vely[b], aw, aux,
                     auy, n_tot, ftx, fty);
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      if (M::chain(b, d)) {
        bias[d] = bias[d] + sw[d] * n_tot + (sx[d] * ftx + sy[d] * fty);
      }
    }
  }
  applied<T, M>(q, v, u, bias, qfrc);
}

// Sum of x over the L lanes of this lane's group, with the same bits on
// every lane (xor butterfly: lane l adds x_l + x_{l^o}, its partner
// x_{l^o} + x_l).  Every lane of the warp must call it: no data-dependent
// branch may hold a call.  The host build runs L = 1, where it is x; the
// host harness planar_host_lanes.cpp runs the lanes as fibers and does the
// same butterfly through memory.
template <int L, typename T>
PLANAR_HD T group_sum(T x) {
#if defined(__CUDA_ARCH__)
  PLANAR_UNROLL
  for (int o = L / 2; o > 0; o >>= 1) {
    x = x + __shfl_xor_sync(0xffffffffu, x, o);
  }
#elif defined(PLANAR_HOST_LANES)
  x = planar_host_lanes::exchange_sum<L>(x);
#endif
  return x;
}

// ===========================================================================
// K1: the smooth kernel's substep
// ===========================================================================

// Lower Cholesky factor of the symmetric matrix held in the upper triangle
// of m (m[d][e], d <= e), pivots floored at 1e-12, and the reciprocals of
// its diagonal: one division per pivot, where the plain version divides by
// the pivot again in every row of the factor and of each solve.
template <typename T, int NV>
PLANAR_HD void cholesky(const T (&m)[NV][NV], T (&low)[NV][NV],
                        T (&ilow)[NV]) {
  PLANAR_UNROLL
  for (int j = 0; j < NV; ++j) {
    PLANAR_UNROLL
    for (int i = j; i < NV; ++i) {
      T s = m[j][i];
      PLANAR_UNROLL
      for (int k = 0; k < j; ++k) s = s - low[i][k] * low[j][k];
      if (i == j) {
        low[j][j] = sqrt_(clamp_min(s, T(1e-12)));
        ilow[j] = T(1) / low[j][j];
      } else {
        low[i][j] = s * ilow[j];
      }
    }
  }
}

// out = (low low^T)^-1 rhs, where rows of rhs before `first` are exact
// zeros (the forward pass starts there) and only rows >= `last` of out are
// wanted (the back-substitution stops there; the rows below are not set).
// Skipping a product with an exact zero changes no bit of a finite result.
// first and last are constants once the call is inlined and unrolled.
template <typename T, int NV>
PLANAR_HD void chol_solve(const T (&low)[NV][NV], const T (&ilow)[NV],
                          const T (&rhs)[NV], T (&out)[NV], int first,
                          int last) {
  T y[NV];
  PLANAR_UNROLL
  for (int i = 0; i < NV; ++i) {
    if (i < first) {
      y[i] = T(0);
      continue;
    }
    T s = rhs[i];
    PLANAR_UNROLL
    for (int k = 0; k < i; ++k) {
      if (k >= first) s = s - low[i][k] * y[k];
    }
    y[i] = s * ilow[i];
  }
  // the back-substitution sums the newest row (i + 1) last, as the
  // forward pass does, so that one multiply-add per row waits for it
  PLANAR_UNROLL
  for (int i = NV - 1; i >= 0; --i) {
    if (i < last) break;
    T s = y[i];
    PLANAR_UNROLL
    for (int k = NV - 1; k > i; --k) s = s - low[k][i] * out[k];
    out[i] = s * ilow[i];
  }
}

// Work split over the lanes of a group: items 0..N-1 go round robin, item k
// to lane k % L in its slot k / L.  choose() gives this lane the value f(k)
// of its item k = s L + lane in slot s (lane 0's item where that lies past
// N): at L = 1, f(s) with s a constant after unrolling; at L > 1, a chain of
// selects over the slot's candidates, so every lane of the group runs the
// same instructions on its own item's values.  f must be cheap: it is
// evaluated for every candidate.
template <int L, int N, typename F>
PLANAR_HD auto choose(int s, int lane, F f) -> decltype(f(0)) {
  auto r = f(s * L);
  PLANAR_UNROLL
  for (int j = 1; j < L; ++j) {
    if (s * L + j < N) {
      const auto c = f(s * L + j);
      r = lane == j ? c : r;
    }
  }
  return r;
}

// The value that the owner of item k (lane k % L) holds in x, on every lane
// of the group with the owner's bits: a group sum to which the other lanes
// add exact zeros.
template <int L, typename T>
PLANAR_HD T from_owner(int k, int lane, T x) {
  return group_sum<L>(L == 1 || lane == k % L ? x : T(0));
}

// What choose() picks per mass-matrix entry (d, e): the two motion axes,
// the bodies both drive (a bit mask) and the armature on the diagonal.
template <typename T>
struct Entry {
  T swd, sxd, syd, swe, sxe, sye, arm;
  unsigned bodies;
};

// What choose() picks per body: its rotation, world CoM, velocity and the
// dofs that drive it (a bit mask).
template <typename T>
struct BodyState {
  T c, s, cx, cy, w, ux, uy;
  unsigned dofs;
};

// One semi-implicit Euler substep of a SMOOTH chain (no contacts), in place
// on q[NV], v[NV]; u[NU] is the (unclipped) control; this lane is `lane` of
// a group of L that step the same environment.  Split over the lanes: the
// mass-matrix entries, the bodies' forces (fluid included), and the solves
// for a0 and the columns of M^-1 at the limited dofs.  Every lane runs the
// rest (FK, Cholesky, the limit dual's Gauss-Seidel sweeps, the final solve)
// on the same values, so every lane ends with the same bits.
template <typename T, typename M, int L>
PLANAR_HD void substep(T (&q)[M::NV], T (&v)[M::NV], const T (&u)[M::NU],
                       int lane) {
  static_assert(L >= 1 && 32 % L == 0, "L must divide 32");
  constexpr int NV = M::NV, NB = M::NB, NL = M::NL;
  constexpr int NP = NV * (NV + 1) / 2;
  const T zero = T(0), one = T(1);
  Kinematics<T, M> kin;
  Motion<T, M> mo;
  kinematics<T, M>(q, v, kin, mo);
  const T (&sw)[NV] = kin.sw;
  const T (&sx)[NV] = kin.sx;
  const T (&sy)[NV] = kin.sy;

  // ---- mass matrix (upper triangle) + armature: entry k on lane k % L -------
  T m[NV][NV];
  {
    constexpr int S = (NP + L - 1) / L;
    T mine[S];
    PLANAR_UNROLL
    for (int s = 0; s < S; ++s) {
      const Entry<T> en = choose<L, NP>(s, lane, [&](int k) {
        const int d = M::pair_row(k), e = M::pair_col(k);
        unsigned bodies = 0;
        PLANAR_UNROLL
        for (int b = 0; b < NB; ++b) {
          if (M::chain(b, d) && M::chain(b, e)) bodies |= 1u << b;
        }
        return Entry<T>{sw[d], sx[d], sy[d], sw[e], sx[e], sy[e],
                        d == e ? T(M::armature(d)) : zero, bodies};
      });
      T acc = zero;
      PLANAR_UNROLL
      for (int b = 0; b < NB; ++b) {
        T n, fx, fy;
        apply_inertia(T(M::mass(b)), T(M::izz(b)), mo.comx[b], mo.comy[b],
                      en.swe, en.sxe, en.sye, n, fx, fy);
        const T sum = acc + en.swd * n + (en.sxd * fx + en.syd * fy);
        acc = (en.bodies >> b) & 1u ? sum : acc;
      }
      mine[s] = acc + en.arm;
    }
    PLANAR_UNROLL
    for (int k = 0; k < NP; ++k) {
      m[M::pair_row(k)][M::pair_col(k)] = from_owner<L>(k, lane, mine[k / L]);
    }
  }

  // ---- bias: body b on lane b % L, summed per dof over the group ------------
  T bias[NV];
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) bias[d] = zero;
  PLANAR_UNROLL
  for (int s = 0; s < (NB + L - 1) / L; ++s) {
    const bool valid = s * L + lane < NB;
    const BodyState<T> bs = choose<L, NB>(s, lane, [&](int b) {
      unsigned dofs = 0;
      PLANAR_UNROLL
      for (int d = 0; d < NV; ++d) {
        if (M::chain(b, d)) dofs |= 1u << d;
      }
      return BodyState<T>{kin.cph[b], kin.sph[b], mo.comx[b], mo.comy[b],
                          mo.velw[b], mo.velx[b], mo.vely[b], dofs};
    });
    const BodyConst<T> bc = choose<L, NB>(
        s, lane, [&](int b) { return body_const<T, M>(b); });
    // avp: the rotation part of every cdofdot is an exact zero, so its
    // sum is zero and is not formed
    T aux = zero, auy = zero;
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      const bool on = (bs.dofs >> d) & 1u;
      const T ax = aux + mo.sdx[d] * v[d], ay = auy + mo.sdy[d] * v[d];
      aux = on ? ax : aux;
      auy = on ? ay : auy;
    }
    T n_tot, ftx, fty;
    body_force<T, M>(bc, bs.c, bs.s, bs.cx, bs.cy, bs.w, bs.ux, bs.uy, zero,
                     aux, auy, n_tot, ftx, fty);
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      const T add = bias[d] + sw[d] * n_tot + (sx[d] * ftx + sy[d] * fty);
      bias[d] = valid && ((bs.dofs >> d) & 1u) ? add : bias[d];
    }
  }
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) bias[d] = group_sum<L>(bias[d]);

  T qfrc[NV];
  applied<T, M>(q, v, u, bias, qfrc);

  T low[NV][NV], ilow[NV];
  cholesky<T, NV>(m, low, ilow);

  // ---- implicit joint limits: soft-constraint dual over the limited dofs,
  //      projected Gauss-Seidel -------------------------------------------------
  if (NL > 0) {
    constexpr int NLA = NL > 0 ? NL : 1;
    T sign[NLA], aref[NLA], active[NLA], reg[NLA];
    PLANAR_UNROLL
    for (int i = 0; i < NL; ++i) {
      const int d = M::lim_dof(i);
      const T lo = T(M::lim_lo(i)), hi = T(M::lim_hi(i));
      const T below = clamp_min(lo - q[d], zero);
      const T above = clamp_min(q[d] - hi, zero);
      const bool use_lower = below >= above;
      const T sg = use_lower ? one : -one;
      const T dist = use_lower ? q[d] - lo : hi - q[d];
      active[i] = (below > zero || above > zero) ? one : zero;
      const T imp = impedance_k1<T, M>(i, clamp_min(-dist, zero));
      aref[i] = T(-M::limit_b(i)) * sg * v[d] - T(M::limit_k(i)) * imp * dist;
      reg[i] = clamp_min((one - imp) / imp * T(M::invweight0(i)), T(1e-12));
      sign[i] = sg;
    }
    // item 0: a0 = M^-1 qfrc; item 1 + j: the column of M^-1 at limited dof
    // j; item k on lane k % L, of each only the rows at the limited dofs
    constexpr int NI = NL + 1;
    constexpr int SI = (NI + L - 1) / L;
    T got[SI][NLA];
    PLANAR_UNROLL
    for (int s = 0; s < SI; ++s) {
      T rhs[NV], out[NV];
      PLANAR_UNROLL
      for (int e = 0; e < NV; ++e) {
        rhs[e] = choose<L, NI>(s, lane, [&](int k) {
          return k == 0 ? qfrc[e] : (e == M::lim_dof(k - 1) ? one : zero);
        });
      }
      // a unit column's forward pass starts at its unit entry where the
      // item is a constant (L = 1)
      const int first = L == 1 && s > 0 ? M::lim_dof(s - 1) : 0;
      chol_solve<T, NV>(low, ilow, rhs, out, first, M::LIM_DOF_MIN);
      PLANAR_UNROLL
      for (int i = 0; i < NL; ++i) got[s][i] = out[M::lim_dof(i)];
    }
    T a0l[NLA], col[NLA][NLA];     // col[j][i] = (M^-1)[lim i][lim j]
    PLANAR_UNROLL
    for (int i = 0; i < NL; ++i) {
      a0l[i] = from_owner<L>(0, lane, got[0][i]);
      PLANAR_UNROLL
      for (int j = 0; j < NL; ++j) {
        col[j][i] = from_owner<L>(j + 1, lane, got[(j + 1) / L][i]);
      }
    }
    T amat[NLA][NLA], bvec[NLA], lam[NLA], rinv[NLA];
    PLANAR_UNROLL
    for (int i = 0; i < NL; ++i) {
      PLANAR_UNROLL
      for (int j = 0; j < NL; ++j) amat[i][j] = sign[i] * sign[j] * col[j][i];
      bvec[i] = aref[i] - sign[i] * a0l[i];
      lam[i] = zero;
    }
    // the Gauss-Seidel divisor of each row, taken once for all sweeps
    PLANAR_UNROLL
    for (int i = 0; i < NL; ++i) rinv[i] = one / (amat[i][i] + reg[i]);
    // The sweeps are one dependent chain, each row's impulse waiting for the
    // previous row's.  So the residual g is summed with that newest impulse
    // (row p) last: the other terms are ready before it, and one
    // multiply-add, the step and the projection are left on the chain.  An
    // inactive row's impulse is multiplied by zero, as in the plain version.
    PLANAR_UNROLL
    for (int sweep = 0; sweep < M::PGS_SWEEPS; ++sweep) {
      PLANAR_UNROLL
      for (int i = 0; i < NL; ++i) {
        const int p = (i + NL - 1) % NL;
        T g = zero;
        PLANAR_UNROLL
        for (int j = 0; j < NL; ++j) {
          if (j != p) g = g + amat[i][j] * lam[j];
        }
        g = g + reg[i] * lam[i] - bvec[i];
        g = g + amat[i][p] * lam[p];
        lam[i] = active[i] * clamp_min(lam[i] - g * rinv[i], zero);
      }
    }
    PLANAR_UNROLL
    for (int i = 0; i < NL; ++i) {
      qfrc[M::lim_dof(i)] = qfrc[M::lim_dof(i)] + sign[i] * lam[i];
    }
  }

  // ---- integrate with implicit joint damping: (M + h diag(B)) qacc = qfrc --
  if (M::HAS_DAMPING) {
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      m[d][d] = m[d][d] + T(M::H * M::damping(d));
    }
    cholesky<T, NV>(m, low, ilow);
  }
  T qacc[NV];
  chol_solve<T, NV>(low, ilow, qfrc, qacc, 0, 0);
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) {
    v[d] = v[d] + T(M::H) * qacc[d];
    q[d] = q[d] + T(M::H) * v[d];
  }
}

}  // namespace planar
