// Per-environment body of the planar whole-control-step kernel.
//
// One call of planar::substep<T, M> advances ONE environment of a smooth
// chain by one semi-implicit Euler physics step; planar::smooth<T, M>, its
// first half, is shared with the contact kernel (planar_contact.cuh).
// The step: planar FK, composite-rigid-body mass
// matrix + armature, Coriolis bias via cdofdot, MuJoCo inertia-box fluid
// force, gravity / joint springs / damping, clipped gear actuation, an
// unrolled Cholesky factorization, the implicit joint-limit dual over the
// limited dofs (solimp impedance, projected Gauss-Seidel) and the solve
// with M + h diag(damping).  It repeats, operation for operation and in the
// same association order, mjrl_tpu_torch/physics/planar.py::planar_substep,
// which is the plain version it is tested against.
//
// T is float or double.  M is a model-traits struct (generated from
// PlanarParams by mjrl_tpu_torch/ops/cuda_planar.py::emit_model_header)
// whose sizes and tables are constexpr, so that after full unrolling every
// index and every structural branch (which dof drives which body, which
// dofs are limited) is a compile-time constant and all state lives in
// registers.  The file has no CUDA-only construct outside the PLANAR_HD
// macro, so g++ compiles it for the host test harness (planar_host.cpp).
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

// planar reduction of the inertia-box fluid force on body b, about the
// world origin -> (n_z, f)
template <typename T, typename M>
PLANAR_HD void fluid(int b, T c, T s, T cx, T cy, T w, T ux, T uy,
                     T& nz, T& fwx, T& fwy) {
  const T pcx = -cy, pcy = cx;
  const T vx = ux + w * pcx;
  const T vy = uy + w * pcy;
  const T vrx = c * vx + s * vy;
  const T vry = -s * vx + c * vy;
  T f_l[3], t_l[3];
  PLANAR_UNROLL
  for (int i = 0; i < 3; ++i) {
    const T v_l = T(M::r0(b, 0, i)) * vrx + T(M::r0(b, 1, i)) * vry;
    const T w_l = T(M::r0(b, 2, i)) * w;
    f_l[i] = T(M::fluid_cv(b)) * v_l - T(M::fluid_qf(b, i)) * abs_(v_l) * v_l;
    t_l[i] = T(M::fluid_cw(b)) * w_l - T(M::fluid_qt(b, i)) * abs_(w_l) * w_l;
  }
  T fr[2];
  PLANAR_UNROLL
  for (int i = 0; i < 2; ++i) {
    T acc = T(0);
    PLANAR_UNROLL
    for (int k = 0; k < 3; ++k) acc = acc + T(M::r0(b, i, k)) * f_l[k];
    fr[i] = acc;
  }
  T tr2 = T(0);
  PLANAR_UNROLL
  for (int k = 0; k < 3; ++k) tr2 = tr2 + T(M::r0(b, 2, k)) * t_l[k];
  fwx = c * fr[0] - s * fr[1];
  fwy = s * fr[0] + c * fr[1];
  nz = tr2 + (cx * fwy - cy * fwx);
}

// lower Cholesky factor of the symmetric matrix held in the upper
// triangle of m (m[d][e], d <= e); pivots floored at 1e-12
template <typename T, int NV>
PLANAR_HD void cholesky(const T (&m)[NV][NV], T (&low)[NV][NV]) {
  PLANAR_UNROLL
  for (int j = 0; j < NV; ++j) {
    PLANAR_UNROLL
    for (int i = j; i < NV; ++i) {
      T s = m[j][i];
      PLANAR_UNROLL
      for (int k = 0; k < j; ++k) s = s - low[i][k] * low[j][k];
      if (i == j) {
        low[j][j] = sqrt_(clamp_min(s, T(1e-12)));
      } else {
        low[i][j] = s / low[j][j];
      }
    }
  }
}

template <typename T, int NV>
PLANAR_HD void chol_solve(const T (&low)[NV][NV], const T (&rhs)[NV],
                          T (&out)[NV]) {
  T y[NV];
  PLANAR_UNROLL
  for (int i = 0; i < NV; ++i) {
    T s = rhs[i];
    PLANAR_UNROLL
    for (int k = 0; k < i; ++k) s = s - low[i][k] * y[k];
    y[i] = s / low[i][i];
  }
  PLANAR_UNROLL
  for (int i = NV - 1; i >= 0; --i) {
    T s = y[i];
    PLANAR_UNROLL
    for (int k = i + 1; k < NV; ++k) s = s - low[k][i] * out[k];
    out[i] = s / low[i][i];
  }
}

// What the constraint code needs of the kinematics: body rotations and
// origins, and the per-dof motion axes (omega, u).
template <typename T, typename M>
struct Kinematics {
  T cph[M::NB], sph[M::NB], orgx[M::NB], orgy[M::NB];
  T sw[M::NV], sx[M::NV], sy[M::NV];
};

// Smooth dynamics at (q, v) under the (unclipped) control u: the mass
// matrix (upper triangle of m, armature included) and the constraint-free
// applied force qfrc = actuation + damping + springs - bias; kin receives
// the kinematics.
template <typename T, typename M>
PLANAR_HD void smooth(const T (&q)[M::NV], const T (&v)[M::NV],
                      const T (&u)[M::NU], Kinematics<T, M>& kin,
                      T (&m)[M::NV][M::NV], T (&qfrc)[M::NV]) {
  constexpr int NV = M::NV, NB = M::NB, NU = M::NU;
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
  T comx[NB], comy[NB];
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
    comx[b] = orgx[b] + cph[b] * cx - sph[b] * cy;
    comy[b] = orgy[b] + sph[b] * cx + cph[b] * cy;
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
  T velw[NB], velx[NB], vely[NB], sdx[NV], sdy[NV];
  sdx[0] = sdx[1] = sdy[0] = sdy[1] = zero;
  const T rootx = v[0] * T(M::slide_dir(0, 0)) + v[1] * T(M::slide_dir(1, 0));
  const T rooty = v[0] * T(M::slide_dir(0, 1)) + v[1] * T(M::slide_dir(1, 1));
  PLANAR_UNROLL
  for (int b = 0; b < NB; ++b) {
    const int d = M::body_dof(b);
    const int pb = M::parent(b);
    const T w_c = pb < 0 ? zero : velw[pb < 0 ? 0 : pb];
    const T ux_c = pb < 0 ? rootx : velx[pb < 0 ? 0 : pb];
    const T uy_c = pb < 0 ? rooty : vely[pb < 0 ? 0 : pb];
    sdx[d] = w_c * -sy[d] - sw[d] * -uy_c;
    sdy[d] = w_c * sx[d] - sw[d] * ux_c;
    velw[b] = w_c + sw[d] * v[d];
    velx[b] = ux_c + sx[d] * v[d];
    vely[b] = uy_c + sy[d] * v[d];
  }

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
          apply_inertia(T(M::mass(b)), T(M::izz(b)), comx[b], comy[b],
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
        aux = aux + sdx[d] * v[d];
        auy = auy + sdy[d] * v[d];
      }
    }
    T n1, f1x, f1y, nh, fhx, fhy;
    apply_inertia(T(M::mass(b)), T(M::izz(b)), comx[b], comy[b],
                  aw, aux, auy, n1, f1x, f1y);
    apply_inertia(T(M::mass(b)), T(M::izz(b)), comx[b], comy[b],
                  velw[b], velx[b], vely[b], nh, fhx, fhy);
    const T n2 = velx[b] * fhy - vely[b] * fhx;
    const T f2x = velw[b] * -fhy, f2y = velw[b] * fhx;
    T n_tot = n1 + n2;
    T ftx = f1x + f2x, fty = f1y + f2y;
    if (M::HAS_FLUID) {
      T nf, ffx, ffy;
      fluid<T, M>(b, cph[b], sph[b], comx[b], comy[b],
                  velw[b], velx[b], vely[b], nf, ffx, ffy);
      n_tot = n_tot - nf;
      ftx = ftx - ffx;
      fty = fty - ffy;
    }
    if (M::HAS_GRAVITY) {
      const T fgx = T(M::mass(b) * M::gravity(0));
      const T fgy = T(M::mass(b) * M::gravity(1));
      n_tot = n_tot - (comx[b] * fgy - comy[b] * fgx);
      ftx = ftx - fgx;
      fty = fty - fgy;
    }
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      if (M::chain(b, d)) {
        bias[d] = bias[d] + sw[d] * n_tot + (sx[d] * ftx + sy[d] * fty);
      }
    }
  }

  // ---- applied forces: damping, springs, clipped gear actuation --------------
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) {
    qfrc[d] = T(-M::damping(d)) * v[d] - bias[d];
    if (M::HAS_SPRINGS && M::stiffness(d) != 0.0) {
      qfrc[d] = qfrc[d] - T(M::stiffness(d)) * (q[d] - T(M::spring_ref(d)));
    }
  }
  PLANAR_UNROLL
  for (int i = 0; i < NU; ++i) {
    const T c = M::ctrl_limited(i)
        ? clamp(u[i], T(M::ctrl_lo(i)), T(M::ctrl_hi(i))) : u[i];
    qfrc[M::act_dof(i)] = qfrc[M::act_dof(i)] + T(M::gear(i)) * c;
  }
}

// One semi-implicit Euler substep of a SMOOTH chain (no contacts), in place
// on q[NV], v[NV]; u[NU] is the (unclipped) control.
template <typename T, typename M>
PLANAR_HD void substep(T (&q)[M::NV], T (&v)[M::NV], const T (&u)[M::NU]) {
  constexpr int NV = M::NV, NL = M::NL;
  const T zero = T(0), one = T(1);
  Kinematics<T, M> kin;
  T m[NV][NV], qfrc[NV];
  smooth<T, M>(q, v, u, kin, m, qfrc);

  T low[NV][NV];
  cholesky<T, NV>(m, low);

  // ---- implicit joint limits: soft-constraint dual over the limited dofs,
  //      projected Gauss-Seidel -------------------------------------------------
  if (NL > 0) {
    constexpr int NLA = NL > 0 ? NL : 1;
    T a0[NV];
    chol_solve<T, NV>(low, qfrc, a0);
    T sign[NLA], aref[NLA], active[NLA], reg[NLA], minv[NLA][NV];
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
      const T imp = impedance<T, M>(i, clamp_min(-dist, zero));
      aref[i] = T(-M::limit_b(i)) * sg * v[d] - T(M::limit_k(i)) * imp * dist;
      reg[i] = clamp_min((one - imp) / imp * T(M::invweight0(i)), T(1e-12));
      sign[i] = sg;
      T e_d[NV];
      PLANAR_UNROLL
      for (int e = 0; e < NV; ++e) e_d[e] = e == d ? one : zero;
      chol_solve<T, NV>(low, e_d, minv[i]);
    }
    T amat[NLA][NLA], bvec[NLA], lam[NLA];
    PLANAR_UNROLL
    for (int i = 0; i < NL; ++i) {
      PLANAR_UNROLL
      for (int j = 0; j < NL; ++j) {
        amat[i][j] = sign[i] * sign[j] * minv[j][M::lim_dof(i)];
      }
      bvec[i] = aref[i] - sign[i] * a0[M::lim_dof(i)];
      lam[i] = zero;
    }
    PLANAR_UNROLL
    for (int sweep = 0; sweep < M::PGS_SWEEPS; ++sweep) {
      PLANAR_UNROLL
      for (int i = 0; i < NL; ++i) {
        T g = zero;
        PLANAR_UNROLL
        for (int j = 0; j < NL; ++j) g = g + amat[i][j] * lam[j];
        g = g + reg[i] * lam[i] - bvec[i];
        lam[i] = active[i]
            * clamp_min(lam[i] - g / (amat[i][i] + reg[i]), zero);
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
    cholesky<T, NV>(m, low);
  }
  T qacc[NV];
  chol_solve<T, NV>(low, qfrc, qacc);
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) {
    v[d] = v[d] + T(M::H) * qacc[d];
    q[d] = q[d] + T(M::H) * v[d];
  }
}

}  // namespace planar
