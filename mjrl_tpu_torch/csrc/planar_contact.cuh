// Per-environment body of the planar contact / RK4 control-step kernel.
//
// planar::contact_step_n<T, M> advances ONE environment of a planar tree
// with ground contacts by one control step (n substeps).  Per substep
// (Euler) or per Runge-Kutta stage (RK4) it evaluates the constrained
// acceleration (contact_qacc): smooth dynamics (planar_body.cuh), a
// Cholesky factor of M, the constraint rows — one signed row per limited
// dof; per contact (plane-sphere, capsule end cap, capsule-capsule) one
// frictionless normal, 4 pyramidal facets or an elliptic [n, t1, t2]
// triple — and the regularized dual, solved by diagonally preconditioned
// accelerated projected gradient descent: 8 power iterations for the
// Lipschitz bound, adaptive restart, the closed-form second-order-cone
// projection for elliptic triples, a FIXED number of sweeps (50 for the
// first solve of the control step, 15 for the later ones, which start from
// the previous impulses).  Euler then integrates smooth + constraint force
// with M + h diag(damping); RK4 combines the four stage accelerations.
//
// It repeats the arithmetic of the plain PyTorch version,
// mjrl_tpu_torch/physics/planar.py::planar_contact_step_n (every guard and
// floor to the letter, inactive rows multiplied by `active` rather than
// skipped, every select a select, no early exit), with two exceptions: sums
// over rows and dofs are taken left to right where the plain version calls
// torch.sum; and where the plain version divides many values by the same
// quantity (a row's scale ds, a Cholesky pivot, a norm, the Lipschitz
// bound), this file takes the correctly rounded reciprocal once and
// multiplies, which moves a quotient by at most one unit in the last place.
//
// T is float or double; M is the generated model-traits struct.  Model
// structure (which dof drives which body, which contact owns which rows) is
// compile-time and unrolled; the solver's sweeps, the power iterations and
// the stages are run-time loops around ONE copy of the solve, and the
// per-row working set (rows, M^-1 J^T, scales: about 2 C nv + 8 C scalars)
// lives in thread-local arrays.  No CUDA-only construct outside the
// PLANAR_HD / PLANAR_UNROLL macros: g++ compiles it for the host harness.
#pragma once

#include "planar_body.cuh"

namespace planar {

// lower Cholesky factor of the symmetric matrix held in the upper triangle
// of m; pivots floored at 1e-10 |m_ii| + 1e-30.  ilow holds the reciprocals
// of the factor's diagonal: this file divides once per pivot and multiplies
// by the reciprocal wherever the plain version divides by the pivot again
// (see the note on divisions in planar_contact_step.cu).
template <typename T, int NV>
PLANAR_HD void cholesky_rel(const T (&m)[NV][NV], T (&low)[NV][NV],
                            T (&ilow)[NV]) {
  PLANAR_UNROLL
  for (int i = 0; i < NV; ++i) {
    PLANAR_UNROLL
    for (int j = 0; j <= i; ++j) {
      T s = m[j][i];
      PLANAR_UNROLL
      for (int k = 0; k < j; ++k) s = s - low[i][k] * low[j][k];
      if (i == j) {
        const T floor = T(1e-10) * abs_(m[i][i]) + T(1e-30);
        low[i][i] = sqrt_(s < floor ? floor : s);
        ilow[i] = T(1) / low[i][i];
      } else {
        low[i][j] = s * ilow[j];
      }
    }
  }
}

template <typename T, int NV>
PLANAR_HD void chol_solve_rel(const T (&low)[NV][NV], const T (&ilow)[NV],
                              const T (&rhs)[NV], T (&out)[NV]) {
  T y[NV];
  PLANAR_UNROLL
  for (int i = 0; i < NV; ++i) {
    T s = rhs[i];
    PLANAR_UNROLL
    for (int k = 0; k < i; ++k) s = s - low[i][k] * y[k];
    y[i] = s * ilow[i];
  }
  PLANAR_UNROLL
  for (int i = NV - 1; i >= 0; --i) {
    T s = y[i];
    PLANAR_UNROLL
    for (int k = i + 1; k < NV; ++k) s = s - low[k][i] * out[k];
    out[i] = s * ilow[i];
  }
}

// MuJoCo solimp impedance ramp with constant (d0, dw, width, mid, power),
// width and mid already floored / clamped, at a violation >= 0
template <typename T>
PLANAR_HD T impedance_c(double d0, double dw, double width, double mid,
                        double power, T violation) {
  const T x = clamp(violation / T(width), T(0), T(1));
  const T y_lo = T(mid) * pow_(x / T(mid), T(power));
  const T y_hi = T(1) - T(1.0 - mid)
      * pow_((T(1) - x) / T(1.0 - mid), T(power));
  const T y = x < T(mid) ? y_lo : y_hi;
  return clamp(T(d0) + y * T(dw - d0), T(1e-4), T(1.0 - 1e-4));
}

// closest points between 2D segments a0-a1 and b0-b1 -> c1, c2, distance
template <typename T>
PLANAR_HD void seg_closest(T a0x, T a0y, T a1x, T a1y, T b0x, T b0y, T b1x,
                           T b1y, T& c1x, T& c1y, T& c2x, T& c2y, T& dist) {
  const T d1x = a1x - a0x, d1y = a1y - a0y;
  const T d2x = b1x - b0x, d2y = b1y - b0y;
  const T rx = a0x - b0x, ry = a0y - b0y;
  const T a = (d1x * d1x + d1y * d1y) + T(1e-12);
  const T e = (d2x * d2x + d2y * d2y) + T(1e-12);
  const T f = d2x * rx + d2y * ry;
  const T c = d1x * rx + d1y * ry;
  const T b = d1x * d2x + d1y * d2y;
  const T denom = a * e - b * b;
  const bool ok = abs_(denom) > T(1e-12);
  T s = ok ? clamp((b * f - c * e) / (ok ? denom : T(1)), T(0), T(1)) : T(0);
  const T t = clamp((b * s + f) / e, T(0), T(1));
  s = clamp((b * t - c) / a, T(0), T(1));
  c1x = a0x + d1x * s;
  c1y = a0y + d1y * s;
  c2x = b0x + d2x * t;
  c2y = b0y + d2y * t;
  const T dx = c2x - c1x, dy = c2y - c1y;
  dist = sqrt_((dx * dx + dy * dy) + T(1e-18));
}

// The dual problem of one acceleration evaluation: rows J, M^-1 J^T, the
// reference accelerations, regularizers, active flags and scales.
template <typename T, typename M>
struct Dual {
  static constexpr int C = M::NROWS > 0 ? M::NROWS : 1;
  static constexpr int K = M::NTRI > 0 ? M::NTRI : 1;
  T rows[C][M::NV], minv[C][M::NV];
  T aref[C], reg[C], active[C], ds[C], ids[C], rhs[C];   // ids = 1 / ds
  T mu_g[K];
};

// velocity of the material point (pcx, pcy) of body b along (dirx, diry),
// per dof: the Jacobian row of that point; dofs off the body's chain are 0
template <typename T, typename M>
PLANAR_HD void point_row(const Kinematics<T, M>& kin, int b, T pcx, T pcy,
                         T dirx, T diry, T (&out)[M::NV]) {
  PLANAR_UNROLL
  for (int d = 0; d < M::NV; ++d) {
    if (M::chain(b, d)) {
      const T vpx = kin.sx[d] - kin.sw[d] * pcy;
      const T vpy = kin.sy[d] + kin.sw[d] * pcx;
      out[d] = vpx * dirx + vpy * diry;
    } else {
      out[d] = T(0);
    }
  }
}

// store row r = jrow with its reference acceleration aref_pos - b (J v)
template <typename T, typename M>
PLANAR_HD void put_row(Dual<T, M>& w, int r, const T (&jrow)[M::NV],
                       const T (&v)[M::NV], T aref_pos, T brow, T act,
                       T reg) {
  T jv = T(0);
  PLANAR_UNROLL
  for (int d = 0; d < M::NV; ++d) {
    w.rows[r][d] = jrow[d];
    jv = d == 0 ? jrow[d] * v[d] : jv + jrow[d] * v[d];
  }
  w.aref[r] = aref_pos - brow * jv;
  w.active[r] = act;
  w.reg[r] = reg;
}

// rows of contact i (index over points, then capsule pairs) with normal
// Jacobian jn, tangent Jacobian jt and penetration depth
template <typename T, typename M>
PLANAR_HD void add_contact(Dual<T, M>& w, int i, const T (&jn)[M::NV],
                           const T (&jt)[M::NV], T depth,
                           const T (&v)[M::NV]) {
  constexpr int NV = M::NV;
  const T imp = impedance_c<T>(
      M::con_solimp(i, 0), M::con_solimp(i, 1), M::con_solimp(i, 2),
      M::con_solimp(i, 3), M::con_solimp(i, 4), clamp_min(depth, T(0)));
  const T act = depth > T(0) ? T(1) : T(0);
  const T aref = T(M::con_k(i)) * imp * depth;
  const T brow = T(M::con_b(i));
  if (M::con_condim(i) == 1) {
    const T reg = clamp_min((T(1) - imp) / imp * T(M::con_invweight(i)),
                            T(1e-12));
    put_row<T, M>(w, M::con_row(i), jn, v, aref, brow, act, reg);
  } else if (M::con_tri(i) >= 0) {
    // elliptic triple [n, t1, t2] in block order; t2, the out-of-plane
    // tangent, is a zero row kept for the shared tangent scale
    const T reg = clamp_min((T(1) - imp) / imp * T(M::con_invweight(i)),
                            T(1e-12));
    T zrow[NV];
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) zrow[d] = T(0);
    const int k = M::con_tri(i);
    put_row<T, M>(w, M::SOC_START + k, jn, v, aref, brow, act, reg);
    put_row<T, M>(w, M::SOC_START + M::NTRI + k, jt, v, T(0), brow, act,
                  reg);
    put_row<T, M>(w, M::SOC_START + 2 * M::NTRI + k, zrow, v, T(0), brow,
                  act, reg);
  } else {
    // 4 pyramidal facets; the out-of-plane pair degenerates to two
    // duplicate normal rows
    const T reg = clamp_min(
        (T(1) - imp) / imp * T(M::con_pyramid_weight(i)), T(1e-12));
    T jp[NV], jm[NV];
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      jp[d] = jn[d] + T(M::con_mu(i)) * jt[d];
      jm[d] = jn[d] - T(M::con_mu(i)) * jt[d];
    }
    const int r = M::con_row(i);
    put_row<T, M>(w, r, jn, v, aref, brow, act, reg);
    put_row<T, M>(w, r + 1, jn, v, aref, brow, act, reg);
    put_row<T, M>(w, r + 2, jp, v, aref, brow, act, reg);
    put_row<T, M>(w, r + 3, jm, v, aref, brow, act, reg);
  }
}

// all constraint rows at (q, v)
template <typename T, typename M>
PLANAR_HD void constraint_rows(const Kinematics<T, M>& kin,
                               const T (&q)[M::NV], const T (&v)[M::NV],
                               Dual<T, M>& w) {
  constexpr int NV = M::NV;
  const T zero = T(0), one = T(1);

  // scalar-dof limits: signed identity rows
  PLANAR_UNROLL
  for (int i = 0; i < M::NL; ++i) {
    const int d = M::lim_dof(i);
    const T lo = T(M::lim_lo(i)), hi = T(M::lim_hi(i));
    const T below = clamp_min(lo - q[d], zero);
    const T above = clamp_min(q[d] - hi, zero);
    const bool use_lower = below >= above;
    const T sg = use_lower ? one : -one;
    const T dist = use_lower ? q[d] - lo : hi - q[d];
    const T act = (below > zero || above > zero) ? one : zero;
    const T imp = impedance<T, M>(i, clamp_min(-dist, zero));
    T jrow[NV];
    PLANAR_UNROLL
    for (int e = 0; e < NV; ++e) jrow[e] = e == d ? sg : zero;
    put_row<T, M>(w, i, jrow, v, T(-M::limit_k(i)) * imp * dist,
                  T(M::limit_b(i)), act,
                  clamp_min((one - imp) / imp * T(M::invweight0(i)),
                            T(1e-12)));
  }

  // plane-sphere contacts and capsule end caps
  PLANAR_UNROLL
  for (int i = 0; i < M::NPT; ++i) {
    const int b = M::pt_body(i);
    const T c = kin.cph[b], s = kin.sph[b];
    const T lx = T(M::pt_local(i, 0)), ly = T(M::pt_local(i, 1));
    const T px = kin.orgx[b] + c * lx - s * ly;
    const T py = kin.orgy[b] + s * lx + c * ly;
    const T up0 = T(M::pt_up(i, 0)), up1 = T(M::pt_up(i, 1));
    const T r = T(M::pt_radius(i));
    const T d_up = up0 * px + up1 * py - T(M::pt_h0(i));
    const T depth = r - d_up;
    // contact point midway between the surfaces (MuJoCo convention)
    const T pcx = px - T(M::pt_up(i, 0) * 0.5) * (d_up + r);
    const T pcy = py - T(M::pt_up(i, 1) * 0.5) * (d_up + r);
    T jn[NV], jt[NV];
    point_row<T, M>(kin, b, pcx, pcy, up0, up1, jn);
    point_row<T, M>(kin, b, pcx, pcy, T(-M::pt_up(i, 1)), up0, jt);
    add_contact<T, M>(w, i, jn, jt, depth, v);
  }

  // capsule-capsule pairs (2D closest points of the axes)
  PLANAR_UNROLL
  for (int i = 0; i < M::NCC; ++i) {
    const int ba = M::cc_body(i, 0), bb = M::cc_body(i, 1);
    T ex[4], ey[4];
    PLANAR_UNROLL
    for (int k = 0; k < 4; ++k) {
      const int b = k < 2 ? ba : bb;
      const T c = kin.cph[b], s = kin.sph[b];
      const T lx = T(M::cc_end(i, k, 0)), ly = T(M::cc_end(i, k, 1));
      ex[k] = kin.orgx[b] + c * lx - s * ly;
      ey[k] = kin.orgy[b] + s * lx + c * ly;
    }
    T c1x, c1y, c2x, c2y, dist;
    seg_closest<T>(ex[0], ey[0], ex[1], ey[1], ex[2], ey[2], ex[3], ey[3],
                   c1x, c1y, c2x, c2y, dist);
    const T nx = (c2x - c1x) / dist, ny = (c2y - c1y) / dist;
    const T ra = T(M::cc_radius(i, 0)), rb = T(M::cc_radius(i, 1));
    const T depth = T(M::cc_radius(i, 0) + M::cc_radius(i, 1)) - dist;
    const T pcx = T(0.5) * (c1x + nx * ra + c2x - nx * rb);
    const T pcy = T(0.5) * (c1y + ny * ra + c2y - ny * rb);
    T jna[NV], jnb[NV], jta[NV], jtb[NV], jn[NV], jt[NV];
    point_row<T, M>(kin, bb, pcx, pcy, nx, ny, jnb);
    point_row<T, M>(kin, ba, pcx, pcy, nx, ny, jna);
    point_row<T, M>(kin, bb, pcx, pcy, -ny, nx, jtb);
    point_row<T, M>(kin, ba, pcx, pcy, -ny, nx, jta);
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      jn[d] = jnb[d] - jna[d];
      jt[d] = jtb[d] - jta[d];
    }
    add_contact<T, M>(w, M::NPT + i, jn, jt, depth, v);
  }
}

// out = D^-1/2 (J M^-1 J^T + R) D^-1/2 x, the preconditioned dual operator
template <typename T, typename M>
PLANAR_HD void dual_op(const Dual<T, M>& w, const T (&x)[Dual<T, M>::C],
                       T (&out)[Dual<T, M>::C]) {
  constexpr int NV = M::NV;
  T acc[NV];
  for (int r = 0; r < M::NROWS; ++r) {
    const T u = x[r] * w.ids[r];
    out[r] = u;
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      acc[d] = r == 0 ? w.minv[r][d] * u : acc[d] + w.minv[r][d] * u;
    }
  }
  for (int r = 0; r < M::NROWS; ++r) {
    T s = w.rows[r][0] * acc[0];
    PLANAR_UNROLL
    for (int d = 1; d < NV; ++d) s = s + w.rows[r][d] * acc[d];
    out[r] = (s + w.reg[r] * out[r]) * w.ids[r];
  }
}

// projection of the scaled iterate z onto the feasible set, in place:
// nonnegative clamp; elliptic triples onto their second-order cone
template <typename T, typename M>
PLANAR_HD void project(const Dual<T, M>& w, T (&z)[Dual<T, M>::C]) {
  for (int r = 0; r < M::NROWS; ++r) {
    const bool tri = r >= M::SOC_START && r < M::SOC_START + 3 * M::NTRI;
    if (!tri) z[r] = clamp_min(z[r], T(0)) * w.active[r];
  }
  for (int k = 0; k < M::NTRI; ++k) {
    const int rn = M::SOC_START + k, r1 = rn + M::NTRI, r2 = r1 + M::NTRI;
    const T n_i = z[rn], t1 = z[r1], t2 = z[r2];
    const T mg = w.mu_g[k];
    const T s = sqrt_(t1 * t1 + t2 * t2);
    const bool inside = s <= mg * n_i;
    const bool below = mg * s <= -n_i;
    const T c = (mg * s + n_i) / (T(1) + mg * mg);
    const T n_p = inside ? n_i : (below ? T(0) : c);
    const T tsc = inside ? T(1)
                         : (below ? T(0) : mg * c / clamp_min(s, T(1e-30)));
    z[rn] = n_p * w.active[rn];
    z[r1] = t1 * tsc * w.active[r1];
    z[r2] = t2 * tsc * w.active[r2];
  }
}

template <typename T, int C>
PLANAR_HD T norm_floored(const T (&x)[C], int n) {
  T s = T(0);
  for (int r = 0; r < n; ++r) s = r == 0 ? x[r] * x[r] : s + x[r] * x[r];
  return clamp_min(sqrt_(s), T(1e-12));
}

// Constrained acceleration at (q, v, u).  lam: impulses of the previous
// solve in, of this solve out.  Also hands back what the Euler integrator
// needs: the unconstrained acceleration a0, M and the smooth force.
template <typename T, typename M>
PLANAR_HD void contact_qacc(const T (&q)[M::NV], const T (&v)[M::NV],
                            const T (&u)[M::NU], T (&lam)[Dual<T, M>::C],
                            int sweeps, T (&qacc)[M::NV], T (&a0)[M::NV],
                            T (&m)[M::NV][M::NV], T (&qfrc)[M::NV]) {
  constexpr int NV = M::NV, C = M::NROWS, CA = Dual<T, M>::C;
  Kinematics<T, M> kin;
  smooth<T, M>(q, v, u, kin, m, qfrc);
  T low[NV][NV], ilow[NV];
  cholesky_rel<T, NV>(m, low, ilow);
  chol_solve_rel<T, NV>(low, ilow, qfrc, a0);

  Dual<T, M> w;
  constraint_rows<T, M>(kin, q, v, w);

  // columns of M^-1 J^T and the diagonal scales
  for (int r = 0; r < C; ++r) {
    chol_solve_rel<T, NV>(low, ilow, w.rows[r], w.minv[r]);
    T diag = w.rows[r][0] * w.minv[r][0];
    PLANAR_UNROLL
    for (int d = 1; d < NV; ++d) diag = diag + w.rows[r][d] * w.minv[r][d];
    w.ds[r] = sqrt_(clamp_min(diag + w.reg[r], T(1e-12)));
  }
  for (int k = 0; k < M::NTRI; ++k) {
    const int rn = M::SOC_START + k, r1 = rn + M::NTRI, r2 = r1 + M::NTRI;
    const T ds_t = sqrt_(w.ds[r1] * w.ds[r2]);
    w.ds[r1] = ds_t;
    w.ds[r2] = ds_t;
    w.mu_g[k] = T(M::tri_mu(k)) * ds_t / w.ds[rn];
  }
  for (int r = 0; r < C; ++r) w.ids[r] = T(1) / w.ds[r];

  // Lipschitz constant of the preconditioned dual by power iteration
  T x[CA], y[CA], g[CA];
  const T inrm = T(1) / norm_floored<T, CA>(w.active, C);
  for (int r = 0; r < C; ++r) x[r] = w.active[r] * inrm;
  T lmax = T(1);
  for (int it = 0; it < M::POWER_ITERS; ++it) {
    dual_op<T, M>(w, x, g);
    lmax = norm_floored<T, CA>(g, C);
    const T ilmax = T(1) / lmax;
    for (int r = 0; r < C; ++r) x[r] = g[r] * ilmax;
  }
  const T iel = T(1) / clamp_min(T(1.1) * lmax, T(1e-8));   // step 1 / L

  // x: mu, y: momentum iterate, both in the scaled space
  for (int r = 0; r < C; ++r) {
    T ja = w.rows[r][0] * a0[0];
    PLANAR_UNROLL
    for (int d = 1; d < NV; ++d) ja = ja + w.rows[r][d] * a0[d];
    w.rhs[r] = (w.aref[r] - ja) * w.ids[r];
    x[r] = lam[r] * w.active[r] * w.ds[r];
    y[r] = x[r];
  }
  T t = T(1);
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    dual_op<T, M>(w, y, g);
    for (int r = 0; r < C; ++r) g[r] = y[r] - (g[r] - w.rhs[r]) * iel;
    project<T, M>(w, g);                       // g = mu_new
    // adaptive restart: drop the momentum when it opposes descent
    T dot = T(0);
    for (int r = 0; r < C; ++r) {
      const T term = (y[r] - g[r]) * (g[r] - x[r]);
      dot = r == 0 ? term : dot + term;
    }
    const bool restart = dot > T(0);
    t = restart ? T(1) : t;
    const T t_new = T(0.5) * (T(1) + sqrt_(T(1) + T(4) * t * t));
    const T mom = restart ? T(0) : (t - T(1)) / t_new;
    for (int r = 0; r < C; ++r) {
      y[r] = g[r] + mom * (g[r] - x[r]);
      x[r] = g[r];
    }
    t = t_new;
  }

  T add[NV];
  for (int r = 0; r < C; ++r) {
    lam[r] = x[r] * w.ids[r];
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      add[d] = r == 0 ? w.minv[r][d] * lam[r]
                      : add[d] + w.minv[r][d] * lam[r];
    }
  }
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) qacc[d] = C > 0 ? a0[d] + add[d] : a0[d];
}

// One control step (n substeps), in place on q[NV], v[NV].
template <typename T, typename M>
PLANAR_HD void contact_step_n(T (&q)[M::NV], T (&v)[M::NV],
                              const T (&u)[M::NU], int n) {
  constexpr int NV = M::NV, CA = Dual<T, M>::C;
  const T h = T(M::H);
  T lam[CA];
  for (int r = 0; r < CA; ++r) lam[r] = T(0);
  T qacc[NV], a0[NV], m[NV][NV], qfrc[NV];

  if (!M::RK4) {
    for (int s = 0; s < n; ++s) {
      contact_qacc<T, M>(q, v, u, lam, s == 0 ? M::SWEEPS : M::SWEEPS_WARM,
                         qacc, a0, m, qfrc);
      // constraint force M (qacc - a0), then the implicit-damping solve
      T dqa[NV], rhs[NV];
      PLANAR_UNROLL
      for (int d = 0; d < NV; ++d) dqa[d] = qacc[d] - a0[d];
      PLANAR_UNROLL
      for (int d = 0; d < NV; ++d) {
        T fc = T(0);
        PLANAR_UNROLL
        for (int e = 0; e < NV; ++e) {
          const T mde = d <= e ? m[d][e] : m[e][d];
          fc = e == 0 ? mde * dqa[e] : fc + mde * dqa[e];
        }
        rhs[d] = qfrc[d] + fc;
      }
      PLANAR_UNROLL
      for (int d = 0; d < NV; ++d) {
        m[d][d] = m[d][d] + T(M::H * M::damping(d));
      }
      T low[NV][NV], ilow[NV];
      cholesky_rel<T, NV>(m, low, ilow);
      chol_solve_rel<T, NV>(low, ilow, rhs, qacc);
      PLANAR_UNROLL
      for (int d = 0; d < NV; ++d) {
        v[d] = v[d] + h * qacc[d];
        q[d] = q[d] + h * v[d];
      }
    }
    return;
  }

  // RK4: every stage of every substep goes through the one solve below.
  // stage 0 evaluates at (q, v); stage i > 0 at (q + c h kp, v + c h kv)
  // with (kp, kv) the previous stage's derivative, c = 1/2, 1/2, 1; the
  // combination (k1 + 2 k2 + 2 k3 + k4) h / 6 is accumulated as it goes.
  T sq[NV], sv[NV], accp[NV], accv[NV];
  for (int ev = 0; ev < 4 * n; ++ev) {
    const int stage = ev & 3;
    const T ch = stage == 3 ? T(M::H) : T(0.5 * M::H);
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      // (kp, kv) of the previous stage are (sv, qacc)
      const T nq = stage == 0 ? q[d] : q[d] + ch * sv[d];
      const T nv_ = stage == 0 ? v[d] : v[d] + ch * qacc[d];
      sq[d] = nq;
      sv[d] = nv_;
    }
    contact_qacc<T, M>(sq, sv, u, lam, ev == 0 ? M::SWEEPS : M::SWEEPS_WARM,
                       qacc, a0, m, qfrc);
    const T wgt = (stage == 1 || stage == 2) ? T(2) : T(1);
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      accp[d] = stage == 0 ? sv[d] : accp[d] + wgt * sv[d];
      accv[d] = stage == 0 ? qacc[d] : accv[d] + wgt * qacc[d];
    }
    if (stage == 3) {
      PLANAR_UNROLL
      for (int d = 0; d < NV; ++d) {
        q[d] = q[d] + h * accp[d] / T(6);
        v[d] = v[d] + h * accv[d] / T(6);
      }
    }
  }
}

}  // namespace planar
