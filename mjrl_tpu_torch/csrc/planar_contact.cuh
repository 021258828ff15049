// Per-environment body of the planar contact / RK4 control-step kernel.
//
// planar::contact_step_n<T, M, L> advances ONE environment of a planar tree
// with ground contacts by one control step (n substeps), on a group of L
// lanes.  Per substep (Euler) or per Runge-Kutta stage (RK4) it evaluates
// the constrained acceleration (contact_qacc): smooth dynamics
// (planar_body.cuh), a Cholesky factor of M, the constraint rows — one
// signed row per limited dof; per contact (plane-sphere, capsule end cap,
// capsule-capsule) one frictionless normal, 4 pyramidal facets or an
// elliptic [n, t1, t2] triple — and the regularized dual, solved by
// diagonally preconditioned accelerated projected gradient descent: 8 power
// iterations for the Lipschitz bound, adaptive restart, the closed-form
// second-order-cone projection for elliptic triples, a FIXED number of
// sweeps (50 for the first solve of the control step, 15 for the later ones,
// which start from the previous impulses).  Euler then integrates smooth +
// constraint force with M + h diag(damping); RK4 combines the four stage
// accelerations.
//
// Lane groups.  The L lanes of a group (L = 1, 8, 16 or 32, consecutive
// lanes of one warp) share one environment.  Each lane owns some of the
// constraint rows — the generated header's tables M::own_lane / M::own_slot
// say which, and at which of the lane's S = M::slots(.) slots; the three rows
// of an elliptic triple sit on one lane in slots 3j, 3j+1, 3j+2 — and keeps
// only its rows' J, M^-1 J^T and per-row vectors, in registers when S is
// small.  Everything per environment (smooth dynamics, Cholesky, a0, the
// row assembly, the integrator) runs on every lane of the group, redundantly,
// on the same values.  The dual operator sums its per-lane parts over the
// group by an xor butterfly (group_sum), as do the norms, the restart test
// and the final M^-1 J^T lambda: each pairwise add is commutative, so every
// group-wide value (the Lipschitz bound, the restart flag, the momentum, the
// state) comes out with the same bits on all L lanes, and the lanes of a
// group never take different branches.  L = 1 is one thread per environment
// with every row in the thread (the host build's case, and the first design
// of this kernel).
//
// It repeats the arithmetic of the plain PyTorch version,
// mjrl_tpu_torch/physics/planar.py::planar_contact_step_n (every guard and
// floor to the letter, inactive rows multiplied by `active` rather than
// skipped, every select a select, no early exit), with two exceptions.
// Sums over rows run over each lane's slots in order and then over the lanes
// by the butterfly, where the plain version calls torch.sum; sums over dofs
// run left to right.  And where the plain version divides many values by the
// same quantity (a row's scale ds, a Cholesky pivot, a norm, the Lipschitz
// bound), this file takes the correctly rounded reciprocal once and
// multiplies, which moves a quotient by at most one unit in the last place.
// On an H100 every L agrees with the plain version within 1e-9 in float64;
// in float32 a sum in another order can flip a restart test now and then
// (chip_smoke.py holds float32 to 3e-4 on q and 3e-3 x the largest |v| on
// v; PERF.md has the measured agreement).
//
// T is float or double; M is the generated model-traits struct.  Model
// structure (which dof drives which body, which contact owns which rows,
// which lane owns which row) is compile-time and unrolled; the solver's
// sweeps, the power iterations and the stages are run-time loops around ONE
// copy of the solve.  Loops over a lane's slots are unrolled too, so every
// slot index is a constant: a lane's few slots live in registers; at L = 1
// (38 to 70 slots) the compiler keeps what does not fit in thread-local
// memory at fixed offsets, as rolled loops over computed addresses would
// not.  No CUDA-only construct outside the PLANAR_HD /
// PLANAR_UNROLL macros and group_sum: g++ compiles it for the host harness
// at L = 1.
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

// This lane's share of the dual problem of one acceleration evaluation:
// its rows of J and M^-1 J^T, their reference accelerations, regularizers,
// active flags and scales, slot by slot; per triple group j (slots 3j..3j+2)
// whether the lane holds an elliptic triple there and its friction
// coefficient (then mu scaled by the tangent / normal scales).  Slots and
// groups the lane does not own stay zero and solve to zero.
template <typename T, typename M, int L>
struct Dual {
  static constexpr int LI = M::lanes_index(L);
  static_assert(LI >= 0, "no ownership table for this lane-group size");
  static constexpr int NS = M::slots(LI), NG = M::tri_groups(LI);
  static constexpr int S = NS > 0 ? NS : 1, G = NG > 0 ? NG : 1;
  int lane;
  T rows[S][M::NV], minv[S][M::NV];
  T aref[S], reg[S], active[S], ds[S], ids[S], rhs[S];   // ids = 1 / ds
  bool tri[G];
  T mu_g[G];
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

// store row r = jrow with its reference acceleration aref_pos - b (J v),
// on the lane that owns it
template <typename T, typename M, int L>
PLANAR_HD void put_row(Dual<T, M, L>& w, int r, const T (&jrow)[M::NV],
                       const T (&v)[M::NV], T aref_pos, T brow, T act,
                       T reg) {
  using W = Dual<T, M, L>;
  if (w.lane != M::own_lane(W::LI, r)) return;
  const int s = M::own_slot(W::LI, r);
  T jv = T(0);
  PLANAR_UNROLL
  for (int d = 0; d < M::NV; ++d) {
    w.rows[s][d] = jrow[d];
    jv = d == 0 ? jrow[d] * v[d] : jv + jrow[d] * v[d];
  }
  w.aref[s] = aref_pos - brow * jv;
  w.active[s] = act;
  w.reg[s] = reg;
}

// rows of contact i (index over points, then capsule pairs) with normal
// Jacobian jn, tangent Jacobian jt and penetration depth
template <typename T, typename M, int L>
PLANAR_HD void add_contact(Dual<T, M, L>& w, int i, const T (&jn)[M::NV],
                           const T (&jt)[M::NV], T depth,
                           const T (&v)[M::NV]) {
  using W = Dual<T, M, L>;
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
    put_row<T, M, L>(w, M::con_row(i), jn, v, aref, brow, act, reg);
  } else if (M::con_tri(i) >= 0) {
    // elliptic triple [n, t1, t2] in block order; t2, the out-of-plane
    // tangent, is a zero row kept for the shared tangent scale
    const T reg = clamp_min((T(1) - imp) / imp * T(M::con_invweight(i)),
                            T(1e-12));
    T zrow[NV];
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) zrow[d] = T(0);
    const int k = M::con_tri(i), rn = M::SOC_START + k;
    if (w.lane == M::own_lane(W::LI, rn)) {
      const int j = M::own_slot(W::LI, rn) / 3;
      w.tri[j] = true;
      w.mu_g[j] = T(M::tri_mu(k));
    }
    put_row<T, M, L>(w, rn, jn, v, aref, brow, act, reg);
    put_row<T, M, L>(w, rn + M::NTRI, jt, v, T(0), brow, act, reg);
    put_row<T, M, L>(w, rn + 2 * M::NTRI, zrow, v, T(0), brow, act, reg);
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
    put_row<T, M, L>(w, r, jn, v, aref, brow, act, reg);
    put_row<T, M, L>(w, r + 1, jn, v, aref, brow, act, reg);
    put_row<T, M, L>(w, r + 2, jp, v, aref, brow, act, reg);
    put_row<T, M, L>(w, r + 3, jm, v, aref, brow, act, reg);
  }
}

// all constraint rows at (q, v); each lane keeps the rows it owns
template <typename T, typename M, int L>
PLANAR_HD void constraint_rows(const Kinematics<T, M>& kin,
                               const T (&q)[M::NV], const T (&v)[M::NV],
                               Dual<T, M, L>& w) {
  using W = Dual<T, M, L>;
  constexpr int NV = M::NV;
  const T zero = T(0), one = T(1);

  PLANAR_UNROLL
  for (int s = 0; s < W::S; ++s) {
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) w.rows[s][d] = zero;
    w.aref[s] = zero;
    w.reg[s] = zero;
    w.active[s] = zero;
  }
  PLANAR_UNROLL
  for (int j = 0; j < W::G; ++j) {
    w.tri[j] = false;
    w.mu_g[j] = zero;
  }

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
    put_row<T, M, L>(w, i, jrow, v, T(-M::limit_k(i)) * imp * dist,
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
    add_contact<T, M, L>(w, i, jn, jt, depth, v);
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
    add_contact<T, M, L>(w, M::NPT + i, jn, jt, depth, v);
  }
}

// out = D^-1/2 (J M^-1 J^T + R) D^-1/2 x, the preconditioned dual operator:
// this lane's part of M^-1 J^T D^-1/2 x, summed over the group, then this
// lane's rows
template <typename T, typename M, int L>
PLANAR_HD void dual_op(const Dual<T, M, L>& w, const T (&x)[Dual<T, M, L>::S],
                       T (&out)[Dual<T, M, L>::S]) {
  using W = Dual<T, M, L>;
  constexpr int NV = M::NV;
  T acc[NV];
  PLANAR_UNROLL
  for (int s = 0; s < W::S; ++s) {
    const T u = x[s] * w.ids[s];
    out[s] = u;
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      acc[d] = s == 0 ? w.minv[s][d] * u : acc[d] + w.minv[s][d] * u;
    }
  }
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) acc[d] = group_sum<L>(acc[d]);
  PLANAR_UNROLL
  for (int s = 0; s < W::S; ++s) {
    T t = w.rows[s][0] * acc[0];
    PLANAR_UNROLL
    for (int d = 1; d < NV; ++d) t = t + w.rows[s][d] * acc[d];
    out[s] = (t + w.reg[s] * out[s]) * w.ids[s];
  }
}

// projection of the scaled iterate z onto the feasible set, in place:
// nonnegative clamp; elliptic triples onto their second-order cone
template <typename T, typename M, int L>
PLANAR_HD void project(const Dual<T, M, L>& w, T (&z)[Dual<T, M, L>::S]) {
  using W = Dual<T, M, L>;
  PLANAR_UNROLL
  for (int s = 0; s < W::S; ++s) {
    const bool tri = s < 3 * W::NG && w.tri[s / 3];
    if (!tri) z[s] = clamp_min(z[s], T(0)) * w.active[s];
  }
  PLANAR_UNROLL
  for (int j = 0; j < W::NG; ++j) {
    const int sn = 3 * j, s1 = sn + 1, s2 = sn + 2;
    const T n_i = z[sn], t1 = z[s1], t2 = z[s2];
    const T mg = w.mu_g[j];
    const T s = sqrt_(t1 * t1 + t2 * t2);
    const bool inside = s <= mg * n_i;
    const bool below = mg * s <= -n_i;
    const T c = (mg * s + n_i) / (T(1) + mg * mg);
    const T n_p = inside ? n_i : (below ? T(0) : c);
    const T tsc = inside ? T(1)
                         : (below ? T(0) : mg * c / clamp_min(s, T(1e-30)));
    if (w.tri[j]) {
      z[sn] = n_p * w.active[sn];
      z[s1] = t1 * tsc * w.active[s1];
      z[s2] = t2 * tsc * w.active[s2];
    }
  }
}

// sum over the group of this lane's x[s] y[s]
template <typename T, typename M, int L>
PLANAR_HD T group_dot(const T (&x)[Dual<T, M, L>::S],
                      const T (&y)[Dual<T, M, L>::S]) {
  using W = Dual<T, M, L>;
  T s = T(0);
  PLANAR_UNROLL
  for (int r = 0; r < W::S; ++r) s = r == 0 ? x[r] * y[r] : s + x[r] * y[r];
  return group_sum<L>(s);
}

// Constrained acceleration at (q, v, u).  lam: this lane's impulses of the
// previous solve in, of this solve out.  Also hands back what the Euler
// integrator needs: the unconstrained acceleration a0, M and the smooth
// force.
template <typename T, typename M, int L>
PLANAR_HD void contact_qacc(const T (&q)[M::NV], const T (&v)[M::NV],
                            const T (&u)[M::NU],
                            T (&lam)[Dual<T, M, L>::S], int sweeps,
                            T (&qacc)[M::NV], T (&a0)[M::NV],
                            T (&m)[M::NV][M::NV], T (&qfrc)[M::NV],
                            int lane) {
  using W = Dual<T, M, L>;
  constexpr int NV = M::NV, S = W::S;
  Kinematics<T, M> kin;
  smooth<T, M>(q, v, u, kin, m, qfrc);
  T low[NV][NV], ilow[NV];
  cholesky_rel<T, NV>(m, low, ilow);
  chol_solve_rel<T, NV>(low, ilow, qfrc, a0);

  W w;
  w.lane = lane;
  constraint_rows<T, M, L>(kin, q, v, w);

  // this lane's columns of M^-1 J^T and its rows' diagonal scales
  PLANAR_UNROLL
  for (int s = 0; s < S; ++s) {
    chol_solve_rel<T, NV>(low, ilow, w.rows[s], w.minv[s]);
    T diag = w.rows[s][0] * w.minv[s][0];
    PLANAR_UNROLL
    for (int d = 1; d < NV; ++d) diag = diag + w.rows[s][d] * w.minv[s][d];
    w.ds[s] = sqrt_(clamp_min(diag + w.reg[s], T(1e-12)));
  }
  // elliptic triples: one scale for both tangents, mu in the scaled space
  PLANAR_UNROLL
  for (int j = 0; j < W::NG; ++j) {
    const int sn = 3 * j, s1 = sn + 1, s2 = sn + 2;
    if (w.tri[j]) {
      const T ds_t = sqrt_(w.ds[s1] * w.ds[s2]);
      w.ds[s1] = ds_t;
      w.ds[s2] = ds_t;
      w.mu_g[j] = w.mu_g[j] * ds_t / w.ds[sn];
    }
  }
  PLANAR_UNROLL
  for (int s = 0; s < S; ++s) w.ids[s] = T(1) / w.ds[s];

  // Lipschitz constant of the preconditioned dual by power iteration
  T x[S], y[S], g[S];
  const T inrm = T(1) / clamp_min(sqrt_(group_dot<T, M, L>(w.active,
                                                           w.active)),
                                  T(1e-12));
  PLANAR_UNROLL
  for (int s = 0; s < S; ++s) x[s] = w.active[s] * inrm;
  T lmax = T(1);
  for (int it = 0; it < M::POWER_ITERS; ++it) {
    dual_op<T, M, L>(w, x, g);
    lmax = clamp_min(sqrt_(group_dot<T, M, L>(g, g)), T(1e-12));
    const T ilmax = T(1) / lmax;
    PLANAR_UNROLL
    for (int s = 0; s < S; ++s) x[s] = g[s] * ilmax;
  }
  const T iel = T(1) / clamp_min(T(1.1) * lmax, T(1e-8));   // step 1 / L

  // x: mu, y: momentum iterate, both in the scaled space
  PLANAR_UNROLL
  for (int s = 0; s < S; ++s) {
    T ja = w.rows[s][0] * a0[0];
    PLANAR_UNROLL
    for (int d = 1; d < NV; ++d) ja = ja + w.rows[s][d] * a0[d];
    w.rhs[s] = (w.aref[s] - ja) * w.ids[s];
    x[s] = lam[s] * w.active[s] * w.ds[s];
    y[s] = x[s];
  }
  T t = T(1);
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    dual_op<T, M, L>(w, y, g);
    PLANAR_UNROLL
    for (int s = 0; s < S; ++s) g[s] = y[s] - (g[s] - w.rhs[s]) * iel;
    project<T, M, L>(w, g);                    // g = mu_new
    // adaptive restart: drop the momentum when it opposes descent
    T dot = T(0);
    PLANAR_UNROLL
    for (int s = 0; s < S; ++s) {
      const T term = (y[s] - g[s]) * (g[s] - x[s]);
      dot = s == 0 ? term : dot + term;
    }
    const bool restart = group_sum<L>(dot) > T(0);
    t = restart ? T(1) : t;
    const T t_new = T(0.5) * (T(1) + sqrt_(T(1) + T(4) * t * t));
    const T mom = restart ? T(0) : (t - T(1)) / t_new;
    PLANAR_UNROLL
    for (int s = 0; s < S; ++s) {
      y[s] = g[s] + mom * (g[s] - x[s]);
      x[s] = g[s];
    }
    t = t_new;
  }

  T add[NV];
  PLANAR_UNROLL
  for (int s = 0; s < S; ++s) {
    lam[s] = x[s] * w.ids[s];
    PLANAR_UNROLL
    for (int d = 0; d < NV; ++d) {
      add[d] = s == 0 ? w.minv[s][d] * lam[s] : add[d] + w.minv[s][d] * lam[s];
    }
  }
  PLANAR_UNROLL
  for (int d = 0; d < NV; ++d) {
    add[d] = group_sum<L>(add[d]);
    qacc[d] = M::NROWS > 0 ? a0[d] + add[d] : a0[d];
  }
}

// One control step (n substeps), in place on q[NV], v[NV], for the
// environment of this lane's group; every lane of the group ends with the
// same q and v.  lane: this lane's index in its group (0 when L = 1).
template <typename T, typename M, int L>
PLANAR_HD void contact_step_n(T (&q)[M::NV], T (&v)[M::NV],
                              const T (&u)[M::NU], int n, int lane) {
  using W = Dual<T, M, L>;
  constexpr int NV = M::NV, S = W::S;
  const T h = T(M::H);
  lane = L == 1 ? 0 : lane;
  T lam[S];
  PLANAR_UNROLL
  for (int s = 0; s < S; ++s) lam[s] = T(0);
  T qacc[NV], a0[NV], m[NV][NV], qfrc[NV];

  if (!M::RK4) {
    for (int s = 0; s < n; ++s) {
      contact_qacc<T, M, L>(q, v, u, lam,
                            s == 0 ? M::SWEEPS : M::SWEEPS_WARM, qacc, a0, m,
                            qfrc, lane);
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
    contact_qacc<T, M, L>(sq, sv, u, lam,
                          ev == 0 ? M::SWEEPS : M::SWEEPS_WARM, qacc, a0, m,
                          qfrc, lane);
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
