// Arithmetic of the Fisher-vector product kernel (K3), for one block.
//
// F v is the Hessian of the mean KL(old || new) of the Gaussian policy at
// new = old, times a direction v.  For the policy's MLP mean mu(x) (layers
// W_l, b_l, then out_scale) and its state-independent log_std, at equality
// (mu_old - mu_new = 0 exactly) the Hessian has a closed form:
//
//   F v = sum_i m_i J_i^T diag(coef) J_i v / count       (mean net)
//   coef = out_scale^2 * 2 / (2 exp(log_std)^2 + 1e-8)
//   F v = v_ls * 4t (2t - 1e-8) / (2t + 1e-8)^2 * sum_i m_i / count,
//         t = exp(log_std)^2                                  (log_std)
//
// with no cross term: the double backward of the KL computes exactly this,
// plus terms multiplied by mu_old - mu_new = 0.  J_i v is the tangent of the
// network's output (a forward-mode product) and J_i^T u the backward of u.
//
// Per block of NT threads and a tile of ROWS rows:
// - load_tile: the tile's observations, normalised, into H_0 (coalesced),
//   and the rows' weights m (the mask, 0 past the batch's end);
// - phase A, layer by layer, each a small matrix product over the tile
//   with a barrier after it: the forward from x_hat and the tangent forward
//   (h W^T + b, h dW^T + db + dh W^T; the nonlinearity and its derivative),
//   u = coef * dout * m, then the backward of u (g W times the derivative)
//   to every layer.  Each thread computes 4 rows x 4 outputs at a time from
//   128-bit loads: 48 multiply-adds for 4 loads in the forward, so the
//   weights are read from shared memory once for 4 rows.  Each layer's input
//   h_l goes to H_l, each layer's output gradient g_l to G_l; the tangent
//   of a hidden layer's output to scratch rows aliasing G;
// - outer: sum over the tile's rows of g_l (x) [h_l, 1] (the bias is the
//   row of ones in H_l), each thread owning fixed 4 x 2 blocks of output
//   entries, accumulated in shared memory across tiles.
//
// Shared memory (elements of T): the weights transposed, W_l^T with the
// bias as an extra row (kp(l) = round4(in(l) + 1) rows of jp(l) =
// round4(out(l)), zero padded), the same for the tangent v; the H and G
// buffers, row k of a buffer holding one value per row of the tile (stride
// TS = ROWS + 4, so that neighbouring rows fall 4 banks apart); the
// accumulators; coef, in_shift, in_scale + 1e-8; the rows' weights.
//
// A block of output entries: G_l rows a + MJ i (i < 4, MJ = jp(l) / 4) and
// H_l rows c + MK i' (i' < 2, MK = kp(l) / 2), block a * MK + c: the H rows a
// thread reads differ from its neighbours' by one, so the 128-bit loads of a
// quarter warp hit distinct banks, and neighbours mostly share G rows.
//
// M is the generated shape-traits struct (ops/cuda_fvp.py::emit_model_header).
// Nothing here is CUDA-only outside FVP_HD, ld4 and st4, so g++ compiles
// it for the host test harness (fvp_host.cpp).
#pragma once

#include <cmath>

#if defined(__CUDACC__)
#define FVP_UNROLL _Pragma("unroll")
#else
#define FVP_UNROLL
#endif

namespace fvp {

FVP_HD float tanh_(float x) { return tanhf(x); }
FVP_HD double tanh_(double x) { return tanh(x); }

template <typename T>
struct V4 {
  T x, y, z, w;
};

// four consecutive values from shared memory (16-byte aligned for float,
// 32 for double)
FVP_HD V4<float> ld4(const float* p) {
#if defined(__CUDA_ARCH__)
  const float4 a = *reinterpret_cast<const float4*>(p);
  return {a.x, a.y, a.z, a.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

FVP_HD V4<double> ld4(const double* p) {
#if defined(__CUDA_ARCH__)
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {a.x, a.y, b.x, b.y};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

// four values to consecutive shared memory (aligned as for ld4)
FVP_HD void st4(float* p, const float* v) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  p[0] = v[0], p[1] = v[1], p[2] = v[2], p[3] = v[3];
#endif
}

FVP_HD void st4(double* p, const double* v) {
#if defined(__CUDA_ARCH__)
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
#else
  p[0] = v[0], p[1] = v[1], p[2] = v[2], p[3] = v[3];
#endif
}

FVP_HD constexpr int round4(int n) { return (n + 3) / 4 * 4; }

template <typename T, typename M, int ROWS, int NT>
struct Body {
  static constexpr int L = M::L;
  static constexpr int D = M::in(0);
  static constexpr int A = M::out(L - 1);
  static constexpr int TS = ROWS + 4;
  static constexpr int RB = ROWS / 4;           // blocks of 4 rows
  static constexpr int DW = M::WSIZE;           // the tangent's weights
  static constexpr int H0 = 2 * M::WSIZE;
  static constexpr int G0 = H0 + M::HROWS * TS;
  static constexpr int ACC = G0 + M::GROWS * TS;
  static constexpr int NACC = M::NBLK * 8;
  static constexpr int COEF = ACC + NACC;
  static constexpr int SHIFT = COEF + round4(A);
  static constexpr int DEN = SHIFT + round4(D);
  static constexpr int MASK = DEN + round4(D);
  static constexpr int SIZE = MASK + ROWS;      // elements of T

  static_assert(ROWS % 32 == 0 && NT % 32 == 0, "whole warps");
  static_assert(M::WSIZE % 4 == 0, "aligned 4-vectors");

  T* s;

  FVP_HD T* hrow(int l, int k) const { return s + H0 + (M::hrow(l) + k) * TS; }
  FVP_HD T* grow(int l, int j) const { return s + G0 + (M::grow(l) + j) * TS; }
  // the tangents of the hidden layers' outputs, two buffers in turn,
  // aliasing the G buffers of the hidden layers (free until the forward is
  // done), never G_{L-1}, which the forward's last layer writes
  FVP_HD T* scratch(int buf, int k) const {
    return s + G0 + (M::SCR + buf * M::SCRH + k) * TS;
  }

  FVP_HD static T dact(T a) {
    if (M::RELU) return a > T(0) ? T(1) : T(0);
    return T(1) - a * a;
  }

  FVP_HD static T act(T z) {
    if (M::RELU) return z > T(0) ? z : T(0);
    return tanh_(z);
  }

  // once per block: weights and tangent (bias as column in(l), zero pads),
  // the constant rows of H (ones, zeros) and G (zeros), the accumulators,
  // coef and the input transform
  FVP_HD void setup(const T* theta, const T* v, const T* coef,
                    const T* shift, const T* scale, int t, int nt) const {
    FVP_UNROLL
    for (int l = 0; l < L; ++l) {
      const int K = M::in(l), KP = M::kp(l), J = M::out(l), JP = M::jp(l);
      for (int e = t; e < KP * JP; e += nt) {
        const int k = e / JP, j = e % JP;
        T w = T(0), dw = T(0);
        if (j < J && k < K) {
          w = theta[M::pw(l) + j * K + k];
          dw = v[M::pw(l) + j * K + k];
        } else if (j < J && k == K) {
          w = theta[M::pb(l) + j];
          dw = v[M::pb(l) + j];
        }
        s[M::woff(l) + e] = w;
        s[DW + M::woff(l) + e] = dw;
      }
      for (int e = t; e < (KP - K) * TS; e += nt) {
        hrow(l, K)[e] = e < TS ? T(1) : T(0);
      }
      for (int e = t; e < (M::jp(l) - J) * TS; e += nt) grow(l, J)[e] = T(0);
    }
    for (int e = t; e < NACC; e += nt) s[ACC + e] = T(0);
    for (int e = t; e < A; e += nt) s[COEF + e] = coef[e];
    for (int e = t; e < D; e += nt) {
      s[SHIFT + e] = shift[e];
      s[DEN + e] = scale[e] + T(1e-8);
    }
  }

  // the rows row0 .. row0 + ROWS - 1 of obs (n rows in all) into H_0,
  // normalised, and their weights (mask, or 1; 0 past the end, where the
  // observations read 0)
  FVP_HD void load_tile(const T* obs, const T* mask, long long n,
                        long long row0, int t) const {
    const long long left = n - row0;
    const int rows = left < ROWS ? static_cast<int>(left) : ROWS;
    const T* src = obs + row0 * D;
    for (int e = t; e < ROWS * D; e += NT) {
      const int r = e / D, d = e % D;
      hrow(0, d)[r] = r < rows ? (src[e] - s[SHIFT + d]) / s[DEN + d] : T(0);
    }
    for (int r = t; r < ROWS; r += NT) {
      s[MASK + r] = r < rows ? (mask != nullptr ? mask[row0 + r] : T(1))
                             : T(0);
    }
  }

  // Phase A, step by step: forward<0> .. forward<L-1>, then backward<L-1>
  // .. backward<1>; every thread of the block runs a step before any runs
  // the next (a barrier between steps).  A step's work is tiles of 4 rows x
  // 4 outputs, tile c on thread c % NT; a warp's lanes take neighbouring
  // row blocks of the same outputs.
  static constexpr int STEPS = 2 * L - 1;

  FVP_HD void step(int st, int t) const { step_at<0>(st, t); }

  template <int i>
  FVP_HD void step_at(int st, int t) const {
    if (st == i) {
      if constexpr (i < L) {
        forward<i>(t);
      } else {
        backward<(i < L ? 1 : 2 * L - 1 - i)>(t);
      }
    } else if constexpr (i + 1 < STEPS) {
      step_at<(i + 1 < STEPS ? i + 1 : i)>(st, t);
    }
  }

  // layer l's forward and tangent; the last layer's tangent becomes u =
  // coef * dout * m in G_{L-1}.  The tangent of layer l's input is in
  // scratch buffer (l - 1) % 2, of its output goes to buffer l % 2
  template <int l>
  FVP_HD void forward(int t) const {
    constexpr int K = M::in(l), J = M::out(l), JP = M::jp(l);
    constexpr bool last = l + 1 == L;
    constexpr int TILES = RB * (JP / 4);
    for (int c = t; c < TILES; c += NT) {
      const int rb = c % RB, jb = c / RB;
      const T* h = hrow(l, 0) + 4 * rb;
      const T* dh = scratch((l + 1) % 2, 0) + 4 * rb;
      const T* w = s + M::woff(l) + 4 * jb;
      const T* dw = s + DW + M::woff(l) + 4 * jb;
      T z[4][4], dz[4][4], dzw[4][4];
      FVP_UNROLL
      for (int i = 0; i < 16; ++i) {
        z[i / 4][i % 4] = dz[i / 4][i % 4] = dzw[i / 4][i % 4] = T(0);
      }
#if defined(__CUDACC__)
#pragma unroll 4
#endif
      for (int k = 0; k < K; ++k) {
        const V4<T> hv = ld4(h + k * TS), bv = ld4(dw + k * JP);
        const T hs[4] = {hv.x, hv.y, hv.z, hv.w};
        const T bs[4] = {bv.x, bv.y, bv.z, bv.w};
        T as[4], ds[4];
        if (!last || l > 0) {
          const V4<T> av = ld4(w + k * JP);
          as[0] = av.x, as[1] = av.y, as[2] = av.z, as[3] = av.w;
        }
        if (l > 0) {
          const V4<T> dv = ld4(dh + k * TS);
          ds[0] = dv.x, ds[1] = dv.y, ds[2] = dv.z, ds[3] = dv.w;
        }
        FVP_UNROLL
        for (int i = 0; i < 4; ++i) {
          FVP_UNROLL
          for (int q = 0; q < 4; ++q) {
            dz[i][q] += hs[i] * bs[q];
            if (!last) z[i][q] += hs[i] * as[q];
            if (l > 0) dzw[i][q] += ds[i] * as[q];
          }
        }
      }
      // the bias: row K of W^T against the row of ones
      const V4<T> bb = ld4(dw + K * JP), ab = ld4(w + K * JP);
      const T bbs[4] = {bb.x, bb.y, bb.z, bb.w};
      const T abs_[4] = {ab.x, ab.y, ab.z, ab.w};
      FVP_UNROLL
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * jb + q;
        if (j >= J) continue;
        T out[4], tan[4];
        FVP_UNROLL
        for (int i = 0; i < 4; ++i) {
          const T d = (dz[i][q] + bbs[q]) + dzw[i][q];
          if (last) {
            out[i] = s[COEF + j] * d * s[MASK + 4 * rb + i];
          } else {
            out[i] = act(z[i][q] + abs_[q]);
            tan[i] = dact(out[i]) * d;
          }
        }
        if (last) {
          st4(grow(l, j) + 4 * rb, out);
        } else {
          st4(hrow(l + 1, j) + 4 * rb, out);
          st4(scratch(l % 2, j) + 4 * rb, tan);
        }
      }
    }
  }

  // g_l (G_l) back through layer l to g_{l-1}; the rows of G_{l-1} past
  // in(l) up to round4(in(l)) are written 0
  template <int l>
  FVP_HD void backward(int t) const {
    constexpr int K = M::in(l), JP = M::jp(l);
    constexpr int KB = round4(K) / 4;
    constexpr int TILES = RB * KB;
    for (int c = t; c < TILES; c += NT) {
      const int rb = c % RB, kb = c / RB;
      const T* w = s + M::woff(l) + 4 * kb * JP;
      T gh[4][4];
      FVP_UNROLL
      for (int i = 0; i < 16; ++i) gh[i / 4][i % 4] = T(0);
#if defined(__CUDACC__)
#pragma unroll 2
#endif
      for (int j0 = 0; j0 < JP; j0 += 4) {
        T gs[4][4], ws[4][4];   // gs[p][i]: g of output j0 + p, row i
        FVP_UNROLL
        for (int p = 0; p < 4; ++p) {
          const V4<T> gv = ld4(grow(l, j0 + p) + 4 * rb);
          gs[p][0] = gv.x, gs[p][1] = gv.y, gs[p][2] = gv.z, gs[p][3] = gv.w;
          const V4<T> wv = ld4(w + p * JP + j0);   // W[j0 .. j0 + 3][k0 + p]
          ws[p][0] = wv.x, ws[p][1] = wv.y, ws[p][2] = wv.z, ws[p][3] = wv.w;
        }
        FVP_UNROLL
        for (int p = 0; p < 4; ++p) {
          FVP_UNROLL
          for (int i = 0; i < 4; ++i) {
            FVP_UNROLL
            for (int q = 0; q < 4; ++q) gh[i][q] += gs[p][i] * ws[q][p];
          }
        }
      }
      FVP_UNROLL
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * kb + q;
        const V4<T> hv = ld4(hrow(l, k) + 4 * rb);
        const T hs[4] = {hv.x, hv.y, hv.z, hv.w};
        T out[4];
        FVP_UNROLL
        for (int i = 0; i < 4; ++i) {
          out[i] = k < K ? dact(hs[i]) * gh[i][q] : T(0);
        }
        st4(grow(l - 1, k) + 4 * rb, out);
      }
    }
  }

  // thread t's blocks of layer l and the layers after it: the tile's sum of
  // g_l (x) [h_l, 1], added to the accumulators
  template <int l>
  FVP_HD void outer(int t, int nt) const {
    constexpr int MJ = M::jp(l) / 4, MK = M::kp(l) / 2, NB = MJ * MK;
    constexpr int B0 = M::boff(l);
    for (int b = ((t - B0) % nt + nt) % nt; b < NB; b += nt) {
      const int a = b / MK, c = b % MK;
      const T* g = grow(l, a);
      const T* h = hrow(l, c);
      T acc[4][2];
      FVP_UNROLL
      for (int i = 0; i < 8; ++i) acc[i / 2][i % 2] = T(0);
#if defined(__CUDACC__)
#pragma unroll 2
#endif
      for (int r = 0; r < ROWS; r += 4) {
        V4<T> gv[4], hv[2];
        FVP_UNROLL
        for (int i = 0; i < 4; ++i) gv[i] = ld4(g + i * MJ * TS + r);
        FVP_UNROLL
        for (int i = 0; i < 2; ++i) hv[i] = ld4(h + i * MK * TS + r);
        FVP_UNROLL
        for (int i = 0; i < 4; ++i) {
          FVP_UNROLL
          for (int q = 0; q < 2; ++q) {
            acc[i][q] += gv[i].x * hv[q].x;
            acc[i][q] += gv[i].y * hv[q].y;
            acc[i][q] += gv[i].z * hv[q].z;
            acc[i][q] += gv[i].w * hv[q].w;
          }
        }
      }
      T* dst = s + ACC + (B0 + b) * 8;
      FVP_UNROLL
      for (int i = 0; i < 8; ++i) dst[i] += acc[i / 2][i % 2];
    }
    if constexpr (l + 1 < L) outer<(l + 1 < L ? l + 1 : l)>(t, nt);
  }

  // the block's accumulators to its slice of the partials
  FVP_HD void store(T* partial, int t, int nt) const {
    for (int e = t; e < NACC; e += nt) partial[e] = s[ACC + e];
  }
};

// entry p of the flat parameter vector (layers' weight then bias, then
// log_std): the sum of the blocks' partials in block order, or for
// log_std, cls * v
template <typename T, typename M>
FVP_HD T reduce_entry(int p, const T* partial, int nblocks, const T* v,
                      const T* cls) {
  constexpr int NACC = M::NBLK * 8;
  if (p >= M::PLS) return cls[p - M::PLS] * v[p];
  int slot = 0;
  FVP_UNROLL
  for (int l = 0; l < M::L; ++l) {
    const int K = M::in(l), J = M::out(l);
    const int MJ = M::jp(l) / 4, MK = M::kp(l) / 2;
    int j = -1, k = 0;
    if (p >= M::pw(l) && p < M::pw(l) + J * K) {
      j = (p - M::pw(l)) / K;
      k = (p - M::pw(l)) % K;
    } else if (p >= M::pb(l) && p < M::pb(l) + J) {
      j = p - M::pb(l);
      k = K;
    }
    if (j >= 0) {
      slot = (M::boff(l) + (j % MJ) * MK + k % MK) * 8 + (j / MJ) * 2 +
             k / MK;
    }
  }
  T sum = T(0);
  for (int g = 0; g < nblocks; ++g) {
    sum += partial[static_cast<long long>(g) * NACC + slot];
  }
  return sum;
}

}  // namespace fvp
