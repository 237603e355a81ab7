// PPM edge reconstruction and upwind face flux for one directional
// sweep, shared by the continuity sweep (K1) and the BT_cont curve fit
// (K2).  Each function mirrors its plain PyTorch twin in
// mom6_torch/core/continuity_ppm.py operation for operation
// (_ppm_edges with each edge scheme, _flux_1dir), so with contraction
// off (-fmad=false) the kernels round as the plain version.
#pragma once

#include <cuda_runtime.h>

namespace mom6 {

template <typename T> __device__ inline T tmax(T a, T b) { return a > b ? a : b; }
template <typename T> __device__ inline T tmin(T a, T b) { return a < b ? a : b; }
template <typename T> __device__ inline T tsign(T a) {
  return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a);
}
template <typename T> __device__ inline T tclip(T x, T lo, T hi) {
  return tmin(tmax(x, lo), hi);
}

// limited PLM slope of the cell at h[c] (plain: slp after the mask test)
template <typename T>
__device__ inline T ppm_slope(T hm, T hc, T hp, T mm, T mc, T mp) {
  T slp = T(0.5) * (hp - hm);
  T dMx = tmax(tmax(hp, hm), hc) - hc;
  T dMn = hc - tmin(tmin(hp, hm), hc);
  slp = tsign(slp) * tmin(fabs(slp), T(2.0) * tmin(dMx, dMn));
  return (mp * mc * mm > T(0)) ? slp : T(0);
}

// the edge schemes of ContinuityCfg: PPM with the positive-definite
// limiter (the default), UPWIND_1ST_CONTINUITY, SIMPLE_2ND_PPM_CONTINUITY
// and MONOTONIC_CONTINUITY (PPM with the Colella-Woodward limiter)
enum EdgeScheme { EDGE_PPM = 0, EDGE_UPWIND = 1, EDGE_SIMPLE2 = 2,
                  EDGE_MONOTONIC = 3 };

// edge values (h_minus, h_plus) of the cell hv[2] from the thickness
// and cell mask of the cells -2..+2 along the sweep
template <typename T>
__device__ inline void ppm_edges(const T (&hv)[5], const T (&mv)[5],
                                 T h_min2, int scheme, T& h_minus,
                                 T& h_plus) {
  const T hc = hv[2], m_p = mv[3], m_m = mv[1];
  if (scheme == EDGE_UPWIND) {
    h_minus = h_plus = hc;
    return;
  }
  T h_p = m_p * hv[3] + (T(1.0) - m_p) * hc;
  T h_m = m_m * hv[1] + (T(1.0) - m_m) * hc;
  if (scheme == EDGE_SIMPLE2) {
    h_minus = T(0.5) * (h_m + hc);
    h_plus = T(0.5) * (h_p + hc);
    return;
  }
  T slp_m = ppm_slope(hv[0], hv[1], hv[2], mv[0], mv[1], mv[2]);
  T slp = ppm_slope(hv[1], hv[2], hv[3], mv[1], mv[2], mv[3]);
  T slp_p = ppm_slope(hv[2], hv[3], hv[4], mv[2], mv[3], mv[4]);
  const T one6 = T(1.0 / 6.0);
  T hmi = T(0.5) * (h_m + hc) + one6 * (slp_m - slp);
  T hpl = T(0.5) * (h_p + hc) + one6 * (slp - slp_p);
  if (scheme == EDGE_MONOTONIC) {
    // Colella & Woodward (1984); h_plus's test takes the new h_minus
    const bool pc = (hpl - hc) * (hc - hmi) <= T(0);
    const T dh = hpl - hmi;
    const T curv = T(6.0) * hc - T(3.0) * (hmi + hpl);
    h_minus = pc ? hc : (dh * curv > dh * dh ? T(3.0) * hc - T(2.0) * hpl
                                             : hmi);
    h_plus = pc ? hc : (dh * curv < -dh * dh
                            ? T(3.0) * hc - T(2.0) * h_minus : hpl);
    return;
  }
  // positive-definite limiter (PPM_limit_pos)
  T curv = T(3.0) * (hmi + hpl - T(2.0) * hc);
  T dh = hpl - hmi;
  bool interior_min = (curv > T(0)) && (fabs(dh) < curv);
  T denom = curv * curv + T(3.0) * dh * dh;
  bool need_scale = T(12.0) * curv * (hc - h_min2) < denom;
  T scale = denom > T(0)
      ? T(12.0) * curv * tmax(hc - h_min2, T(0)) / denom : T(1.0);
  bool flat = interior_min && (hc <= h_min2);
  bool shrink = interior_min && !flat && need_scale;
  h_minus = flat ? hc : (shrink ? hc + scale * (hmi - hc) : hmi);
  h_plus = flat ? hc : (shrink ? hc + scale * (hpl - hc) : hpl);
}

// the 2D constants of one face (plain: the flux_args of _flux_1dir);
// Idx_dn is stored negated: ((-u)*dt)*Idx_dn == (u*dt)*(-Idx_dn) exactly.
// With the volume-based CFL (CONT_PPM_VOLUME_BASED_CFL) Idx_up and
// Idx_dn hold dlen*Iarea of the two cells, so cfl = (u*dt)*(dlen*Iarea)
// rounds as the plain version's
template <typename T> struct FaceConst {
  T dlen, Idx_up, nIdx_dn, mask;
};

// one layer's upwind PPM flux through a face and its velocity
// derivative (plain: _flux_1dir).  ``up`` points at the
// thickness, h_minus and h_plus of the cell "up" (the face's own index),
// stored consecutively; the cell "dn" (+1 along the sweep) lies ``dn``
// elements further.  The plain version evaluates both upwind branches
// and selects one; here only the cell the flow comes from is read.
// With X the edge the fluid leaves through and Y the far edge (X =
// h_plus, Y = h_minus of "up" for u > 0; X = h_minus, Y = h_plus of
// "dn" for u < 0) both branches are the same expression, operand for
// operand, so the result is bitwise the one the plain version selects.
// No branch: the selects let the compiler interleave the evaluations of
// several layers.
template <typename T>
__device__ inline void ppm_flux(T u, T vr, const T* up, int dn,
                                const FaceConst<T>& F, T dt, T& flux,
                                T& dfdu) {
  const bool pos = u > T(0), moving = pos || u < T(0);
  const T* c = up + (pos ? 0 : dn);
  const T hc = c[0], hW = c[1], hE = c[2];
  const T X = pos ? hE : hW, Y = pos ? hW : hE;
  const T cfl = u * dt * (pos ? F.Idx_up : F.nIdx_dn);
  const T curv3 = hW + hE - T(2.0) * hc;
  const T d = Y - X;
  const T f = F.dlen * u * (X + cfl * (T(0.5) * d + curv3 * (cfl - T(1.5))))
      * F.mask;
  const T marg = X + cfl * (d + T(3.0) * curv3 * (cfl - T(1.0)));
  // u == 0: no flux, and the mean of the two edges at the face (hW is
  // then h_minus of "dn")
  flux = moving ? f : T(0) * F.mask;
  const T h_marg = moving ? marg : T(0.5) * (hW + up[2]);
  dfdu = F.dlen * h_marg * vr * F.mask;
}

// one clipped Newton step towards sum_k flux == target
template <typename T>
__device__ inline T newton_step(T du, T sum_flux, T sum_dfdu, T target,
                                T du_lim) {
  T err = sum_flux - target;
  T denom = fabs(sum_dfdu) > T(1e-30) ? sum_dfdu : T(1e-30);
  return tclip(du + (-err / denom), -du_lim, du_lim);
}

}  // namespace mom6
