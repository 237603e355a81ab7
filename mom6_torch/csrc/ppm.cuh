// PPM edge reconstruction and upwind face flux for one directional
// sweep, shared by the continuity sweep (K1) and the BT_cont curve fit
// (K2).  Each function mirrors its plain PyTorch twin in
// mom6_torch/core/continuity_ppm.py operation for operation
// (_ppm_edges with the positive-definite limiter, _flux_1dir), so with
// contraction off (-fmad=false) the kernels round as the plain version.
//
// Layout: (nk, nj, ni) contiguous, halo-padded.  A sweep runs along x
// (stride 1, length ni) or y (stride ni, length nj); neighbours wrap at
// the array edge exactly like torch.roll, so kernel and plain version
// agree on the whole padded array, halos included.
#pragma once

#include <cuda_runtime.h>

namespace mom6 {

// position along the swept axis and the element offsets of the
// neighbours at -3..+3 (wrapped)
struct Line {
  int off[7];
  __device__ int at(int d) const { return off[d + 3]; }
};

__device__ inline Line make_line(int p, int n, int stride) {
  Line L;
#pragma unroll
  for (int d = -3; d <= 3; ++d) {
    int q = p + d;
    q = q < 0 ? q + n : (q >= n ? q - n : q);
    L.off[d + 3] = (q - p) * stride;
  }
  return L;
}

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

// edge values (h_minus, h_plus) of the cell at offset 0; h points at
// the cell in its layer, mask at the cell in the 2D mask
template <typename T>
__device__ inline void ppm_edges(const T* h, const T* mask, const Line& L,
                                 T h_min2, T& h_minus, T& h_plus) {
  T hv[5], mv[5];
#pragma unroll
  for (int d = -2; d <= 2; ++d) {
    hv[d + 2] = h[L.at(d)];
    mv[d + 2] = mask[L.at(d)];
  }
  const T hc = hv[2], m_p = mv[3], m_m = mv[1];
  T h_p = m_p * hv[3] + (T(1.0) - m_p) * hc;
  T h_m = m_m * hv[1] + (T(1.0) - m_m) * hc;
  T slp_m = ppm_slope(hv[0], hv[1], hv[2], mv[0], mv[1], mv[2]);
  T slp = ppm_slope(hv[1], hv[2], hv[3], mv[1], mv[2], mv[3]);
  T slp_p = ppm_slope(hv[2], hv[3], hv[4], mv[2], mv[3], mv[4]);
  const T one6 = T(1.0 / 6.0);
  T hmi = T(0.5) * (h_m + hc) + one6 * (slp_m - slp);
  T hpl = T(0.5) * (h_p + hc) + one6 * (slp - slp_p);
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

// one layer's upwind PPM flux through the face between cell "up" (at
// the face's own index) and cell "dn" (+1 along the sweep), and its
// velocity derivative (plain: _flux_1dir without vol_cfl)
template <typename T>
__device__ inline void ppm_flux(T u, T h_up, T hW_up, T hE_up, T h_dn,
                                T hW_dn, T hE_dn, T dt, T dlen,
                                T Idx_up, T Idx_dn, T face_mask, T vr,
                                T& flux, T& dfdu) {
  T cfl_p = u * dt * Idx_up;
  T cfl_m = -u * dt * Idx_dn;
  T curv3_p = hW_up + hE_up - T(2.0) * h_up;
  T flux_p = dlen * u * (hE_up + cfl_p * (T(0.5) * (hW_up - hE_up)
                                          + curv3_p * (cfl_p - T(1.5))));
  T marg_p = hE_up + cfl_p * ((hW_up - hE_up)
                              + T(3.0) * curv3_p * (cfl_p - T(1.0)));
  T curv3_m = hW_dn + hE_dn - T(2.0) * h_dn;
  T flux_m = dlen * u * (hW_dn + cfl_m * (T(0.5) * (hE_dn - hW_dn)
                                          + curv3_m * (cfl_m - T(1.5))));
  T marg_m = hW_dn + cfl_m * ((hE_dn - hW_dn)
                              + T(3.0) * curv3_m * (cfl_m - T(1.0)));
  bool pos = u > T(0), neg = u < T(0);
  flux = (pos ? flux_p : (neg ? flux_m : T(0))) * face_mask;
  T h_marg = pos ? marg_p : (neg ? marg_m : T(0.5) * (hW_dn + hE_up));
  dfdu = dlen * h_marg * vr * face_mask;
}

// the face-local data of one sweep: per-layer fields and 2D constants
template <typename T> struct Face {
  const T* u;        // face velocity (nk planes)
  const T* h;        // cell thickness (nk planes), cell "up"
  const T* hm;       // edge values from the edge pass (nk planes)
  const T* hp;
  const T* vr;       // visc_rem at the face (nk planes)
  T dlen, Idx_up, Idx_dn, mask, du_lim;
  int dn;            // element offset of cell "dn"
  long plane;        // elements per layer
  int nk;
};

// layer sums of flux and dflux/du at the correction du
template <typename T>
__device__ inline void column_flux(const Face<T>& F, T du, T dt,
                                   T& sum_flux, T& sum_dfdu) {
  T sf = T(0), sd = T(0);
  for (int k = 0; k < F.nk; ++k) {
    const long o = k * F.plane;
    T vr = F.vr[o];
    T f, d;
    ppm_flux(F.u[o] + vr * du, F.h[o], F.hm[o], F.hp[o], F.h[o + F.dn],
             F.hm[o + F.dn], F.hp[o + F.dn], dt, F.dlen, F.Idx_up,
             F.Idx_dn, F.mask, vr, f, d);
    sf = sf + f;
    sd = sd + d;
  }
  sum_flux = sf;
  sum_dfdu = sd;
}

// one clipped Newton step towards sum_k flux == target
template <typename T>
__device__ inline T newton_step(T du, T sum_flux, T sum_dfdu, T target,
                                T du_lim) {
  T err = sum_flux - target;
  T denom = fabs(sum_dfdu) > T(1e-30) ? sum_dfdu : T(1e-30);
  return tclip(du + (-err / denom), -du_lim, du_lim);
}

// edge pass: h_minus/h_plus of every cell along one sweep direction
template <typename T>
__global__ void edges_kernel(const T* __restrict__ h,
                             const T* __restrict__ mask_t,
                             T* __restrict__ hm, T* __restrict__ hp,
                             int nk, int nj, int ni, int axis, T h_min2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ni || j >= nj) return;
  const Line L = axis == 0 ? make_line(i, ni, 1) : make_line(j, nj, ni);
  const long plane = (long)nj * ni;
  const long c = (long)j * ni + i;
  for (int k = 0; k < nk; ++k) {
    T a, b;
    ppm_edges(h + k * plane + c, mask_t + c, L, h_min2, a, b);
    hm[k * plane + c] = a;
    hp[k * plane + c] = b;
  }
}

}  // namespace mom6
