// K1: one transport-matched PPM continuity sweep, and K2: the BT_cont
// face-area curve fit, for Hopper (sm_90a).
//
// K1 replaces the Pallas sweep _kernel_x / _kernel_x_tiled
// (mom6_tpu/core/continuity_pallas.py:193, :222, launched by _run_x,
// _run_y and _run_tiled).  K2 replaces _kernel_bt / _kernel_bt_tiled
// (:377, :400, launched by _run_btcont).  Plain twins:
// continuity_ppm / set_up_bt_cont in mom6_torch/core/continuity_ppm.py.
//
// What bounds them on an H100: K1 must move 6 layered fields (u, h,
// visc_rem in; h, uh, u_cor out: 24 bytes per layer and face in fp32)
// and does ~500 operations per layer and face (edges ~100, 7 flux
// evaluations ~57 each, the divergence): ~21 per byte, at the card's
// fp32 balance point (67 TFLOP/s over 3.35 TB/s = 20 per byte), so
// bytes and operations bound it about equally.  K2 reads 5 layered
// fields and writes only 12 planes, with 6 flux passes per direction:
// ~45 operations per byte, bounded by operations.  chip_smoke.py
// computes both bounds from the shapes.
//
// Design: one thread per face column (j, i), looping over layers, with
// the Newton correction du kept in a register across the fixed
// iteration count.  The edge values come from a first pass written to
// scratch; every Newton iteration re-reads the column (u, h, visc_rem
// and the edges) from L1/L2 instead of recomputing the 5-point
// stencil, so device memory sees each field about once.  The y sweep
// reads strided memory (stride ni) instead of transposing.  Neighbours
// wrap at the array edge like torch.roll, so the kernels cover the
// whole padded array, halos included, and need no padding to any tile.
#include <cuda_runtime.h>

#include "ppm.cuh"

namespace {

using namespace mom6;

// face-column data for direction ``axis`` at (j, i)
template <typename T>
__device__ inline Face<T> make_face(const T* u, const T* h, const T* hm,
                                    const T* hp, const T* vr,
                                    const T* dlen, const T* Idx,
                                    const T* mask_f, const T* dx_face,
                                    int nk, int nj, int ni, int axis,
                                    int i, int j, T dt, T cfl_limit) {
  const long c = (long)j * ni + i;
  const Line L = axis == 0 ? make_line(i, ni, 1) : make_line(j, nj, ni);
  Face<T> F;
  F.u = u + c;
  F.h = h + c;
  F.hm = hm + c;
  F.hp = hp + c;
  F.vr = vr + c;
  F.dlen = dlen[c];
  F.Idx_up = Idx[c];
  F.Idx_dn = Idx[c + L.at(1)];
  F.mask = mask_f[c];
  F.du_lim = cfl_limit * dx_face[c] / dt;
  F.dn = L.at(1);
  F.plane = (long)nj * ni;
  F.nk = nk;
  return F;
}

// K1 flux pass: Newton-match the column transport to hbt, then write
// the final flux and the corrected velocity of every layer
template <typename T>
__global__ void sweep_flux_kernel(const T* __restrict__ u,
                                  const T* __restrict__ h,
                                  const T* __restrict__ hm,
                                  const T* __restrict__ hp,
                                  const T* __restrict__ vr,
                                  const T* __restrict__ hbt,
                                  const T* __restrict__ dlen,
                                  const T* __restrict__ Idx,
                                  const T* __restrict__ mask_f,
                                  const T* __restrict__ dx_face,
                                  T* __restrict__ flux_out,
                                  T* __restrict__ ucor_out,
                                  int nk, int nj, int ni, int axis,
                                  int newton_iters, T dt, T cfl_limit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ni || j >= nj) return;
  const Face<T> F = make_face(u, h, hm, hp, vr, dlen, Idx, mask_f,
                              dx_face, nk, nj, ni, axis, i, j, dt,
                              cfl_limit);
  const long c = (long)j * ni + i;
  const T target = hbt[c];
  T du = T(0);
  for (int it = 0; it < newton_iters; ++it) {
    T sf, sd;
    column_flux(F, du, dt, sf, sd);
    du = newton_step(du, sf, sd, target, F.du_lim);
  }
  for (int k = 0; k < nk; ++k) {
    const long o = k * F.plane;
    T v = F.vr[o];
    T ucor = F.u[o] + v * du;
    T f, d;
    ppm_flux(ucor, F.h[o], F.hm[o], F.hp[o], F.h[o + F.dn],
             F.hm[o + F.dn], F.hp[o + F.dn], dt, F.dlen, F.Idx_up,
             F.Idx_dn, F.mask, v, f, d);
    flux_out[c + o] = f;
    ucor_out[c + o] = ucor;
  }
}

// K1 divergence pass: h - dt*Iarea*(F - F[-1]), floored at h_min
template <typename T>
__global__ void sweep_div_kernel(const T* __restrict__ h,
                                 const T* __restrict__ flux,
                                 const T* __restrict__ iarea,
                                 T* __restrict__ h_out,
                                 int nk, int nj, int ni, int axis, T dt,
                                 T h_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ni || j >= nj) return;
  const Line L = axis == 0 ? make_line(i, ni, 1) : make_line(j, nj, ni);
  const long plane = (long)nj * ni;
  const long c = (long)j * ni + i;
  const T dtI = dt * iarea[c];
  for (int k = 0; k < nk; ++k) {
    const long o = k * plane + c;
    h_out[o] = tmax(h[o] - dtI * (flux[o] - flux[o + L.at(-1)]), h_min);
  }
}

// one direction of the BT_cont fit; the six outputs are, in order,
// FA_far_neg, FA_0_neg, FA_0_pos, FA_far_pos, u_turn_neg, u_turn_pos
template <typename T> struct BtDir {
  const T *u, *vr, *hm, *hp, *dlen, *Idx, *mask_f, *dx_face;
  T* out[6];
  int axis;
};

template <typename T> struct BtArgs {
  BtDir<T> d[2];
  const T* h;
};

// the secant-regularised cubic-to-linear transition fit (plain: fit()
// inside _bt_cont_1dir)
template <typename T>
__device__ inline void bt_fit(T d_probe, T uh_tot, T fa_far, T fa_0,
                              T& fa0_adj, T& u_turn) {
  T d_safe = d_probe != T(0) ? d_probe : T(1.0);
  T fa_avg = d_probe != T(0) ? uh_tot / d_safe : fa_0;
  T hi = tmax(fa_0, fa_far);
  T lo = tmin(fa_0, fa_far);
  fa0_adj = fa_avg < lo ? fa_avg : fa_0;
  fa_avg = tclip(fa_avg, lo, hi);
  T denom = fa_far - fa0_adj;
  bool degen = fabs(denom) <= T(1e-12) * fabs(fa0_adj);
  u_turn = degen ? T(0)
      : (T(1.5) * d_probe) * ((fa_far - fa_avg) / denom);
}

// K2: both directions in one launch (blockIdx.z selects x or y)
template <typename T>
__global__ void bt_cont_kernel(BtArgs<T> A, int nk, int nj, int ni, T dt,
                               T cfl_limit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ni || j >= nj) return;
  const BtDir<T>& D = A.d[blockIdx.z];
  const Face<T> F = make_face(D.u, A.h, D.hm, D.hp, D.vr, D.dlen, D.Idx,
                              D.mask_f, D.dx_face, nk, nj, ni, D.axis, i,
                              j, dt, cfl_limit);
  const long c = (long)j * ni + i;
  T sf, sd;
  T du0 = T(0);
  for (int it = 0; it < 3; ++it) {
    column_flux(F, du0, dt, sf, sd);
    du0 = newton_step(du0, sf, sd, T(0), F.du_lim);
  }
  const T du_max = F.du_lim;
  const T du_cfl = T(1.0e-6) * D.dx_face[c] / dt;
  T vr_max = F.vr[0];
  for (int k = 1; k < nk; ++k) vr_max = tmax(vr_max, F.vr[k * F.plane]);
  T duL_req = T(0), duR_req = T(0);
  for (int k = 0; k < nk; ++k) {
    const long o = k * F.plane;
    T vr = F.vr[o], u = F.u[o];
    T vr_lim = tmax(vr, T(0.1) * vr_max) + T(1e-30);
    T l = (du_cfl * vr - u) / vr_lim;
    T r = -(u + du_cfl * vr) / vr_lim;
    duL_req = k == 0 ? l : tmax(duL_req, l);
    duR_req = k == 0 ? r : tmin(duR_req, r);
  }
  const T duL = tclip(tmax(du0 + du_cfl, duL_req), T(0), du_max);
  const T duR = tclip(tmin(du0 - du_cfl, duR_req), -du_max, T(0));
  T fa_0, uh_l, fa_l, uh_r, fa_r;
  column_flux(F, du0, dt, sf, fa_0);
  column_flux(F, duL, dt, uh_l, fa_l);
  column_flux(F, duR, dt, uh_r, fa_r);
  T fa_w0, u_ww, fa_e0, u_ee;
  bt_fit(duL - du0, uh_l, fa_l, fa_0, fa_w0, u_ww);
  bt_fit(duR - du0, uh_r, fa_r, fa_0, fa_e0, u_ee);
  D.out[0][c] = fa_r;
  D.out[1][c] = fa_e0;
  D.out[2][c] = fa_w0;
  D.out[3][c] = fa_l;
  D.out[4][c] = tmin(u_ee, T(0));
  D.out[5][c] = tmax(u_ww, T(0));
}

dim3 grid2d(int nj, int ni, dim3 block, int nz = 1) {
  return dim3((ni + block.x - 1) / block.x, (nj + block.y - 1) / block.y,
              nz);
}

template <typename T>
int run_sweep(const void* u, const void* h, const void* vr,
              const void* hbt, const void* dlen, const void* Idx,
              const void* iarea, const void* mask_f, const void* dx_face,
              const void* mask_t, void* hm, void* hp, void* h_out,
              void* flux_out, void* ucor_out, int nk, int nj, int ni,
              int axis, int newton_iters, double dt, double cfl_limit,
              double h_min, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid = grid2d(nj, ni, block);
  edges_kernel<T><<<grid, block, 0, s>>>(
      (const T*)h, (const T*)mask_t, (T*)hm, (T*)hp, nk, nj, ni, axis,
      T(2.0 * h_min));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sweep_flux_kernel<T><<<grid, block, 0, s>>>(
      (const T*)u, (const T*)h, (const T*)hm, (const T*)hp,
      (const T*)vr, (const T*)hbt, (const T*)dlen, (const T*)Idx,
      (const T*)mask_f, (const T*)dx_face, (T*)flux_out, (T*)ucor_out,
      nk, nj, ni, axis, newton_iters, T(dt), T(cfl_limit));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sweep_div_kernel<T><<<grid, block, 0, s>>>(
      (const T*)h, (const T*)flux_out, (const T*)iarea, (T*)h_out, nk,
      nj, ni, axis, T(dt), T(h_min));
  return cudaGetLastError();
}

// ptrs: per direction (x then y) u, vr, dlen, Idx, mask_f, dx_face,
// hm, hp, then its six outputs (14 each); ptrs[28] = h, ptrs[29] = mask_t
template <typename T>
int run_bt_cont(void* const* ptrs, int nk, int nj, int ni, double dt,
                double cfl_limit, double h_min, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const T* h = (const T*)ptrs[28];
  const T* mask_t = (const T*)ptrs[29];
  BtArgs<T> A;
  A.h = h;
  for (int a = 0; a < 2; ++a) {
    void* const* p = ptrs + 14 * a;
    BtDir<T>& D = A.d[a];
    D.u = (const T*)p[0];
    D.vr = (const T*)p[1];
    D.dlen = (const T*)p[2];
    D.Idx = (const T*)p[3];
    D.mask_f = (const T*)p[4];
    D.dx_face = (const T*)p[5];
    D.hm = (const T*)p[6];
    D.hp = (const T*)p[7];
    for (int o = 0; o < 6; ++o) D.out[o] = (T*)p[8 + o];
    D.axis = a;
    edges_kernel<T><<<grid2d(nj, ni, block), block, 0, s>>>(
        h, mask_t, (T*)p[6], (T*)p[7], nk, nj, ni, a, T(2.0 * h_min));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  bt_cont_kernel<T><<<grid2d(nj, ni, block, 2), block, 0, s>>>(
      A, nk, nj, ni, T(dt), T(cfl_limit));
  return cudaGetLastError();
}

}  // namespace

#define SWEEP_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* u, const void* h, const void* vr,      \
                      const void* hbt, const void* dlen, const void* Idx, \
                      const void* iarea, const void* mask_f,              \
                      const void* dx_face, const void* mask_t, void* hm,  \
                      void* hp, void* h_out, void* flux_out,              \
                      void* ucor_out, int nk, int nj, int ni, int axis,   \
                      int newton_iters, double dt, double cfl_limit,      \
                      double h_min, void* stream) {                       \
    return run_sweep<T>(u, h, vr, hbt, dlen, Idx, iarea, mask_f, dx_face, \
                        mask_t, hm, hp, h_out, flux_out, ucor_out, nk, nj, \
                        ni, axis, newton_iters, dt, cfl_limit, h_min,     \
                        stream);                                          \
  }

SWEEP_ENTRY(ppm_sweep_f32, float)
SWEEP_ENTRY(ppm_sweep_f64, double)

extern "C" int bt_cont_f32(void* const* ptrs, int nk, int nj, int ni,
                           double dt, double cfl_limit, double h_min,
                           void* stream) {
  return run_bt_cont<float>(ptrs, nk, nj, ni, dt, cfl_limit, h_min, stream);
}

extern "C" int bt_cont_f64(void* const* ptrs, int nk, int nj, int ni,
                           double dt, double cfl_limit, double h_min,
                           void* stream) {
  return run_bt_cont<double>(ptrs, nk, nj, ni, dt, cfl_limit, h_min,
                             stream);
}
