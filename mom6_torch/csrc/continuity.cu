// K1: one transport-matched PPM continuity sweep, and K2: the BT_cont
// face-area curve fit, for Hopper (sm_90a).
//
// K1 replaces the Pallas sweep _kernel_x / _kernel_x_tiled
// (mom6_tpu/core/continuity_pallas.py:193, :222, launched by _run_x,
// _run_y and _run_tiled).  K2 replaces _kernel_bt / _kernel_bt_tiled
// (:377, :400, launched by _run_btcont).  Plain twins:
// continuity_ppm / set_up_bt_cont in mom6_torch/core/continuity_ppm.py.
//
// What bounds them on an H100.  K1 must move 6 layered fields (u, h,
// visc_rem in; h, uh, u_cor out: 24 bytes per layer and face in fp32)
// and does ~350 operations per layer and face (edges ~100, 7 flux
// evaluations ~35 each from the upwind cell, the divergence): bounded
// by bytes (chip_smoke.py: 0.051 ms at 25x520x520 fp32).  K2 reads 5
// layered fields and writes only 12 planes, with 6 flux evaluations per
// layer and direction: bounded by operations (0.065 ms).
//
// The modes (both kernels): the edge scheme (PPM with the
// positive-definite limiter, upwind_1st, simple_2nd, or PPM with the
// Colella-Woodward limiter: ppm.cuh EdgeScheme) is a uniform branch of
// the edge pass, and the volume-based CFL (vol_cfl) only changes the two
// CFL factors of a face, once per thread; every scheme reads at most
// two cells to each side, so the one stencil halo and tile plan serve
// them all.  K1 also has an untargeted instance (no uhbt: the plain
// version's flux at u, visc_rem = 1), which the unsplit and RK2b
// steppers call: one pass, no Newton iteration, and it moves 4 layered
// fields (u, h in; h, uh out), a bound of ~0.032 ms at 25x520x520 fp32.
//
// Porous faces (a grid with subgrid topography, SUBGRID_TOPO_AT_VEL):
// the face mask of each layer is the plain mask times the layer's open
// fraction, which the wrapper computes from the h entering the sweep
// (core/porous_barriers.py) and passes as one more layered input.  The
// porous instances (template POROUS) stage it beside the tile's other
// records, one more value a cell and layer (a region of its own, so the
// five-value records and the non-porous instances stay as they are), and
// every flux pass multiplies the mask by it, operand for operand as
// _flux_1dir does mask * por: the porous sweep reads one more layered
// field (+27 MB at 25x520x520 fp32).  K2 ignores porous faces, as the
// JAX package's set_up_bt_cont does.
//
// What limited the first design: device-memory traffic from re-reading.
// It ran K1 as three launches (edge values to scratch planes, a flux
// pass of one thread per face column, a divergence pass) and K2 as three
// (two edge passes, the fit), each Newton pass re-reading five layered
// fields (~135 MB at 25x520x520 fp32, past the 50 MB L2) from HBM:
// torch.profiler gave the flux pass 0.478 ms of a 0.566 ms sweep and
// the fit 0.673 ms of a 0.784 ms call (PERF.md).
//
// This design: one launch per K1 sweep and one per K2 call (both
// directions, the block index picks one), each block owning a tile of
// face columns.  A block copies (cp.async) its tile's h and cell mask
// with the stencil halo, u and visc_rem into shared memory, computes the
// PPM edges there, and runs every Newton iteration and probe from shared
// memory: each layered input leaves device memory once (the halo cells
// a second time, from L2), each output is written once, and the edge
// values never reach device memory.  A tile spans ``faces`` faces along
// the sweep: faces a-1 .. a+faces-2 for the cells a .. a+faces-2, so
// face a-1's flux, recomputed in the block, feeds the divergence of
// cell a and K1 needs no second launch; it needs h at cells
// a-3 .. a+faces+1.  Layout (a) of the two considered: one thread per
// face column, looping over the layers in shared memory.  It keeps the
// plain version's k = 0, 1, ... layer sums in one thread, so the
// kernels stay bitwise equal to the plain versions with no reduction
// across threads, and it needs no registers per layer: a deep column
// costs shared memory, not registers, and shared memory is the larger
// store (227 KB a block against 256 KB of registers an SM shared by all
// its threads).  Across the sweep the lanes run along i in both
// directions (x: a row of faces; y: ``across`` columns of i), so every
// copy is coalesced and the y sweep needs no transpose.  A cell-layer is
// one record of five values (h, its edges, u and visc_rem of its face),
// so a thread reaches its face and both cells from one index, and each
// thread copies its own records: no index is divided.  The plain
// version evaluates both upwind branches of each flux and selects one;
// ppm_flux reads only the upwind cell, without a branch, so the compiler
// interleaves the layers.  A column that does not fit the shared memory
// at the tile chosen is staged in chunks of ``layers`` layers,
// re-staged (and its edges recomputed) for each pass: no shape is
// refused.  The tile plan comes from tile_plan in
// core/continuity_cuda.py, which the CPU tests check.  Neighbours wrap
// at the array edge like torch.roll, so the kernels cover the whole
// padded array, halos included.
//
// What limits it now (PERF.md; mom6_torch.continuity_tiles on an H100
// at 25x520x520 fp32): the phases of a tile run one after another at
// ~12 resident warps an SM (shared memory holds ~450 face columns of 25
// layers) and add up: in an x / y sweep a Newton pass takes ~10 / 14
// us, the edge values ~22 / 63 us, the copies ~47 / 90 us, the stores
// ~30 us (the y tile's stencil halo costs it more).  Two buffers a
// block (the next tile's copies in flight while one computes) halved
// the resident threads and ran slower; copies cut into layer groups,
// with each group's edges and first pass run as it lands, gained
// nothing.
#include <cuda_runtime.h>

#include "ppm.cuh"

namespace {

using namespace mom6;

constexpr int MAX_THREADS = 512;

// the tile of one direction (tile_plan in core/continuity_cuda.py)
struct Tile {
  int faces;    // faces along the sweep; the first only feeds the divergence
  int across;   // face columns across the sweep (x: rows j; y: columns i)
  int layers;   // layers staged at once
  int blocks;   // tiles of this direction
};

// a staged cell-layer: its thickness and edge values (read by ppm_flux as
// three consecutive values), and u and visc_rem of its face (the face at
// the cell's own index)
enum { H, HM, HP, U, VR, RS };

// shared elements of a tile: a record of each of its faces+5 cells (a-3
// .. a+faces+1) and staged layer, and the cell mask; with ``porous`` the
// open fractions of the faces too, one value a cell and staged layer
__host__ __device__ inline long stage_elems(const Tile& t, bool porous) {
  return (long)t.across * (t.faces + 5)
      * ((RS + porous) * (long)t.layers + 1);
}

template <typename T>
__device__ inline void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// one block's tile of direction AXIS (0: x, along i; 1: y, along j) and
// its thread's face column.  Position s along the tile is cell a-3+s;
// face a-1+p, this thread's, is the east (north) face of the cell at
// position p+2.  Shared records are indexed by (layer k, position s,
// column q across), the lanes' axis fastest; each thread stages and
// updates the records of its own position, so no index is divided.
template <typename T, int AXIS> struct Geo {
  int NF, Q, KC;   // faces, across, layers of the tile
  int n, m, ni;    // cells along and across the sweep; row length
  long plane;
  int a, q0;       // first cell the tile updates; first column across
  int p, q;        // this thread: face a-1+p, column q0+q
  T *rec, *mask, *frac;   // frac: the faces' open fractions (porous)

  __device__ Geo(const Tile& t, int tile, int nj, int ni_, T* smem)
      : NF(t.faces), Q(t.across), KC(t.layers), n(AXIS ? nj : ni_),
        m(AXIS ? ni_ : nj), ni(ni_), plane((long)nj * ni_) {
    const int along = (n + NF - 2) / (NF - 1);
    a = (tile % along) * (NF - 1);
    q0 = (tile / along) * Q;
    const int tid = threadIdx.x;
    p = AXIS ? tid / Q : tid % NF;
    q = AXIS ? tid % Q : tid / NF;
    rec = smem;
    mask = rec + RS * KC * Q * (NF + 5);
    frac = mask + Q * (NF + 5);
  }
  // element index of (k, s, q)
  __device__ int at(int k, int s) const {
    return AXIS ? (k * (NF + 5) + s) * Q + q : (k * Q + q) * (NF + 5) + s;
  }
  // elements from one layer to the next, and to the next position along
  __device__ int layer() const { return Q * (NF + 5); }
  __device__ int dn() const { return AXIS ? Q : 1; }
  // plane index of position s and this thread's column (wrapped along
  // like torch.roll; clamped across)
  __device__ long g2(int s) const {
    int x = (a - 3 + s) % n;
    x = x < 0 ? x + n : x;
    const int y = min(q0 + q, m - 1);
    return AXIS ? (long)x * ni + y : (long)y * ni + x;
  }
  // the positions other than p+2 whose h this thread stages: 0, 1 and
  // NF+2 .. NF+4, dealt out over the threads of the row
  __device__ int extra(int x) const { return x < 2 ? x : NF + x; }
  // whether this thread writes its face and cell
  __device__ bool owner() const {
    return p >= 1 && a - 1 + p < n && q0 + q < m;
  }
};

template <typename T, int AXIS>
__device__ void stage_mask(const Geo<T, AXIS>& G, const T* mask_t) {
  cp_async(G.mask + G.at(0, G.p + 2), mask_t + G.g2(G.p + 2));
  for (int x = G.p; x < 5; x += G.NF)
    cp_async(G.mask + G.at(0, G.extra(x)), mask_t + G.g2(G.extra(x)));
}

// the edge values of the cell at position s, layer k, in edge scheme
// ``scheme`` (ppm.cuh EdgeScheme)
template <typename T, int AXIS>
__device__ inline void edges_at(const Geo<T, AXIS>& G, int k, int s,
                                T h_min2, int scheme) {
  T hv[5], mv[5];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    hv[d] = G.rec[RS * G.at(k, s - 2 + d) + H];
    mv[d] = G.mask[G.at(0, s - 2 + d)];
  }
  T* r = G.rec + RS * G.at(k, s);
  ppm_edges(hv, mv, h_min2, scheme, r[HM], r[HP]);
}

// layers [c0, c0 + kc) of the tile on chip: h of positions 0 .. NF+4,
// u (and, with WITH_VR, visc_rem; with POROUS, the open fraction) of the
// faces, then the edge values of positions 2 .. NF+2 (cells a-1 ..
// a+NF-1).  Every edge scheme reads at most two cells to each side, so
// one stencil halo serves them all
template <typename T, int AXIS, bool WITH_VR, bool POROUS>
__device__ void stage(const Geo<T, AXIS>& G, const T* h, const T* u,
                      const T* vr, const T* por, int c0, int kc, T h_min2,
                      int scheme) {
  __syncthreads();   // the previous chunk is no longer read
  const int s = G.p + 2, ls = RS * G.layer();
  const long g = c0 * G.plane + G.g2(s);
  T* r = G.rec + RS * G.at(0, s);
  T* f = G.frac + G.at(0, s);
  for (int k = 0; k < kc; ++k, r += ls, f += G.layer()) {
    const long o = g + k * G.plane;
    cp_async(r + H, h + o);
    cp_async(r + U, u + o);
    if (WITH_VR) cp_async(r + VR, vr + o);
    if (POROUS) cp_async(f, por + o);
  }
  for (int x = G.p; x < 5; x += G.NF) {
    const long gx = c0 * G.plane + G.g2(G.extra(x));
    T* rx = G.rec + RS * G.at(0, G.extra(x));
    for (int k = 0; k < kc; ++k, rx += ls)
      cp_async(rx + H, h + gx + k * G.plane);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < kc; ++k) edges_at(G, k, s, h_min2, scheme);
  for (int k = G.p; k < kc; k += G.NF)
    edges_at(G, k, G.NF + 2, h_min2, scheme);
  __syncthreads();
}

// the face constants of staged layer k: with POROUS the mask times the
// layer's open fraction (plain: mask2dCu * por)
template <typename T, int AXIS, bool POROUS>
__device__ inline FaceConst<T> layer_const(const Geo<T, AXIS>& G,
                                           const FaceConst<T>& F, int k) {
  if (!POROUS) return F;
  FaceConst<T> Fk = F;
  Fk.mask = F.mask * G.frac[G.at(k, G.p + 2)];
  return Fk;
}

// the staged layers' flux and dflux/du at the correction du, added in
// layer order to sf and sd
template <typename T, int AXIS, bool POROUS>
__device__ inline void column_sums(const Geo<T, AXIS>& G, int kc, T du,
                                   const FaceConst<T>& F, T dt, T& sf,
                                   T& sd) {
  const int dn = RS * G.dn(), ls = RS * G.layer();
  const T* r = G.rec + RS * G.at(0, G.p + 2);
#pragma unroll 4
  for (int k = 0; k < kc; ++k, r += ls) {
    const T vr = r[VR];
    T f, d;
    ppm_flux(r[U] + vr * du, vr, r, dn, layer_const<T, AXIS, POROUS>(G, F, k),
             dt, f, d);
    sf = sf + f;
    sd = sd + d;
  }
}

// the face's constants; with ``vol_cfl`` the CFL factors are dlen*Iarea
// of the cells up and down (plain: (dlen_face * Iarea_up), ...)
template <typename T, int AXIS>
__device__ inline FaceConst<T> face_const(const Geo<T, AXIS>& G,
                                          const T* dlen, const T* Idx,
                                          const T* iarea, const T* mask_f,
                                          bool vol_cfl) {
  const long c = G.g2(G.p + 2), cn = G.g2(G.p + 3);
  const T dl = dlen[c];
  if (vol_cfl) return FaceConst<T>{dl, dl * iarea[c], -(dl * iarea[cn]),
                                   mask_f[c]};
  return FaceConst<T>{dl, Idx[c], -Idx[cn], mask_f[c]};
}

template <typename T> struct SweepArgs {
  const T *u, *h, *vr, *hbt, *dlen, *Idx, *iarea, *mask_f, *dx_face,
      *mask_t, *por;
  T *h_out, *flux, *ucor, *du;
  int nk, nj, ni, newton_iters, scheme, vol_cfl;
  T dt, cfl_limit, h_min, h_min2;
};

// K1: with TARGETED, Newton-match each column's transport to hbt, then
// write the final flux, the corrected velocity, the correction du and
// h - dt*Iarea*(F - F[-1]) >= h_min.  Without (the untargeted sweep of
// the unsplit and RK2b steppers: plain zonal_mass_flux with uhbt None)
// one pass at u: the flux and h alone, no visc_rem read.  The two are
// separate instances, so the targeted sweep keeps its registers; so are
// the POROUS ones, which read the faces' open fractions (A.por).
template <typename T, int AXIS, bool TARGETED, bool POROUS>
__global__ void __launch_bounds__(MAX_THREADS)
    sweep_kernel(SweepArgs<T> A, Tile t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geo<T, AXIS> G(t, blockIdx.x, A.nj, A.ni,
                       reinterpret_cast<T*>(smem_raw));
  stage_mask(G, A.mask_t);
  const long c = G.g2(G.p + 2);
  const FaceConst<T> F = face_const(G, A.dlen, A.Idx, A.iarea, A.mask_f,
                                    A.vol_cfl != 0);
  const T du_lim = TARGETED ? A.cfl_limit * A.dx_face[c] / A.dt : T(0);
  const T target = TARGETED ? A.hbt[c] : T(0);
  const T dtI = A.dt * A.iarea[c];
  const bool own = G.owner();
  const bool restage = G.KC < A.nk;
  const int dn = RS * G.dn(), ls = RS * G.layer();
  const int iters = TARGETED ? A.newton_iters : 0;
  T du = T(0);
  for (int it = 0; it <= iters; ++it) {
    T sf = T(0), sd = T(0);
    for (int c0 = 0; c0 < A.nk; c0 += G.KC) {
      const int kc = min(G.KC, A.nk - c0);
      if (restage || it == 0)
        stage<T, AXIS, TARGETED, POROUS>(G, A.h, A.u, A.vr, A.por, c0, kc,
                                         A.h_min2, A.scheme);
      if (it < iters) {
        column_sums<T, AXIS, POROUS>(G, kc, du, F, A.dt, sf, sd);
        continue;
      }
      // final pass: the flux replaces u in shared memory for the
      // divergence, which needs the face before as well
      T* r = G.rec + RS * G.at(0, G.p + 2);
      long o = c0 * G.plane + c;
      for (int k = 0; k < kc; ++k, r += ls, o += G.plane) {
        const T vr = TARGETED ? r[VR] : T(1);
        const T ucor = TARGETED ? r[U] + vr * du : r[U];
        T f, d;
        ppm_flux(ucor, vr, r, dn, layer_const<T, AXIS, POROUS>(G, F, k),
                 A.dt, f, d);
        if (own) {
          A.flux[o] = f;
          if (TARGETED) A.ucor[o] = ucor;
        }
        r[U] = f;
      }
      __syncthreads();
      if (own) {
        r = G.rec + RS * G.at(0, G.p + 2);
        o = c0 * G.plane + c;
        for (int k = 0; k < kc; ++k, r += ls, o += G.plane)
          A.h_out[o] = tmax(r[H] - dtI * (r[U] - r[U - dn]), A.h_min);
      }
    }
    if (it < iters) du = newton_step(du, sf, sd, target, du_lim);
  }
  if (TARGETED && own) A.du[c] = du;
}

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

// one direction of the BT_cont fit; the six outputs are, in order,
// FA_far_neg, FA_0_neg, FA_0_pos, FA_far_pos, u_turn_neg, u_turn_pos
template <typename T> struct BtDir {
  const T *u, *vr, *dlen, *Idx, *mask_f, *dx_face;
  T* out[6];
  Tile tile;
};

template <typename T> struct BtArgs {
  BtDir<T> d[2];
  const T *h, *mask_t, *iarea;
  int nk, nj, ni, scheme, vol_cfl;
  T dt, cfl_limit, h_min2;
};

// K2 on one tile of direction AXIS: 3 Newton steps for the
// zero-transport correction du0 (the first also takes max_k visc_rem,
// the second the CFL limits of the probes, which do not depend on du0),
// then one pass for the three probes
template <typename T, int AXIS>
__device__ void bt_cont_tile(const BtArgs<T>& A, const BtDir<T>& D,
                             int tile, T* smem) {
  const Geo<T, AXIS> G(D.tile, tile, A.nj, A.ni, smem);
  stage_mask(G, A.mask_t);
  const long c = G.g2(G.p + 2);
  const FaceConst<T> F = face_const(G, D.dlen, D.Idx, A.iarea, D.mask_f,
                                    A.vol_cfl != 0);
  const T du_max = A.cfl_limit * D.dx_face[c] / A.dt;
  const T du_cfl = T(1.0e-6) * D.dx_face[c] / A.dt;
  const bool restage = G.KC < A.nk;
  const int dn = RS * G.dn(), ls = RS * G.layer();
  T* const r0 = G.rec + RS * G.at(0, G.p + 2);
  T du0 = T(0), vr_max = T(0), duL_req = T(0), duR_req = T(0);
  for (int it = 0; it < 3; ++it) {
    T sf = T(0), sd = T(0);
    for (int c0 = 0; c0 < A.nk; c0 += G.KC) {
      const int kc = min(G.KC, A.nk - c0);
      if (restage || it == 0)
        stage<T, AXIS, true, false>(G, A.h, D.u, D.vr, nullptr, c0, kc,
                                    A.h_min2, A.scheme);
      column_sums<T, AXIS, false>(G, kc, du0, F, A.dt, sf, sd);
      const T* r = r0;
      for (int k = 0; k < kc && it < 2; ++k, r += ls) {
        const T vr = r[VR];
        if (it == 0) {
          vr_max = c0 + k == 0 ? vr : tmax(vr_max, vr);
          continue;
        }
        const T u = r[U];
        const T vr_lim = tmax(vr, T(0.1) * vr_max) + T(1e-30);
        const T l = (du_cfl * vr - u) / vr_lim;
        const T rr = -(u + du_cfl * vr) / vr_lim;
        duL_req = c0 + k == 0 ? l : tmax(duL_req, l);
        duR_req = c0 + k == 0 ? rr : tmin(duR_req, rr);
      }
    }
    du0 = newton_step(du0, sf, sd, T(0), du_max);
  }
  const T duL = tclip(tmax(du0 + du_cfl, duL_req), T(0), du_max);
  const T duR = tclip(tmin(du0 - du_cfl, duR_req), -du_max, T(0));
  // the three probes in one pass over the column
  T fa_0 = T(0), uh_l = T(0), fa_l = T(0), uh_r = T(0), fa_r = T(0);
  for (int c0 = 0; c0 < A.nk; c0 += G.KC) {
    const int kc = min(G.KC, A.nk - c0);
    if (restage)
      stage<T, AXIS, true, false>(G, A.h, D.u, D.vr, nullptr, c0, kc,
                                  A.h_min2, A.scheme);
    const T* r = r0;
#pragma unroll 2
    for (int k = 0; k < kc; ++k, r += ls) {
      const T u = r[U], vr = r[VR];
      T f, d;
      ppm_flux(u + vr * du0, vr, r, dn, F, A.dt, f, d);
      fa_0 = fa_0 + d;
      ppm_flux(u + vr * duL, vr, r, dn, F, A.dt, f, d);
      uh_l = uh_l + f;
      fa_l = fa_l + d;
      ppm_flux(u + vr * duR, vr, r, dn, F, A.dt, f, d);
      uh_r = uh_r + f;
      fa_r = fa_r + d;
    }
  }
  T fa_w0, u_ww, fa_e0, u_ee;
  bt_fit(duL - du0, uh_l, fa_l, fa_0, fa_w0, u_ww);
  bt_fit(duR - du0, uh_r, fa_r, fa_0, fa_e0, u_ee);
  if (!G.owner()) return;
  D.out[0][c] = fa_r;
  D.out[1][c] = fa_e0;
  D.out[2][c] = fa_w0;
  D.out[3][c] = fa_l;
  D.out[4][c] = tmin(u_ee, T(0));
  D.out[5][c] = tmax(u_ww, T(0));
}

// K2: both directions in one launch, the x tiles first
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) bt_cont_kernel(BtArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x, bx = A.d[0].tile.blocks;
  if (b < bx)
    bt_cont_tile<T, 0>(A, A.d[0], b, smem);
  else
    bt_cont_tile<T, 1>(A, A.d[1], b - bx, smem);
}

// the plan's tile is the one the kernels assume
bool tile_ok(const Tile& t, int n, int m, int nk, int threads) {
  return t.faces >= 2 && t.across >= 1 && t.faces * t.across == threads
      && threads <= MAX_THREADS && t.layers >= 1 && t.layers <= nk
      && (long)t.blocks == (long)((n + t.faces - 2) / (t.faces - 1))
             * ((m + t.across - 1) / t.across);
}

template <typename K>
cudaError_t prepare(K kern, long smem_bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
}

template <typename T>
int run_sweep(const void* const* ptrs, int nk, int nj, int ni, int axis,
              int newton_iters, int targeted, int scheme, int vol_cfl,
              double dt, double cfl_limit, double h_min, Tile t,
              long smem_bytes, void* stream) {
  const int threads = t.faces * t.across;
  if (nk < 1 || axis < 0 || axis > 1 || scheme < EDGE_PPM
      || scheme > EDGE_MONOTONIC
      || !tile_ok(t, axis ? nj : ni, axis ? ni : nj, nk, threads)
      || smem_bytes != stage_elems(t, ptrs[14] != nullptr) * (long)sizeof(T))
    return cudaErrorInvalidValue;
  SweepArgs<T> A;
  const T** in[] = {&A.u, &A.h, &A.vr, &A.hbt, &A.dlen, &A.Idx, &A.iarea,
                    &A.mask_f, &A.dx_face, &A.mask_t};
  for (int k = 0; k < 10; ++k) *in[k] = (const T*)ptrs[k];
  A.por = (const T*)ptrs[14];
  A.h_out = (T*)ptrs[10];
  A.flux = (T*)ptrs[11];
  A.ucor = (T*)ptrs[12];
  A.du = (T*)ptrs[13];
  if (targeted && (!A.vr || !A.hbt || !A.dx_face || !A.ucor || !A.du))
    return cudaErrorInvalidValue;
  A.nk = nk;
  A.nj = nj;
  A.ni = ni;
  A.newton_iters = newton_iters;
  A.scheme = scheme;
  A.vol_cfl = vol_cfl;
  A.dt = T(dt);
  A.cfl_limit = T(cfl_limit);
  A.h_min = T(h_min);
  A.h_min2 = T(2.0 * h_min);
  auto kern = A.por
      ? (targeted ? (axis ? sweep_kernel<T, 1, true, true>
                          : sweep_kernel<T, 0, true, true>)
                  : (axis ? sweep_kernel<T, 1, false, true>
                          : sweep_kernel<T, 0, false, true>))
      : (targeted ? (axis ? sweep_kernel<T, 1, true, false>
                          : sweep_kernel<T, 0, true, false>)
                  : (axis ? sweep_kernel<T, 1, false, false>
                          : sweep_kernel<T, 0, false, false>));
  cudaError_t e = prepare(kern, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<t.blocks, threads, smem_bytes,
         static_cast<cudaStream_t>(stream)>>>(A, t);
  return cudaGetLastError();
}

// ptrs: per direction (x then y) u, vr, dlen, Idx, mask_f, dx_face, then
// its six outputs (12 each); ptrs[24] = h, ptrs[25] = mask_t,
// ptrs[26] = Iarea
template <typename T>
int run_bt_cont(void* const* ptrs, int nk, int nj, int ni, int scheme,
                int vol_cfl, double dt, double cfl_limit, double h_min,
                Tile tx, Tile ty, long smem_bytes, void* stream) {
  const int threads = tx.faces * tx.across;
  if (nk < 1 || scheme < EDGE_PPM || scheme > EDGE_MONOTONIC
      || !tile_ok(tx, ni, nj, nk, threads)
      || !tile_ok(ty, nj, ni, nk, threads)
      || smem_bytes != (long)sizeof(T)
             * (stage_elems(tx, false) > stage_elems(ty, false)
                    ? stage_elems(tx, false) : stage_elems(ty, false))
      || (long)tx.blocks + ty.blocks > 0x7fffffffL)
    return cudaErrorInvalidValue;
  BtArgs<T> A;
  for (int a = 0; a < 2; ++a) {
    void* const* p = ptrs + 12 * a;
    BtDir<T>& D = A.d[a];
    D.u = (const T*)p[0];
    D.vr = (const T*)p[1];
    D.dlen = (const T*)p[2];
    D.Idx = (const T*)p[3];
    D.mask_f = (const T*)p[4];
    D.dx_face = (const T*)p[5];
    for (int o = 0; o < 6; ++o) D.out[o] = (T*)p[6 + o];
    D.tile = a ? ty : tx;
  }
  A.h = (const T*)ptrs[24];
  A.mask_t = (const T*)ptrs[25];
  A.iarea = (const T*)ptrs[26];
  A.nk = nk;
  A.nj = nj;
  A.ni = ni;
  A.scheme = scheme;
  A.vol_cfl = vol_cfl;
  A.dt = T(dt);
  A.cfl_limit = T(cfl_limit);
  A.h_min2 = T(2.0 * h_min);
  cudaError_t e = prepare(bt_cont_kernel<T>, smem_bytes);
  if (e != cudaSuccess) return e;
  bt_cont_kernel<T><<<tx.blocks + ty.blocks, threads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(A);
  return cudaGetLastError();
}

}  // namespace

// the SM count and the opt-in shared memory of a block on ``device``
extern "C" int cont_device_info(int device, int* sms, int* smem_optin) {
  cudaError_t e = cudaDeviceGetAttribute(
      sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

extern "C" const char* cont_error_name(int e) {
  return cudaGetErrorName(static_cast<cudaError_t>(e));
}

// ptrs: u, h, visc_rem, hbt, dlen, Idx, Iarea, face mask, face spacing,
// cell mask in; h_out, flux, u_cor, du out (visc_rem, hbt, face spacing,
// u_cor and du null when not ``targeted``); then the faces' layered open
// fractions (null on a grid without porous faces).  opts: axis, newton_iters,
// targeted, edge scheme (ppm.cuh EdgeScheme), vol_cfl.  tile: faces,
// across, layers, blocks of tile_plan
#define SWEEP_ENTRY(NAME, T)                                              \
  extern "C" int NAME(void* const* ptrs, int nk, int nj, int ni,         \
                      const int* opts, double dt, double cfl_limit,       \
                      double h_min, const int* tile, long smem_bytes,     \
                      void* stream) {                                     \
    return run_sweep<T>(ptrs, nk, nj, ni, opts[0], opts[1], opts[2],     \
                        opts[3], opts[4], dt, cfl_limit, h_min,           \
                        Tile{tile[0], tile[1], tile[2], tile[3]},         \
                        smem_bytes, stream);                              \
  }

SWEEP_ENTRY(ppm_sweep_f32, float)
SWEEP_ENTRY(ppm_sweep_f64, double)

// tiles: the x tile then the y tile, four ints each as for a sweep
#define BT_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(void* const* ptrs, int nk, int nj, int ni,         \
                      int scheme, int vol_cfl, double dt,                 \
                      double cfl_limit, double h_min, const int* tiles,   \
                      long smem_bytes, void* stream) {                    \
    return run_bt_cont<T>(                                                \
        ptrs, nk, nj, ni, scheme, vol_cfl, dt, cfl_limit, h_min,          \
        Tile{tiles[0], tiles[1], tiles[2], tiles[3]},                     \
        Tile{tiles[4], tiles[5], tiles[6], tiles[7]}, smem_bytes,         \
        stream);                                                          \
  }

BT_ENTRY(bt_cont_f32, float)
BT_ENTRY(bt_cont_f64, double)
