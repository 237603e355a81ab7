// K3 and K3m: the barotropic subcycle for Hopper (sm_90a).
//
// K3 (bt_subcycle_*) replaces the Pallas subcycle kernel built by
// _make_kernel with march=False (mom6_tpu/core/barotropic_pallas.py:
// 164-342, launched by subcycle_pallas, :345): a width-3 halo refresh
// after every substep.  K3m (bt_march_*) replaces the same kernel with
// march=True (barotropic_pallas.py:232-240, called from
// mom6_tpu/core/barotropic.py:704-721): the arrays are widened to a
// halo of 3*period, the substeps of a chunk of ``period`` run with no
// refresh while the valid region shrinks 3 rings per substep, and the
// whole wide halo is refreshed on the chunk's last substep (the JAX
// package's fill_fn between chunks).  Plain twins: subcycle_plain and
// subcycle_march_plain in mom6_torch/core/barotropic_cuda.py, the
// _one/block loop of mom6_tpu/core/barotropic.py:624-698.
//
// What bounds it on an H100: the work of a subcycle is ~60 MB read or
// written once and ~1.4 Gop (32 substeps on 520x520 planes of 1.08 MB
// in fp32), ~21 us either way.  What a substep touches is the cost.  A
// design of four launches per substep (eta predictor, two velocities,
// eta corrector with the refresh and the sums) makes ~97 plane passes
// per substep, ~105 MB: the predictor 29 (every face's curve transport
// is evaluated at the face and again at its east or north neighbour, so
// all 22 curve and anchor planes are read), each velocity 14, the
// corrector 40 (the 22 curve planes again, and 5 of the 7 sums read and
// written).  Its working set, 42 constant, 10 state and sum and 3
// scratch planes (~59 MB), does not fit the 50 MB L2, so the constants
// stream from HBM every substep: ~3.4 GB per subcycle, ~1 ms at
// 3.35 TB/s, and the tail of 128 launches of 1,105 blocks each.
//
// Design: one persistent cooperative launch per subcycle, one block of
// THREADS threads per SM.  Block b owns the flat points
// [b*npb, (b+1)*npb) of the padded array for all substeps (flat bands,
// ~3.9 rows at 520x520 on 132 SMs, so that a band's curve planes fit
// shared memory at the main path's shapes), cut into tiles of PPT
// points a thread, and a grid-wide sync separates the phases of a
// substep:
//   (1) eta predictor -> d_eta (the divergence is taken from the face
//       transport planes, or reused from (4) when nothing was refreshed
//       since);
//   (2), (3) the two velocities, u first on even substeps, v first on
//       odd ones, each updated in place, with its face transport
//       evaluated once, at its owner, and written to a transport plane;
//   (4) eta corrector from the transport planes, the halo refresh of
//       the substep's width and the seven weighted sums.
// The refresh reproduces Domain.fill_halos (x first, then y): a halo
// cell copies its source's eta2, ubt2 and vbt2 (eta2 recomputed from
// the source's transports, which gives the same bits) and evaluates
// its own transports with its own curve constants; the transport
// planes are double-buffered across a refresh because the corrector of
// a neighbour still reads the unrefreshed ones.  That makes 4 grid
// syncs on a substep with a refresh and 3 without.  The transport
// constants of a block's points (22 curve and anchor planes, or Datu
// and Datv) are loaded into shared memory once per launch when they
// fit (fp32: ~180 KB at 520x520 on 132 SMs), else read from global
// memory (fp64 curve transports, or bands too long for shared memory);
// the 18 other constant planes and the 9 state planes (~30 MB) then
// fit in L2, and a substep makes ~43 plane passes, from L2.  When a
// band is one tile (up to THREADS*PPT points: the main path's shapes on
// 132 SMs), the seven sums, and each point's eta, velocities and
// transports, live in the owning thread's registers for the whole
// launch and the sums are written once at the end.  A longer band
// (wider grids, or cards with fewer SMs) runs the same phases tile by
// tile and keeps that state in the planes between phases: each phase
// reloads it and the sums are read and written every substep.
// Neighbours wrap at the array edge like torch.roll, so the kernel
// matches the plain loop on the whole padded array.  The filter weights
// come from a (4, total) buffer on the card, any number of substeps;
// every thread reads the same four values a substep.  The arithmetic per
// point is the plain version's, in its order (built with -fmad=false),
// so kernel and plain loop agree bit for bit.  Register spills go to
// L2 beside 180 KB of shared memory: each phase recomputes its
// addresses to keep the one-tile kernel free of them.
//
// Open faces (bt_subcycle_obc_*, the OBC template instance): the JAX
// package runs its jnp substep under open boundaries (barotropic.py:
// 651-670, with the Pallas kernel refused at barotropic_pallas.py:124,
// 142); its order is (a) Flather at the open faces with the substep's
// old eta, after both velocity updates, then the transports and the eta
// corrector, (b) the width-3 refresh, eta's edge value copied into the
// halo beyond each open edge inside its strip, and Flather again with
// that eta.  The instance adds a phase (3b) and a grid sync for (a): the
// inlet velocity of an N face lies a row away, in another band.  (b)
// runs inside (4) at each face's owner, which recomputes the inlet
// velocity and the extended eta it needs from their sources, as the
// refresh does; the faces' final velocities are held in two more planes
// and stored at the next substep's (1), after a grid sync, because a
// refresh in (4) may still read an interior face (E or N) as its source.
// The edge data (strip mask, Flather factor, external velocity and ssh)
// are vectors along each edge.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

enum {
  GTOT_E, GTOT_W, GTOT_N, GTOT_S, Q, DU_Q, DV_Q, COR_REF_U, COR_REF_V,
  BT_REM_U, BT_REM_V, BT_FORCE_U, BT_FORCE_V, ETA_PF, IDXCU, IDYCV,
  IAREAT, ETA_SRC, DATU, DATV, CU0, CV0 = CU0 + 10, UHBT0 = CV0 + 10,
  VHBT0, NCONST
};
enum { S_UHBT, S_VHBT, S_ETA, S_ACCEL_U, S_ACCEL_V, S_UBT, S_VBT, NSUM };
// open edges, and the vectors of each along it (padded rows of W/E,
// padded columns of S/N); null for a closed edge
enum { OW, OE, OS, ON, NEDGE };
enum { O_MASK, O_COEF, O_VEL, O_SSH, NOBCF };

constexpr int THREADS = 768;       // one block per SM, <= 80 registers
constexpr int PPT = 3;             // points per thread
constexpr int NCURVE = 22;         // CU0 .. VHBT0

template <typename T> struct Consts {
  const T* f[NCONST];
};

template <typename T> struct Obc {
  const T* f[NEDGE][NOBCF];
};

// planes written during the launch: eta by substep parity, the
// velocities in place, d_eta, the face transports (double-buffered
// across a refresh), the 7 sums (written at the end)
template <typename T> struct State {
  T* eta[2];
  T* ubt;
  T* vbt;
  T* d_eta;
  T* uh[2];
  T* vh[2];
  T* sums;
  T* ubp;    // open faces: the final ubt and vbt of (b), stored at the
  T* vbp;    // next substep's (1)
};

struct Geo {
  int nj, ni;          // padded extents
  int H, nic, njc, w;  // halo, compute extents, refresh width
  int rx, ry;          // reentrant in x / y
  int curve;           // BT_cont curve transports (else Datu*ubt)
  int total, every;    // substeps; refresh after every-1, 2*every-1, ...
  int npb;             // points per block
  int tiles;           // tiles of THREADS*PPT points per block
  int smem;            // transport constants in shared memory
};

__device__ __forceinline__ int wrap(int p, int n) {
  return p < 0 ? p + n : (p >= n ? p - n : p);
}

// a constant plane (read-only for the whole launch)
template <typename T>
__device__ __forceinline__ T cst(const Consts<T>& C, int k, int x) {
  return __ldg(C.f[k] + x);
}

// transport constant k (0-based from CU0, or from DATU in linear mode)
// of owned point l / x
template <typename T>
__device__ __forceinline__ T tc(const T* sm, const Consts<T>& C,
                                const Geo& g, int k, int l, int x) {
  if (g.smem) return sm[k * g.npb + l];
  return __ldg((g.curve ? C.f[CU0 + k] : C.f[DATU + k]) + x);
}

// find_uhbt on the ten curve constants starting at c0
template <typename T>
__device__ __forceinline__ T find_uhbt(T u, const T* sm,
                                       const Consts<T>& C, const Geo& g,
                                       int c0, int l, int x) {
  const T fa_far_neg = tc(sm, C, g, c0, l, x);
  const T fa_0_neg = tc(sm, C, g, c0 + 1, l, x);
  const T fa_0_pos = tc(sm, C, g, c0 + 2, l, x);
  const T fa_far_pos = tc(sm, C, g, c0 + 3, l, x);
  const T u_neg = tc(sm, C, g, c0 + 4, l, x);
  const T u_pos = tc(sm, C, g, c0 + 5, l, x);
  const T crv_neg = tc(sm, C, g, c0 + 6, l, x);
  const T uh_neg = tc(sm, C, g, c0 + 7, l, x);
  const T crv_pos = tc(sm, C, g, c0 + 8, l, x);
  const T uh_pos = tc(sm, C, g, c0 + 9, l, x);
  if (u < u_neg) return (u - u_neg) * fa_far_neg + uh_neg;
  if (u < T(0)) return u * (fa_0_neg + crv_neg * u * u);
  if (u <= u_pos) return u * (fa_0_pos + crv_pos * u * u);
  return (u - u_pos) * fa_far_pos + uh_pos;
}

template <typename T>
__device__ __forceinline__ T trans_u(T ubt, const T* sm,
                                     const Consts<T>& C, const Geo& g,
                                     int l, int x) {
  return g.curve ? find_uhbt(ubt, sm, C, g, 0, l, x)
                       + tc(sm, C, g, UHBT0 - CU0, l, x)
                 : tc(sm, C, g, 0, l, x) * ubt;
}

template <typename T>
__device__ __forceinline__ T trans_v(T vbt, const T* sm,
                                     const Consts<T>& C, const Geo& g,
                                     int l, int x) {
  return g.curve ? find_uhbt(vbt, sm, C, g, CV0 - CU0, l, x)
                       + tc(sm, C, g, VHBT0 - CU0, l, x)
                 : tc(sm, C, g, 1, l, x) * vbt;
}

// the k-th point of this thread in tile t: false if the block owns
// fewer points.  The empty asm makes the index opaque, so that each
// phase recomputes its addresses instead of keeping those of all points
// and planes live across the grid syncs (which spills registers to
// memory).
struct Pt {
  int l, x, j, i;
};

__device__ __forceinline__ bool owned(int t, int k, int start, int own,
                                      const Geo& g, Pt& p) {
  p.l = threadIdx.x + (t * PPT + k) * THREADS;
  if (p.l >= own) return false;
  p.x = start + p.l;
  asm volatile("" : "+r"(p.x));
  p.j = p.x / g.ni;
  p.i = p.x - p.j * g.ni;
  return true;
}

// the divergence of the face transports at y (j, i), whose own faces
// carry uh_y and vh_y
template <typename T>
__device__ __forceinline__ T face_div(int y, int j, int i, T uh_y, T vh_y,
                                      const T* UH, const T* VH,
                                      const Consts<T>& C, const Geo& g) {
  const int yw = j * g.ni + wrap(i - 1, g.ni);
  const int ys = wrap(j - 1, g.nj) * g.ni + i;
  return ((uh_y - UH[yw]) + (vh_y - VH[ys])) * cst(C, IAREAT, y);
}

// the eta predictor's d_eta at y from its eta and divergence
template <typename T>
__device__ __forceinline__ T d_eta_of(int y, T eta_y, T div,
                                      const Consts<T>& C, T dtbt, T bebt,
                                      T one_m_bebt) {
  const T eta_pred = (eta_y + cst(C, ETA_SRC, y)) - dtbt * div;
  return (one_m_bebt * eta_y + bebt * eta_pred) - cst(C, ETA_PF, y);
}

// ubt2 = bt_rem_u*(ubt + dtbt*((BT_force_u + cor_u(v) - Cor_ref_u)
// + pf_u)) at p, from its ubt and v and the v and d_eta planes; adds
// wt_accel*(cu + pf_u) to acc
template <typename T>
__device__ __forceinline__ T u_update(const Pt& p, T ubt, T v,
                                      const T* vp, const T* dp,
                                      const Consts<T>& C, const Geo& g,
                                      T dtbt, T w_accel, T& acc) {
  const int ip = wrap(p.i + 1, g.ni), jm = wrap(p.j - 1, g.nj);
  const int x = p.x, xe = p.j * g.ni + ip;
  const int xs = jm * g.ni + p.i, xse = jm * g.ni + ip;
  const T A = cst(C, Q, x) * (cst(C, DV_Q, xe) * vp[xe]
                              + cst(C, DV_Q, x) * v);
  const T As = cst(C, Q, xs) * (cst(C, DV_Q, xse) * vp[xse]
                                + cst(C, DV_Q, xs) * vp[xs]);
  const T cu = (A + As) - cst(C, COR_REF_U, x);
  const T pf = (dp[x] * cst(C, GTOT_E, x) - dp[xe] * cst(C, GTOT_W, xe))
      * cst(C, IDXCU, x);
  acc = acc + w_accel * (cu + pf);
  return cst(C, BT_REM_U, x)
      * (ubt + dtbt * ((cst(C, BT_FORCE_U, x) + cu) + pf));
}

// vbt2 = bt_rem_v*(vbt + dtbt*((BT_force_v + cor_v(u) - Cor_ref_v)
// + pf_v)) at p, likewise from its vbt and u and the u and d_eta
// planes; adds wt_accel*(cv + pf_v) to acc
template <typename T>
__device__ __forceinline__ T v_update(const Pt& p, T vbt, T u,
                                      const T* up, const T* dp,
                                      const Consts<T>& C, const Geo& g,
                                      T dtbt, T w_accel, T& acc) {
  const int im = wrap(p.i - 1, g.ni), jp = wrap(p.j + 1, g.nj);
  const int x = p.x, xn = jp * g.ni + p.i;
  const int xw = p.j * g.ni + im, xnw = jp * g.ni + im;
  const T B = cst(C, Q, x) * (cst(C, DU_Q, x) * u
                              + cst(C, DU_Q, xn) * up[xn]);
  const T Bw = cst(C, Q, xw) * (cst(C, DU_Q, xw) * up[xw]
                                + cst(C, DU_Q, xnw) * up[xnw]);
  const T cv = -(B + Bw) - cst(C, COR_REF_V, x);
  const T pf = (dp[x] * cst(C, GTOT_N, x) - dp[xn] * cst(C, GTOT_S, xn))
      * cst(C, IDYCV, x);
  acc = acc + w_accel * (cv + pf);
  return cst(C, BT_REM_V, x)
      * (vbt + dtbt * ((cst(C, BT_FORCE_V, x) + cv) + pf));
}

// sum s of point x in the sums plane
template <typename T>
__device__ __forceinline__ T& sum_at(const State<T>& S, int P, int s,
                                     int x) {
  return S.sums[(size_t)s * P + x];
}

// --- open faces --------------------------------------------------------

// edge e open at along-edge index k (inside its segment's strip)
template <typename T>
__device__ __forceinline__ bool open_at(const Obc<T>& O, int e, int k) {
  return O.f[e][O_MASK] != nullptr && __ldg(O.f[e][O_MASK] + k) > T(0);
}

// the Flather velocity at face k of edge e from the inlet velocity and
// the eta of the boundary cell: 0.5*((v_in + v_ext) + c*(eta - ssh)) on
// E/N, with (ssh - eta) on W/S
template <typename T>
__device__ __forceinline__ T flather(const Obc<T>& O, int e, int k, T v_in,
                                     T eta_in) {
  const T vel = __ldg(O.f[e][O_VEL] + k), ssh = __ldg(O.f[e][O_SSH] + k);
  const T d = (e == OE || e == ON) ? eta_in - ssh : ssh - eta_in;
  return T(0.5) * ((v_in + vel) + __ldg(O.f[e][O_COEF] + k) * d);
}

// Domain.fill_halos(width=w) as a map: (j, i) takes the value of
// (js, is), or zero (false)
__device__ __forceinline__ bool filled_from(const Geo& g, int j, int i,
                                            int& js, int& is) {
  const int H = g.H;
  js = j;
  is = i;
  if (i >= H - g.w && i < H) {
    if (!g.rx) return false;
    is = i + g.nic;
  } else if (i >= H + g.nic && i < H + g.nic + g.w) {
    if (!g.rx) return false;
    is = i - g.nic;
  }
  if (j >= H - g.w && j < H) {
    if (!g.ry) return false;
    js = j + g.njc;
  } else if (j >= H + g.njc && j < H + g.njc + g.w) {
    if (!g.ry) return false;
    js = j - g.njc;
  }
  return true;
}

// OpenBoundaries.extend as a map (W, E, then S, N on the W/E-extended
// field): true when (j, i) lies in an open edge's halo band, which takes
// the refreshed eta of (je, ie)
template <typename T>
__device__ __forceinline__ bool extended_from(const Obc<T>& O, const Geo& g,
                                              int j, int i, int& je,
                                              int& ie) {
  const int H = g.H, iE = H + g.nic - 1, jN = H + g.njc - 1;
  bool hit = false;
  je = j;
  ie = i;
  if (j < H && open_at(O, OS, i)) {
    je = H;
    hit = true;
  } else if (j > jN && open_at(O, ON, i)) {
    je = jN;
    hit = true;
  }
  if (i < H && open_at(O, OW, je)) {
    ie = H;
    hit = true;
  } else if (i > iE && open_at(O, OE, je)) {
    ie = iE;
    hit = true;
  }
  return hit;
}

// eta2 of (j, i) after the refresh, recomputed from its source's old eta
// and transports (the owner's arithmetic, so the same bits)
template <typename T>
__device__ __forceinline__ T eta_refreshed(int j, int i, const T* eta_old,
                                           const T* UH, const T* VH,
                                           const Consts<T>& C, const Geo& g,
                                           T dtbt) {
  int js, is;
  if (!filled_from(g, j, i, js, is)) return T(0);
  const int s = js * g.ni + is;
  return (eta_old[s] + cst(C, ETA_SRC, s))
      - dtbt * face_div(s, js, is, UH[s], VH[s], UH, VH, C, g);
}

// eta of (j, i) after the refresh and the extension
template <typename T>
__device__ __forceinline__ T eta_extended(const Obc<T>& O, int j, int i,
                                          const T* eta_old, const T* UH,
                                          const T* VH, const Consts<T>& C,
                                          const Geo& g, T dtbt) {
  int je, ie;
  extended_from(O, g, j, i, je, ie);
  return eta_refreshed(je, ie, eta_old, UH, VH, C, g, dtbt);
}

// a velocity plane's value at (j, i) after the refresh
template <typename T>
__device__ __forceinline__ T vel_refreshed(const T* P, const Geo& g, int j,
                                           int i) {
  int js, is;
  return filled_from(g, j, i, js, is) ? P[js * g.ni + is] : T(0);
}

// which of p's velocities are Flather faces: bit 0 u (E or W), bit 1 v
template <typename T>
__device__ __forceinline__ unsigned obc_faces(const Obc<T>& O, const Geo& g,
                                              const Pt& p) {
  const int H = g.H;
  unsigned f = 0;
  if ((p.i == H + g.nic - 1 && open_at(O, OE, p.j))
      || (p.i == H - 1 && open_at(O, OW, p.j)))
    f |= 1u;
  if ((p.j == H + g.njc - 1 && open_at(O, ON, p.i))
      || (p.j == H - 1 && open_at(O, OS, p.i)))
    f |= 2u;
  return f;
}

// the faces' final velocities of the previous substep's (b), held since
template <typename T>
__device__ __forceinline__ void store_held(const Obc<T>& O, const State<T>& S,
                                           const Geo& g, const Pt& p) {
  const unsigned f = obc_faces(O, g, p);
  if (f & 1u) S.ubt[p.x] = S.ubp[p.x];
  if (f & 2u) S.vbt[p.x] = S.vbp[p.x];
}

// Each phase loads and computes for all of a tile's points before it
// stores, so that the loads of its points overlap.  Planes written
// during the launch are read with plain loads: grid.sync() orders them.
// RESIDENT: the band is one tile, and each point's state stays in
// registers from phase to phase; else every phase reloads it from the
// planes, tile by tile, and the sums go through the sums plane.
// OBC: the open-face instance (see the top of the file).
template <typename T, bool RESIDENT, bool OBC>
__global__ void __launch_bounds__(THREADS, 1)
subcycle_kernel(const __grid_constant__ Consts<T> C,
                const __grid_constant__ State<T> S,
                const __grid_constant__ Geo g,
                const __grid_constant__ Obc<T> O,
                const T* __restrict__ wts, const T dtbt,
                const T bebt, const T one_m_bebt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int P = g.nj * g.ni;
  const int start = blockIdx.x * g.npb;
  const int own = max(0, min(g.npb, P - start));
  const int tiles = RESIDENT ? 1 : g.tiles;
  if (g.smem) {
#pragma unroll
    for (int k = 0; k < NCURVE; ++k) {
      if (k >= (g.curve ? NCURVE : 2)) break;
      const T* src = g.curve ? C.f[CU0 + k] : C.f[DATU + k];
      for (int l = threadIdx.x; l < own; l += THREADS)
        sm[k * g.npb + l] = __ldg(src + start + l);
    }
  }
  __syncthreads();

  // per point of the current tile: eta, ubt and vbt, the face
  // transports of ubt and vbt, the divergence carried from (4) to (1),
  // the sums; d_eta only within (1)
  T eta[PPT], ub[PPT], vb[PPT], uh[PPT], vh[PPT], de[PPT], div[PPT];
  T sum[NSUM][PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    eta[k] = ub[k] = vb[k] = uh[k] = vh[k] = de[k] = div[k] = T(0);
#pragma unroll
    for (int s = 0; s < NSUM; ++s) sum[s][k] = T(0);
  }
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      Pt p;
      if (!owned(t, k, start, own, g, p)) continue;
      eta[k] = S.eta[0][p.x];
      ub[k] = S.ubt[p.x];
      vb[k] = S.vbt[p.x];
      uh[k] = trans_u(ub[k], sm, C, g, p.l, p.x);
      vh[k] = trans_v(vb[k], sm, C, g, p.l, p.x);
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      Pt p;
      if (!owned(t, k, start, own, g, p)) continue;
      S.uh[0][p.x] = uh[k];
      S.vh[0][p.x] = vh[k];
    }
  }
  grid.sync();

  int tb = 0;          // transport buffer of the current velocities
  bool fresh = true;   // (1) recomputes the divergence
  for (int n = 0; n < g.total; ++n) {
    T* const UH = tb ? S.uh[1] : S.uh[0];
    T* const VH = tb ? S.vh[1] : S.vh[0];
    T* const eta_new = (n % 2) ? S.eta[0] : S.eta[1];
    const T* const eta_old = (n % 2) ? S.eta[1] : S.eta[0];
    const int w = (n % g.every == g.every - 1) ? g.w : 0;

    // (1) eta predictor -> d_eta
    for (int t = 0; t < tiles; ++t) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        Pt p;
        if (!owned(t, k, start, own, g, p)) continue;
        if (OBC && n > 0) store_held(O, S, g, p);
        if (!RESIDENT) {
          eta[k] = eta_old[p.x];
          uh[k] = UH[p.x];
          vh[k] = VH[p.x];
        }
        if (fresh || !RESIDENT)
          div[k] = face_div(p.x, p.j, p.i, uh[k], vh[k], UH, VH, C, g);
        de[k] = d_eta_of(p.x, eta[k], div[k], C, dtbt, bebt, one_m_bebt);
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        Pt p;
        if (owned(t, k, start, own, g, p)) S.d_eta[p.x] = de[k];
      }
    }
    grid.sync();

    // (2), (3) the two velocities and their face transports; the
    // (4, total) filter weights (rows vel, eta, trans, accel) are read
    // where they are used, so none is live across a grid sync
    for (int half = 0; half < 2; ++half) {
      const T w_a = __ldg(wts + 3 * g.total + n);
      const bool do_u = (n + half) % 2 == 0;
      const int s_acc = do_u ? S_ACCEL_U : S_ACCEL_V;
      for (int t = 0; t < tiles; ++t) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          Pt p;
          if (!owned(t, k, start, own, g, p)) continue;
          if (!RESIDENT) {
            ub[k] = S.ubt[p.x];
            vb[k] = S.vbt[p.x];
            const T a = n > 0 ? sum_at(S, P, s_acc, p.x) : T(0);
            sum[S_ACCEL_U][k] = a;
            sum[S_ACCEL_V][k] = a;
          }
          if (do_u) {
            ub[k] = u_update(p, ub[k], vb[k], S.vbt, S.d_eta, C, g, dtbt,
                             w_a, sum[S_ACCEL_U][k]);
            uh[k] = trans_u(ub[k], sm, C, g, p.l, p.x);
          } else {
            vb[k] = v_update(p, vb[k], ub[k], S.ubt, S.d_eta, C, g, dtbt,
                             w_a, sum[S_ACCEL_V][k]);
            vh[k] = trans_v(vb[k], sm, C, g, p.l, p.x);
          }
        }
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          Pt p;
          if (!owned(t, k, start, own, g, p)) continue;
          if (do_u) {
            S.ubt[p.x] = ub[k];
            UH[p.x] = uh[k];
          } else {
            S.vbt[p.x] = vb[k];
            VH[p.x] = vh[k];
          }
          if (!RESIDENT)
            sum_at(S, P, s_acc, p.x) =
                do_u ? sum[S_ACCEL_U][k] : sum[S_ACCEL_V][k];
        }
      }
      grid.sync();
    }

    // (3b) open faces: Flather with the old eta; the inlet velocity is
    // the face one in, eta that of the boundary cell
    if (OBC) {
      const int H = g.H, iE = H + g.nic - 1, jN = H + g.njc - 1;
      for (int t = 0; t < tiles; ++t) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          Pt p;
          if (!owned(t, k, start, own, g, p)) continue;
          T u = T(0), v = T(0);
          bool fu = true, fv = true;
          if (p.i == iE && open_at(O, OE, p.j))
            u = flather(O, OE, p.j, S.ubt[p.x - 1], eta_old[p.x]);
          else if (p.i == H - 1 && open_at(O, OW, p.j))
            u = flather(O, OW, p.j, S.ubt[p.x + 1], eta_old[p.x + 1]);
          else
            fu = false;
          if (p.j == jN && open_at(O, ON, p.i))
            v = flather(O, ON, p.i, S.vbt[p.x - g.ni], eta_old[p.x]);
          else if (p.j == H - 1 && open_at(O, OS, p.i))
            v = flather(O, OS, p.i, S.vbt[p.x + g.ni], eta_old[p.x + g.ni]);
          else
            fv = false;
          if (fu) {
            S.ubt[p.x] = u;
            UH[p.x] = trans_u(u, sm, C, g, p.l, p.x);
            if (RESIDENT) {
              ub[k] = u;
              uh[k] = UH[p.x];
            }
          }
          if (fv) {
            S.vbt[p.x] = v;
            VH[p.x] = trans_v(v, sm, C, g, p.l, p.x);
            if (RESIDENT) {
              vb[k] = v;
              vh[k] = VH[p.x];
            }
          }
        }
      }
      grid.sync();
    }

    // (4) eta corrector, the width-w refresh, the sums
    const T w_v = __ldg(wts + n), w_e = __ldg(wts + g.total + n);
    const T w_t = __ldg(wts + 2 * g.total + n);
    for (int t = 0; t < tiles; ++t) {
      unsigned halo_pts = 0;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        Pt p;
        if (!owned(t, k, start, own, g, p)) continue;
        if (!RESIDENT) {
          eta[k] = eta_old[p.x];
          ub[k] = S.ubt[p.x];
          vb[k] = S.vbt[p.x];
          uh[k] = UH[p.x];
          vh[k] = VH[p.x];
#pragma unroll
          for (int s = 0; s < NSUM; ++s)
            if (s != S_ACCEL_U && s != S_ACCEL_V)
              sum[s][k] = n > 0 ? sum_at(S, P, s, p.x) : T(0);
        }
        // the transports of the unrefreshed new velocities
        sum[S_UHBT][k] = sum[S_UHBT][k] + w_t * uh[k];
        sum[S_VHBT][k] = sum[S_VHBT][k] + w_t * vh[k];
        // Domain.fill_halos(width=w): x first, then y strips spanning
        // the x halos; a refreshed cell takes the values of (js, is), or
        // zeros
        int is = p.i, js = p.j;
        bool halo = false, zero = false;
        if (w > 0) {
          const int H = g.H;
          if (p.i >= H - w && p.i < H) {
            halo = true;
            if (g.rx) is = p.i + g.nic; else zero = true;
          } else if (p.i >= H + g.nic && p.i < H + g.nic + w) {
            halo = true;
            if (g.rx) is = p.i - g.nic; else zero = true;
          }
          if (p.j >= H - w && p.j < H) {
            halo = true;
            if (g.ry) js = p.j + g.njc; else zero = true;
          } else if (p.j >= H + g.njc && p.j < H + g.njc + w) {
            halo = true;
            if (g.ry) js = p.j - g.njc; else zero = true;
          }
        }
        T e = T(0);
        if (!halo) {
          div[k] = face_div(p.x, p.j, p.i, uh[k], vh[k], UH, VH, C, g);
          e = (eta[k] + cst(C, ETA_SRC, p.x)) - dtbt * div[k];
        } else {
          ub[k] = vb[k] = T(0);
          if (!zero) {
            const int s = js * g.ni + is;
            e = (eta_old[s] + cst(C, ETA_SRC, s))
                - dtbt * face_div(s, js, is, UH[s], VH[s], UH, VH, C, g);
            ub[k] = S.ubt[s];
            vb[k] = S.vbt[s];
          }
          uh[k] = trans_u(ub[k], sm, C, g, p.l, p.x);
          vh[k] = trans_v(vb[k], sm, C, g, p.l, p.x);
          halo_pts |= 1u << k;
        }
        if (OBC) {
          // (b): the extension of eta, then Flather with it; the faces'
          // velocities are stored at the next substep
          int je, ie;
          if (extended_from(O, g, p.j, p.i, je, ie))
            e = eta_refreshed(je, ie, eta_old, UH, VH, C, g, dtbt);
          const int H = g.H, iE = H + g.nic - 1, jN = H + g.njc - 1;
          const unsigned f = obc_faces(O, g, p);
          if (f & 1u) {
            ub[k] = p.i == iE
                ? flather(O, OE, p.j, vel_refreshed(S.ubt, g, p.j, iE - 1), e)
                : flather(O, OW, p.j, vel_refreshed(S.ubt, g, p.j, H),
                          eta_extended(O, p.j, H, eta_old, UH, VH, C, g,
                                       dtbt));
            uh[k] = trans_u(ub[k], sm, C, g, p.l, p.x);
            S.ubp[p.x] = ub[k];
          }
          if (f & 2u) {
            vb[k] = p.j == jN
                ? flather(O, ON, p.i, vel_refreshed(S.vbt, g, jN - 1, p.i), e)
                : flather(O, OS, p.i, vel_refreshed(S.vbt, g, H, p.i),
                          eta_extended(O, H, p.i, eta_old, UH, VH, C, g,
                                       dtbt));
            vh[k] = trans_v(vb[k], sm, C, g, p.l, p.x);
            S.vbp[p.x] = vb[k];
          }
        }
        eta[k] = e;
        sum[S_ETA][k] = sum[S_ETA][k] + w_e * e;
        sum[S_UBT][k] = sum[S_UBT][k] + w_v * ub[k];
        sum[S_VBT][k] = sum[S_VBT][k] + w_v * vb[k];
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        Pt p;
        if (!owned(t, k, start, own, g, p)) continue;
        eta_new[p.x] = eta[k];
        if (w > 0) {
          if (halo_pts >> k & 1u) {
            S.ubt[p.x] = ub[k];
            S.vbt[p.x] = vb[k];
          }
          (tb ? S.uh[0] : S.uh[1])[p.x] = uh[k];
          (tb ? S.vh[0] : S.vh[1])[p.x] = vh[k];
        }
        if (!RESIDENT) {
#pragma unroll
          for (int s = 0; s < NSUM; ++s)
            if (s != S_ACCEL_U && s != S_ACCEL_V)
              sum_at(S, P, s, p.x) = sum[s][k];
        }
      }
    }
    // a refresh wrote the halo's velocities and the other transport
    // buffer, which the next predictor reads; what else it reads of the
    // corrector's output is its own point's, written by this thread
    fresh = w > 0;
    if (fresh) {
      tb ^= 1;
      if (OBC || n + 1 < g.total) grid.sync();
    }
  }
  if (OBC) {
    for (int t = 0; t < tiles; ++t) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        Pt p;
        if (owned(t, k, start, own, g, p)) store_held(O, S, g, p);
      }
    }
  }

  if (RESIDENT) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      Pt p;
      if (!owned(0, k, start, own, g, p)) continue;
#pragma unroll
      for (int s = 0; s < NSUM; ++s) sum_at(S, P, s, p.x) = sum[s][k];
    }
  }
}

template <typename T, bool RESIDENT, bool OBC>
cudaError_t launch_on(int blocks, int smem_bytes, cudaStream_t stream,
                      void** args) {
  auto kern = subcycle_kernel<T, RESIDENT, OBC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                    smem_bytes);
  if (e != cudaSuccess) return e;
  if ((long)per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                     dim3(THREADS), args, smem_bytes,
                                     stream);
}

// state: eta_a, eta_b, ubt, vbt, d_eta, uh_a, uh_b, vh_a, vh_b, with
// open faces (obc not null: the 16 edge vectors, W, E, S, N) ubp, vbp,
// then sums (7 planes); the final eta lands in eta_a when ``total`` is
// even.  The
// halo is refreshed (width w) after substeps every-1, 2*every-1, ...
// wt is the (4, total) weights in the card's memory.  The plan (blocks,
// npb, smem_bytes) comes from the caller; a grid that cannot be
// co-resident is refused.
template <typename T>
int launch_subcycle(const void* const* consts, void* const* state,
                    const void* wt, int nj, int ni, int H, int nic,
                    int njc, int w, int rx, int ry, int curve, int total,
                    int every, double dtbt, double bebt, int blocks,
                    int npb, int smem_bytes, void* stream, int* launches,
                    const void* const* obc = nullptr) {
  *launches = 0;
  const long P = (long)nj * ni;   // flat indices are int
  const int ntc = curve ? NCURVE : 2;
  if (P > 0x7fffffffL || total < 1 || every < 1 || wt == nullptr
      || total % every || blocks < 1
      || npb < 1 || (long)blocks * npb < P
      || (long)(blocks - 1) * npb >= P
      || (smem_bytes != 0
          && (long)smem_bytes != (long)ntc * npb * (long)sizeof(T)))
    return cudaErrorInvalidValue;
  Consts<T> C;
  for (int k = 0; k < NCONST; ++k) C.f[k] = (const T*)consts[k];
  State<T> S;
  S.eta[0] = (T*)state[0];
  S.eta[1] = (T*)state[1];
  S.ubt = (T*)state[2];
  S.vbt = (T*)state[3];
  S.d_eta = (T*)state[4];
  S.uh[0] = (T*)state[5];
  S.uh[1] = (T*)state[6];
  S.vh[0] = (T*)state[7];
  S.vh[1] = (T*)state[8];
  S.ubp = obc ? (T*)state[9] : nullptr;
  S.vbp = obc ? (T*)state[10] : nullptr;
  S.sums = (T*)state[obc ? 11 : 9];
  Obc<T> O;
  for (int e = 0; e < NEDGE; ++e)
    for (int f = 0; f < NOBCF; ++f)
      O.f[e][f] = obc ? (const T*)obc[e * NOBCF + f] : nullptr;
  // an open-face launch refreshes every substep
  if (obc && every != 1) return cudaErrorInvalidValue;
  const T* wts = (const T*)wt;
  const int tiles = (int)(((long)npb + THREADS * PPT - 1) / (THREADS * PPT));
  const Geo g{nj, ni, H, nic, njc, w, rx, ry, curve, total, every, npb,
              tiles, smem_bytes > 0};
  T tdt = T(dtbt), tb = T(bebt), t1b = T(1.0 - bebt);
  void* args[] = {&C, &S, (void*)&g, &O, &wts, &tdt, &tb, &t1b};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (obc)
    e = tiles == 1 ? launch_on<T, true, true>(blocks, smem_bytes, st, args)
                   : launch_on<T, false, true>(blocks, smem_bytes, st, args);
  else
    e = tiles == 1 ? launch_on<T, true, false>(blocks, smem_bytes, st, args)
                   : launch_on<T, false, false>(blocks, smem_bytes, st, args);
  if (e != cudaSuccess) return e;
  *launches = 1;
  return cudaGetLastError();
}

}  // namespace

// the SM count and the opt-in shared memory of a block on ``device``
extern "C" int bt_device_info(int device, int* sms, int* smem_optin) {
  cudaError_t e = cudaDeviceGetAttribute(
      sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

extern "C" const char* bt_error_name(int e) {
  return cudaGetErrorName(static_cast<cudaError_t>(e));
}

#define SUBCYCLE_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* const* consts, void* const* state,     \
                      const void* wt, int nj, int ni, int H, int nic,     \
                      int njc, int w, int rx, int ry, int curve,          \
                      int total, double dtbt, double bebt, int blocks,    \
                      int npb, int smem_bytes, void* stream,              \
                      int* launches) {                                    \
    return launch_subcycle<T>(consts, state, wt, nj, ni, H, nic, njc, w,  \
                              rx, ry, curve, total, 1, dtbt, bebt,        \
                              blocks, npb, smem_bytes, stream, launches); \
  }

// K3m: ``period`` substeps per chunk, the whole halo (w = H = 3*period)
// refreshed on each chunk's last one
#define MARCH_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* const* consts, void* const* state,     \
                      const void* wt, int nj, int ni, int H, int nic,     \
                      int njc, int w, int rx, int ry, int curve,          \
                      int total, int period, double dtbt, double bebt,    \
                      int blocks, int npb, int smem_bytes, void* stream,  \
                      int* launches) {                                    \
    *launches = 0;                                                        \
    if (period < 2 || total % period != 0) return cudaErrorInvalidValue;  \
    return launch_subcycle<T>(consts, state, wt, nj, ni, H, nic, njc, w,  \
                              rx, ry, curve, total, period, dtbt, bebt,   \
                              blocks, npb, smem_bytes, stream, launches); \
  }

// K3 with open faces: ``obc`` holds the 16 edge vectors (W, E, S, N;
// mask, Flather factor, external velocity, external ssh), null for a
// closed edge, and ``state`` the two planes of the faces' final
// velocities before the sums
#define SUBCYCLE_OBC_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* const* consts, void* const* state,     \
                      const void* const* obc, const void* wt, int nj,     \
                      int ni, int H, int nic, int njc, int w, int rx,     \
                      int ry, int curve, int total, double dtbt,          \
                      double bebt, int blocks, int npb, int smem_bytes,   \
                      void* stream, int* launches) {                      \
    *launches = 0;                                                        \
    if (obc == nullptr) return cudaErrorInvalidValue;                     \
    return launch_subcycle<T>(consts, state, wt, nj, ni, H, nic, njc, w,  \
                              rx, ry, curve, total, 1, dtbt, bebt,        \
                              blocks, npb, smem_bytes, stream, launches,  \
                              obc);                                       \
  }

SUBCYCLE_ENTRY(bt_subcycle_f32, float)
SUBCYCLE_ENTRY(bt_subcycle_f64, double)
MARCH_ENTRY(bt_march_f32, float)
MARCH_ENTRY(bt_march_f64, double)
SUBCYCLE_OBC_ENTRY(bt_subcycle_obc_f32, float)
SUBCYCLE_OBC_ENTRY(bt_subcycle_obc_f64, double)
