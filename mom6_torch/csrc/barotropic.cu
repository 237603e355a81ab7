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
// What bounds it on an H100: a substep is ~160 operations per point
// over ~25 plane reads, and the constant planes (1 MB each at 512x512)
// stay in the 50 MB L2 across substeps; over a whole subcycle the
// operations bound (1.4 Gop at 512x512, 32 substeps) and the bytes
// bound (each input read once) are both ~20 us.  At the main path's
// size each of the four launches per substep is so short that launch
// latency, not bytes or operations, sets the time.
//
// Design: the substep has grid-wide dependencies (the second velocity
// needs the first at its neighbours), so each substep is four
// launches, all issued by the host loop in run_subcycle without
// returning to Python: (1) eta predictor -> d_eta; (2) first velocity;
// (3) second velocity (u first on even substeps, v first on odd ones);
// (4) eta corrector, the width-w halo refresh and the seven weighted
// sums.  K3m is the same host loop with the refresh width set per
// substep: the full wide halo on a chunk's last substep, 0 (no
// refresh; the sums take the unrefreshed values, as the march's _one
// does with do_fill=False) on the others.  The refresh reproduces
// Domain.fill_halos (x first, then y):
// a halo cell recomputes eta2 at the interior cell it copies from, so
// no extra launch is needed; eta is double-buffered because a halo
// thread reads the old eta of another cell.  Neighbours wrap at the
// array edge like torch.roll, so the kernel matches the plain loop on
// the whole padded array.  Filter weights sit in device memory, copied
// once per call.
#include <cuda_runtime.h>

namespace {

enum {
  GTOT_E, GTOT_W, GTOT_N, GTOT_S, Q, DU_Q, DV_Q, COR_REF_U, COR_REF_V,
  BT_REM_U, BT_REM_V, BT_FORCE_U, BT_FORCE_V, ETA_PF, IDXCU, IDYCV,
  IAREAT, ETA_SRC, DATU, DATV, CU0, CV0 = CU0 + 10, UHBT0 = CV0 + 10,
  VHBT0, NCONST
};
enum { S_UHBT, S_VHBT, S_ETA, S_ACCEL_U, S_ACCEL_V, S_UBT, S_VBT };

template <typename T> struct Consts {
  const T* f[NCONST];
};

struct Geo {
  int nj, ni;          // padded extents
  int H, nic, njc, w;  // halo, compute extents, refresh width
  int rx, ry;          // reentrant in x / y
  int curve;           // BT_cont curve transports (else Datu*ubt)
};

__device__ inline int wrap(int p, int n) {
  return p < 0 ? p + n : (p >= n ? p - n : p);
}

// find_uhbt on the ten curve constants starting at c0
template <typename T>
__device__ inline T find_uhbt(T u, const Consts<T>& C, int c0, long x) {
  const T fa_far_neg = C.f[c0][x], fa_0_neg = C.f[c0 + 1][x];
  const T fa_0_pos = C.f[c0 + 2][x], fa_far_pos = C.f[c0 + 3][x];
  const T u_neg = C.f[c0 + 4][x], u_pos = C.f[c0 + 5][x];
  const T crv_neg = C.f[c0 + 6][x], uh_neg = C.f[c0 + 7][x];
  const T crv_pos = C.f[c0 + 8][x], uh_pos = C.f[c0 + 9][x];
  if (u < u_neg) return (u - u_neg) * fa_far_neg + uh_neg;
  if (u < T(0)) return u * (fa_0_neg + crv_neg * u * u);
  if (u <= u_pos) return u * (fa_0_pos + crv_pos * u * u);
  return (u - u_pos) * fa_far_pos + uh_pos;
}

template <typename T>
__device__ inline T trans_u(T ubt, const Consts<T>& C, const Geo& g,
                            long x) {
  return g.curve ? find_uhbt(ubt, C, CU0, x) + C.f[UHBT0][x]
                 : C.f[DATU][x] * ubt;
}

template <typename T>
__device__ inline T trans_v(T vbt, const Consts<T>& C, const Geo& g,
                            long x) {
  return g.curve ? find_uhbt(vbt, C, CV0, x) + C.f[VHBT0][x]
                 : C.f[DATV][x] * vbt;
}

// -dtbt * div(trans(ubt), trans(vbt)) source of eta at (j, i)
template <typename T>
__device__ inline T eta_update(const T* eta, const T* ubt, const T* vbt,
                               const Consts<T>& C, const Geo& g, int j,
                               int i, T dtbt) {
  const long x = (long)j * g.ni + i;
  const long xw = (long)j * g.ni + wrap(i - 1, g.ni);
  const long xs = (long)wrap(j - 1, g.nj) * g.ni + i;
  T div = ((trans_u(ubt[x], C, g, x) - trans_u(ubt[xw], C, g, xw))
           + (trans_v(vbt[x], C, g, x) - trans_v(vbt[xs], C, g, xs)))
      * C.f[IAREAT][x];
  return (eta[x] + C.f[ETA_SRC][x]) - dtbt * div;
}

template <typename T>
__global__ void predictor_kernel(const T* __restrict__ eta,
                                 const T* __restrict__ ubt,
                                 const T* __restrict__ vbt,
                                 T* __restrict__ d_eta, Consts<T> C,
                                 Geo g, T dtbt, T bebt, T one_m_bebt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= g.ni || j >= g.nj) return;
  const long x = (long)j * g.ni + i;
  T eta_pred = eta_update(eta, ubt, vbt, C, g, j, i, dtbt);
  T eta_bt_pf = one_m_bebt * eta[x] + bebt * eta_pred;
  d_eta[x] = eta_bt_pf - C.f[ETA_PF][x];
}

// ubt2 = bt_rem_u*(ubt + dtbt*((BT_force_u + cor_u(vsrc) - Cor_ref_u)
// + pf_u)); accumulates wt_accel*(cu + pf_u)
template <typename T>
__global__ void u_kernel(const T* __restrict__ ubt,
                         const T* __restrict__ vsrc,
                         const T* __restrict__ d_eta,
                         T* __restrict__ ubt2, T* __restrict__ sum_accel,
                         Consts<T> C, Geo g, T dtbt,
                         const T* __restrict__ w_accel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= g.ni || j >= g.nj) return;
  const int ip = wrap(i + 1, g.ni), jm = wrap(j - 1, g.nj);
  const long x = (long)j * g.ni + i, xe = (long)j * g.ni + ip;
  const long xs = (long)jm * g.ni + i, xse = (long)jm * g.ni + ip;
  const T* Dv = C.f[DV_Q];
  const T* q = C.f[Q];
  T A = q[x] * (Dv[xe] * vsrc[xe] + Dv[x] * vsrc[x]);
  T As = q[xs] * (Dv[xse] * vsrc[xse] + Dv[xs] * vsrc[xs]);
  T cu = (A + As) - C.f[COR_REF_U][x];
  T pf = (d_eta[x] * C.f[GTOT_E][x] - d_eta[xe] * C.f[GTOT_W][xe])
      * C.f[IDXCU][x];
  ubt2[x] = C.f[BT_REM_U][x]
      * (ubt[x] + dtbt * ((C.f[BT_FORCE_U][x] + cu) + pf));
  sum_accel[x] = sum_accel[x] + *w_accel * (cu + pf);
}

// vbt2 = bt_rem_v*(vbt + dtbt*((BT_force_v + cor_v(usrc) - Cor_ref_v)
// + pf_v)); accumulates wt_accel*(cv + pf_v)
template <typename T>
__global__ void v_kernel(const T* __restrict__ vbt,
                         const T* __restrict__ usrc,
                         const T* __restrict__ d_eta,
                         T* __restrict__ vbt2, T* __restrict__ sum_accel,
                         Consts<T> C, Geo g, T dtbt,
                         const T* __restrict__ w_accel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= g.ni || j >= g.nj) return;
  const int im = wrap(i - 1, g.ni), jp = wrap(j + 1, g.nj);
  const long x = (long)j * g.ni + i, xn = (long)jp * g.ni + i;
  const long xw = (long)j * g.ni + im, xnw = (long)jp * g.ni + im;
  const T* Du = C.f[DU_Q];
  const T* q = C.f[Q];
  T B = q[x] * (Du[x] * usrc[x] + Du[xn] * usrc[xn]);
  T Bw = q[xw] * (Du[xw] * usrc[xw] + Du[xnw] * usrc[xnw]);
  T cv = -(B + Bw) - C.f[COR_REF_V][x];
  T pf = (d_eta[x] * C.f[GTOT_N][x] - d_eta[xn] * C.f[GTOT_S][xn])
      * C.f[IDYCV][x];
  vbt2[x] = C.f[BT_REM_V][x]
      * (vbt[x] + dtbt * ((C.f[BT_FORCE_V][x] + cv) + pf));
  sum_accel[x] = sum_accel[x] + *w_accel * (cv + pf);
}

// eta corrector + width-w halo refresh + the remaining weighted sums.
// w_row points at this substep's weight in row 0 (vel); rows are
// ``total`` apart: vel, eta, trans, accel.
template <typename T>
__global__ void corrector_kernel(const T* __restrict__ eta_old,
                                 T* __restrict__ eta_new,
                                 const T* __restrict__ ubt2,
                                 const T* __restrict__ vbt2,
                                 T* __restrict__ ubt, T* __restrict__ vbt,
                                 T* __restrict__ sums, Consts<T> C, Geo g,
                                 T dtbt, const T* __restrict__ w_row,
                                 int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= g.ni || j >= g.nj) return;
  const long x = (long)j * g.ni + i;
  const long plane = (long)g.nj * g.ni;
  const T w_v = w_row[0], w_e = w_row[total], w_t = w_row[2 * total];
  // transports of the (unrefreshed) new velocities at this face
  sums[S_UHBT * plane + x] = sums[S_UHBT * plane + x]
      + w_t * trans_u(ubt2[x], C, g, x);
  sums[S_VHBT * plane + x] = sums[S_VHBT * plane + x]
      + w_t * trans_v(vbt2[x], C, g, x);
  // Domain.fill_halos(width=w): x first, then y strips spanning x halos
  int is = i, js = j;
  bool zero = false;
  const int H = g.H;
  if (i >= H - g.w && i < H) {
    if (g.rx) is = i + g.nic; else zero = true;
  } else if (i >= H + g.nic && i < H + g.nic + g.w) {
    if (g.rx) is = i - g.nic; else zero = true;
  }
  if (j >= H - g.w && j < H) {
    if (g.ry) js = j + g.njc; else zero = true;
  } else if (j >= H + g.njc && j < H + g.njc + g.w) {
    if (g.ry) js = j - g.njc; else zero = true;
  }
  T e = T(0), u = T(0), v = T(0);
  if (!zero) {
    const long s = (long)js * g.ni + is;
    e = eta_update(eta_old, ubt2, vbt2, C, g, js, is, dtbt);
    u = ubt2[s];
    v = vbt2[s];
  }
  eta_new[x] = e;
  ubt[x] = u;
  vbt[x] = v;
  sums[S_ETA * plane + x] = sums[S_ETA * plane + x] + w_e * e;
  sums[S_UBT * plane + x] = sums[S_UBT * plane + x] + w_v * u;
  sums[S_VBT * plane + x] = sums[S_VBT * plane + x] + w_v * v;
}

// state: eta_a, eta_b, ubt, vbt, ubt2, vbt2, d_eta, sums (7 planes);
// the final eta lands in eta_a when ``total`` is even.  The halo is
// refreshed (width w) after substeps every-1, 2*every-1, ...
template <typename T>
int run_subcycle(const void* const* consts, void* const* state,
                 const void* wt, int nj, int ni, int H, int nic, int njc,
                 int w, int rx, int ry, int curve, int total, int every,
                 double dtbt, double bebt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Consts<T> C;
  for (int k = 0; k < NCONST; ++k) C.f[k] = (const T*)consts[k];
  const Geo g{nj, ni, H, nic, njc, w, rx, ry, curve};
  T* eta[2] = {(T*)state[0], (T*)state[1]};
  T* ubt = (T*)state[2];
  T* vbt = (T*)state[3];
  T* ubt2 = (T*)state[4];
  T* vbt2 = (T*)state[5];
  T* d_eta = (T*)state[6];
  T* sums = (T*)state[7];
  const long plane = (long)nj * ni;
  const T* wts = (const T*)wt;
  const dim3 block(32, 8);
  const dim3 grid((ni + 31) / 32, (nj + 7) / 8);
  const T tdt = T(dtbt), tb = T(bebt), t1b = T(1.0 - bebt);
  for (int n = 0; n < total; ++n) {
    T* e_old = eta[n % 2];
    T* e_new = eta[(n + 1) % 2];
    const T* w_accel = wts + 3 * total + n;
    predictor_kernel<T><<<grid, block, 0, s>>>(e_old, ubt, vbt, d_eta, C,
                                               g, tdt, tb, t1b);
    if (n % 2 == 0) {
      u_kernel<T><<<grid, block, 0, s>>>(ubt, vbt, d_eta, ubt2,
                                         sums + S_ACCEL_U * plane, C, g,
                                         tdt, w_accel);
      v_kernel<T><<<grid, block, 0, s>>>(vbt, ubt2, d_eta, vbt2,
                                         sums + S_ACCEL_V * plane, C, g,
                                         tdt, w_accel);
    } else {
      v_kernel<T><<<grid, block, 0, s>>>(vbt, ubt, d_eta, vbt2,
                                         sums + S_ACCEL_V * plane, C, g,
                                         tdt, w_accel);
      u_kernel<T><<<grid, block, 0, s>>>(ubt, vbt2, d_eta, ubt2,
                                         sums + S_ACCEL_U * plane, C, g,
                                         tdt, w_accel);
    }
    Geo gn = g;
    gn.w = (n % every == every - 1) ? w : 0;
    corrector_kernel<T><<<grid, block, 0, s>>>(e_old, e_new, ubt2, vbt2,
                                               ubt, vbt, sums, C, gn, tdt,
                                               wts + n, total);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

#define SUBCYCLE_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* const* consts, void* const* state,     \
                      const void* wt, int nj, int ni, int H, int nic,     \
                      int njc, int w, int rx, int ry, int curve,          \
                      int total, double dtbt, double bebt,                \
                      void* stream) {                                     \
    return run_subcycle<T>(consts, state, wt, nj, ni, H, nic, njc, w, rx, \
                           ry, curve, total, 1, dtbt, bebt, stream);      \
  }

// K3m: ``period`` substeps per chunk, the whole halo (w = H = 3*period)
// refreshed on each chunk's last one
#define MARCH_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* const* consts, void* const* state,     \
                      const void* wt, int nj, int ni, int H, int nic,     \
                      int njc, int w, int rx, int ry, int curve,          \
                      int total, int period, double dtbt, double bebt,    \
                      void* stream) {                                     \
    if (period < 2 || total % period != 0) return cudaErrorInvalidValue;  \
    return run_subcycle<T>(consts, state, wt, nj, ni, H, nic, njc, w, rx, \
                           ry, curve, total, period, dtbt, bebt, stream); \
  }

SUBCYCLE_ENTRY(bt_subcycle_f32, float)
SUBCYCLE_ENTRY(bt_subcycle_f64, double)
MARCH_ENTRY(bt_march_f32, float)
MARCH_ENTRY(bt_march_f64, double)
