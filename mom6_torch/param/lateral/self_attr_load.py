"""Self-attraction and loading by spherical harmonics.

Counterpart of ``mom6_tpu.param.lateral.self_attr_load``: the SSH is
expanded in real spherical harmonics, each degree is scaled by its load
Love numbers, and the SAL geopotential height is synthesized back.  The
associated-Legendre/trig basis is built once on the host with SciPy and
kept on the device as a dense (L, njh*nih) matrix, so an evaluation is
two ``torch.matmul`` calls, analysis a = B (w eta) and synthesis
eta_sal = B^T (Lambda a), as the JAX package computes them (outside any
Pallas kernel).  The Love numbers are the PREM table of
MOM_load_love_numbers.F90 with the degree-1 CM to CF frame conversion of
calc_love_scaling.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SALHarmonics", "love_scaling", "LOVE_NUMBERS"]

# (h', l', k') load Love numbers, degrees 0..30
# (MOM_load_love_numbers.F90:11-42)
LOVE_NUMBERS = np.array([
    [0.0000000000, 0.0000000000, -1.0000000000],
    [-1.2858777580, -8.9608179370e-1, -1.0000000000],
    [-0.9907994900, 2.3286695000e-2, -3.0516104000e-1],
    [-1.0499631000, 6.9892136000e-2, -1.9585733000e-1],
    [-1.0526477000, 5.8670467000e-2, -1.3352284000e-1],
    [-1.0855918000, 4.6165153000e-2, -1.0456531000e-1],
    [-1.1431163000, 3.8586926000e-2, -9.0184841000e-2],
    [-1.2116273000, 3.4198827000e-2, -8.1906787000e-2],
    [-1.2831157000, 3.1474998000e-2, -7.6379141000e-2],
    [-1.3538554000, 2.9624407000e-2, -7.2250183000e-2],
    [-1.4223516000, 2.8273961000e-2, -6.8934145000e-2],
    [-1.4881117000, 2.7242278000e-2, -6.6147992000e-2],
    [-1.5510428000, 2.6431124000e-2, -6.3736253000e-2],
    [-1.6111895000, 2.5779507000e-2, -6.1602870000e-2],
    [-1.6686329000, 2.5245139000e-2, -5.9683159000e-2],
    [-1.7234569000, 2.4796803000e-2, -5.7931180000e-2],
    [-1.7757418000, 2.4410861000e-2, -5.6313294000e-2],
    [-1.8255646000, 2.4069336000e-2, -5.4804452000e-2],
    [-1.8730019000, 2.3758645000e-2, -5.3385807000e-2],
    [-1.9181321000, 2.3468646000e-2, -5.2043088000e-2],
    [-1.9610366000, 2.3191893000e-2, -5.0765423000e-2],
    [-2.0018000000, 2.2923032000e-2, -4.9544487000e-2],
    [-2.0405101000, 2.2658321000e-2, -4.8373866000e-2],
    [-2.0772571000, 2.2395242000e-2, -4.7248575000e-2],
    [-2.1121328000, 2.2132200000e-2, -4.6164708000e-2],
    [-2.1452296000, 2.1868280000e-2, -4.5119160000e-2],
    [-2.1766398000, 2.1603063000e-2, -4.4109431000e-2],
    [-2.2064546000, 2.1336479000e-2, -4.3133464000e-2],
    [-2.2347634000, 2.1068700000e-2, -4.2189540000e-2],
    [-2.2616531000, 2.0800053000e-2, -4.1276184000e-2],
    [-2.2872080000, 2.0530962000e-2, -4.0392105000e-2],
])

_RE = 6.371e6  # Earth radius [m]


def love_scaling(nmax: int, rho_w: float = 1035.0,
                 rho_e: float = 5517.0) -> np.ndarray:
    """Per-degree SAL scaling 3/(2n+1) (rho_w/rho_e) (1 + k'_n - h'_n),
    with the degree-1 CM to CF conversion (calc_love_scaling)."""
    if nmax + 1 > LOVE_NUMBERS.shape[0]:
        raise ValueError(f"SAL_HARMONICS_DEGREE {nmax} exceeds the "
                         f"stored Love table ({LOVE_NUMBERS.shape[0]-1})")
    H = LOVE_NUMBERS[:nmax + 1, 0].copy()
    L = LOVE_NUMBERS[:nmax + 1, 1].copy()
    K = LOVE_NUMBERS[:nmax + 1, 2].copy()
    if nmax > 0:
        h1, l1 = H[1], L[1]
        H[1] = (2.0 / 3.0) * (h1 - l1)
        L[1] = (-1.0 / 3.0) * (h1 - l1)
        K[1] = (-1.0 / 3.0) * h1 - (2.0 / 3.0) * l1 - 1.0
    n = np.arange(nmax + 1)
    return (3.0 / (2.0 * n + 1.0)) * (rho_w / rho_e) * (1.0 + K - H)


def _real_sph_basis(lat_deg, lon_deg, nmax: int):
    """Orthonormal real spherical-harmonic basis rows at the points and
    the degree of each row."""
    from scipy.special import sph_harm_y
    colat = np.deg2rad(90.0 - np.asarray(lat_deg, np.float64))
    lam = np.deg2rad(np.asarray(lon_deg, np.float64))
    rows, degs = [], []
    for n in range(nmax + 1):
        for m in range(0, n + 1):
            Y = sph_harm_y(n, m, colat, lam)  # complex, orthonormal
            if m == 0:
                rows.append(np.real(Y))
                degs.append(n)
            else:
                rows.append(np.sqrt(2.0) * np.real(Y))
                rows.append(np.sqrt(2.0) * np.imag(Y))
                degs.extend([n, n])
    return np.stack(rows), np.asarray(degs)


@dataclasses.dataclass(frozen=True)
class SALHarmonics:
    """The SAL operator eta (njh, nih) -> eta_sal."""
    basis: torch.Tensor       # (L, njh*nih)
    weights: torch.Tensor     # (njh*nih,) area/Re^2 on wet compute cells
    love: torch.Tensor        # (L,) the degree scaling of each row
    shape: tuple

    @classmethod
    def build(cls, grid, nmax: int, rho_w: float = 1035.0,
              rho_e: float = 5517.0) -> "SALHarmonics":
        """The operator on ``grid``'s h points, on its device and in its
        dtype (the basis is computed in float64 on the host)."""
        lat = grid.geoLatT.detach().cpu().double().numpy()
        lon = grid.geoLonT.detach().cpu().double().numpy()
        B, degs = _real_sph_basis(lat.ravel(), lon.ravel(), nmax)
        scal = love_scaling(nmax, rho_w, rho_e)[degs]
        # analysis weights over the compute cells only: the halo cells
        # repeat interior area under reentrant fills
        dom = grid.domain
        interior = np.zeros(lat.shape)
        interior[dom.halo:dom.halo + dom.nj, dom.halo:dom.halo + dom.ni] = 1.0
        w = (grid.areaT.detach().cpu().double().numpy()
             * grid.mask2dT.detach().cpu().double().numpy()
             * interior).ravel() / _RE ** 2
        dev = dict(device=grid.areaT.device, dtype=grid.areaT.dtype)
        return cls(basis=torch.as_tensor(B, **dev),
                   weights=torch.as_tensor(w, **dev),
                   love=torch.as_tensor(scal, **dev), shape=lat.shape)

    def __call__(self, eta):
        """eta_sal = B^T Lambda B (w eta)."""
        flat = eta.reshape(self.shape[0] * self.shape[1])
        a = torch.matmul(self.basis, self.weights * flat)
        out = torch.matmul(self.basis.T, self.love * a)
        return out.reshape(self.shape)
