"""Time-dependent user open-boundary updates.

Counterpart of ``mom6_tpu.obc.boundary_update``: a registry of named
updaters (OBC_USER_CONFIG) that refresh the open boundaries' external
data every step: the external-mode Kelvin wave, the tidal bay, the
shelf wave, the supercritical channel and the dyed channel.  An updater
is ``fn(obc, grid, h, t) -> obc`` at the model time ``t`` [s]; it
replaces only the ssh_*/u_*/v_* fields.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["register_obc_update", "build_obc_update", "kelvin_update",
           "tidal_bay_update", "shelfwave_update", "supercritical_update",
           "dyed_channel_update"]


@dataclasses.dataclass(frozen=True)
class KelvinCfg:
    f0: float = 1e-4              # F_0 [s-1]
    wave_period: float = 44567.0  # KELVIN_WAVE_PERIOD [s]
    ssh_amp: float = 1.0          # KELVIN_WAVE_SSH_AMP [m]
    g: float = 9.8
    lat_scale: float = 1000.0     # along-coast coordinate scale [m/unit]
    south: float = 0.0


def kelvin_update(cfg: KelvinCfg):
    """A coastal Kelvin wave of the external mode entering through the
    W/S boundary: SSH = A exp(-f y/c) cos(wt) and the inflow c SSH / D
    in quadrature."""
    omega = 2.0 * math.pi / cfg.wave_period

    def update(obc, grid, h, t):
        repl = {}
        H = obc.halo
        val1 = math.sin(omega * t)
        cos_t = math.cos(omega * t)
        if obc.open_w:
            D = torch.clamp(torch.sum(h[..., :, H], dim=0), min=1e-3)
            c = torch.sqrt(cfg.g * D)
            y = (grid.geoLatCu[..., :, H - 1] - cfg.south) * cfg.lat_scale
            val2 = cfg.ssh_amp * torch.exp(-cfg.f0 * y / c)
            ones = torch.ones_like(grid.geoLatCu)
            repl["ssh_w"] = (val2 * cos_t)[..., :, None] * ones
            repl["u_w"] = (val2 * val1 * c / D)[..., :, None] * ones
        if obc.open_s:
            D = torch.clamp(torch.sum(h[..., H, :], dim=0), min=1e-3)
            c = torch.sqrt(cfg.g * D)
            x = grid.geoLonCv[..., H - 1, :] * cfg.lat_scale
            val2 = cfg.ssh_amp * torch.exp(-cfg.f0 * x / c)
            ones = torch.ones_like(grid.geoLonCv)
            repl["ssh_s"] = (val2 * cos_t)[..., None, :] * ones
            repl["v_s"] = (val2 * val1 * c / D)[..., None, :] * ones
        return dataclasses.replace(obc, **repl) if repl else obc
    return update


@dataclasses.dataclass(frozen=True)
class TidalBayCfg:
    tide_flow: float = 3.0e6      # TIDAL_BAY_FLOW [m3 s-1]
    tide_period: float = 43200.0  # TIDAL_BAY_PERIOD [s]
    tide_ssh_amp: float = 0.0     # TIDAL_BAY_SSH_AMP [m]


def tidal_bay_update(cfg: TidalBayCfg):
    """An oscillating barotropic flow through every open segment, spread
    evenly over the open face area."""
    omega = 2.0 * math.pi / cfg.tide_period

    def update(obc, grid, h, t):
        H = obc.halo
        cff_eta = cfg.tide_ssh_amp * math.sin(omega * t)
        flux = -cfg.tide_flow * math.sin(omega * t)
        area = torch.zeros((), dtype=h.dtype, device=h.device)
        pieces = []
        if obc.open_w and obc.strip_w is not None:
            iW = H - 1
            area = area + torch.sum(obc.strip_w[..., :, iW]
                                    * grid.dyCu[..., :, iW]
                                    * torch.sum(h[..., :, H], dim=0))
            pieces.append("w")
        if obc.open_e and obc.strip_e is not None:
            iE = H + obc.nil - 1
            area = area + torch.sum(obc.strip_e[..., :, iE]
                                    * grid.dyCu[..., :, iE]
                                    * torch.sum(h[..., :, iE], dim=0))
            pieces.append("e")
        if obc.open_s and obc.strip_s is not None:
            jS = H - 1
            area = area + torch.sum(obc.strip_s[..., jS, :]
                                    * grid.dxCv[..., jS, :]
                                    * torch.sum(h[..., H, :], dim=0))
            pieces.append("s")
        if obc.open_n and obc.strip_n is not None:
            jN = H + obc.njl - 1
            area = area + torch.sum(obc.strip_n[..., jN, :]
                                    * grid.dxCv[..., jN, :]
                                    * torch.sum(h[..., jN, :], dim=0))
            pieces.append("n")
        vel = flux / torch.clamp(area, min=1e-10)
        repl = {}
        for edge in pieces:
            sign = 1.0 if edge in ("w", "s") else -1.0
            repl[("u_" if edge in ("w", "e") else "v_") + edge] = sign * vel
            repl["ssh_" + edge] = cff_eta
        return dataclasses.replace(obc, **repl) if repl else obc
    return update


@dataclasses.dataclass(frozen=True)
class ShelfwaveCfg:
    f0: float = 1e-4        # F_0 [s-1]
    amp: float = 1.0        # SHELFWAVE_AMPLITUDE [m s-1]
    Lx: float = 100.0       # SHELFWAVE_X_WAVELENGTH [axis units]
    Ly: float = 50.0        # SHELFWAVE_Y_LENGTH_SCALE [axis units]
    jj: float = 1.0         # SHELFWAVE_Y_MODE
    lenlat: float = 100.0
    west: float = 0.0
    south: float = 0.0


def shelfwave_update(cfg: ShelfwaveCfg):
    """A continental-shelf wave entering the W boundary:
    u = A e^(-a y) cos(l x - w t) (a sin(k y) + k cos(k y)) with
    w = 2 a f l / (k^2 + a^2 + l^2)."""
    alpha = 1.0 / cfg.Ly
    ll = 2.0 * math.pi / cfg.Lx
    kk = cfg.jj * math.pi / cfg.lenlat
    omega = 2.0 * alpha * cfg.f0 * ll / (kk * kk + alpha * alpha + ll * ll)

    def update(obc, grid, h, t):
        if not obc.open_w:
            return obc
        x = grid.geoLonCu - cfg.west
        y = grid.geoLatCu - cfg.south
        u = cfg.amp * torch.exp(-alpha * y) * torch.cos(ll * x - omega * t) \
            * (alpha * torch.sin(kk * y) + kk * torch.cos(kk * y))
        return dataclasses.replace(obc, u_w=u)
    return update


def supercritical_update(zonal_flow: float = 8.57):
    """A constant zonal inflow at the E/W boundaries and no normal flow
    at the N/S ones."""
    def update(obc, grid, h, t):
        repl = {}
        if obc.open_w:
            repl["u_w"] = torch.full_like(grid.geoLonCu, zonal_flow)
        if obc.open_e:
            repl["u_e"] = torch.full_like(grid.geoLonCu, zonal_flow)
        if obc.open_s:
            repl["v_s"] = torch.zeros_like(grid.geoLonCv)
        if obc.open_n:
            repl["v_n"] = torch.zeros_like(grid.geoLonCv)
        return dataclasses.replace(obc, **repl) if repl else obc
    return update


@dataclasses.dataclass(frozen=True)
class DyedChannelCfg:
    zonal_flow: float = 8.57   # CHANNEL_MEAN_FLOW [m s-1]
    tidal_amp: float = 0.0     # CHANNEL_TIDAL_AMP [m s-1]
    frequency: float = 0.0     # CHANNEL_FLOW_FREQUENCY [s-1]


def dyed_channel_update(cfg: DyedChannelCfg):
    """A mean and tidal flow through the E/W boundaries of a long
    channel."""
    def update(obc, grid, h, t):
        flow = cfg.zonal_flow
        if cfg.frequency != 0.0:
            flow = flow + cfg.tidal_amp * math.cos(
                2.0 * math.pi * cfg.frequency * t)
        repl = {}
        if obc.open_w:
            repl["u_w"] = flow * torch.ones_like(grid.geoLonCu)
        if obc.open_e:
            repl["u_e"] = flow * torch.ones_like(grid.geoLonCu)
        if obc.open_s:
            repl["v_s"] = torch.zeros_like(grid.geoLonCv)
        if obc.open_n:
            repl["v_n"] = torch.zeros_like(grid.geoLonCv)
        return dataclasses.replace(obc, **repl) if repl else obc
    return update


_REGISTRY = {}


def register_obc_update(name: str, builder):
    """Add a named updater ``builder(pf) -> fn`` to the registry."""
    _REGISTRY[name.lower()] = builder


def build_obc_update(pf, south: float = 0.0, axis_units: str = "k"):
    """The updater OBC_USER_CONFIG names, or None."""
    name = pf.get("OBC_USER_CONFIG", str, "none").strip().lower()
    if name in ("", "none"):
        return None
    lat_scale = 1000.0 if axis_units.startswith("k") else 111194.9266
    if name == "kelvin":
        cfg = KelvinCfg(
            f0=pf.get("F_0", float, 1e-4, units="s-1"),
            wave_period=pf.get("KELVIN_WAVE_PERIOD", float, 44567.0,
                               units="s"),
            ssh_amp=pf.get("KELVIN_WAVE_SSH_AMP", float, 1.0, units="m"),
            g=pf.get("G_EARTH", float, 9.8, units="m s-2"),
            lat_scale=lat_scale, south=south)
        if pf.get("KELVIN_WAVE_MODE", int, 0) != 0:
            raise ValueError("only the external (mode 0) Kelvin OBC "
                             "update is implemented")
        return kelvin_update(cfg)
    if name == "tidal_bay":
        return tidal_bay_update(TidalBayCfg(
            tide_flow=pf.get("TIDAL_BAY_FLOW", float, 3.0e6,
                             units="m3 s-1"),
            tide_period=pf.get("TIDAL_BAY_PERIOD", float, 43200.0,
                               units="s"),
            tide_ssh_amp=pf.get("TIDAL_BAY_SSH_AMP", float, 0.0,
                                units="m")))
    if name == "shelfwave":
        return shelfwave_update(ShelfwaveCfg(
            f0=pf.get("F_0", float, 1e-4, units="s-1"),
            amp=pf.get("SHELFWAVE_AMPLITUDE", float, 1.0, units="m s-1"),
            Lx=pf.get("SHELFWAVE_X_WAVELENGTH", float, 100.0),
            Ly=pf.get("SHELFWAVE_Y_LENGTH_SCALE", float, 50.0),
            jj=pf.get("SHELFWAVE_Y_MODE", float, 1.0),
            lenlat=pf.get("LENLAT", float, 100.0),
            west=pf.get("WESTLON", float, 0.0), south=south))
    if name == "supercritical":
        return supercritical_update(pf.get("SUPERCRITICAL_ZONAL_FLOW", float,
                                           8.57, units="m s-1"))
    if name == "dyed_channel":
        return dyed_channel_update(DyedChannelCfg(
            zonal_flow=pf.get("CHANNEL_MEAN_FLOW", float, 8.57,
                              units="m s-1"),
            tidal_amp=pf.get("CHANNEL_TIDAL_AMP", float, 0.0,
                             units="m s-1"),
            frequency=pf.get("CHANNEL_FLOW_FREQUENCY", float, 0.0,
                             units="s-1")))
    if name in _REGISTRY:
        return _REGISTRY[name](pf)
    raise ValueError(f"Unknown OBC_USER_CONFIG '{name}'")
