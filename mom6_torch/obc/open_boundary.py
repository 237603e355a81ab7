"""Open boundary conditions.

Counterpart of ``mom6_tpu.obc.open_boundary``: the ``OBC_SEGMENT_%03d``
specs ("J=N,I=N:0,FLATHER,ORLANSKI") parse into edge segments, whole or
partial, with constant (``U=value:...``) or file-profile
(``U=file:name.nc(var)``) external data, time-interpolated when the
file holds several records.  ``OpenBoundaries`` carries, per open edge,
a mask of the cells its operators write (the boundary face and the halo
band beyond it, inside the segment's strip) and the external data, and
offers

* ``extend``: the zero-gradient copy of the edge value into the halo
  beyond each open edge;
* ``apply_flather_u/v``: the Flather (1976) radiation of the
  barotropic velocity at the boundary faces,
  ``ubt = 0.5*((u_inlet + u_ext) +- (c/D)*(ssh_in - ssh_ext))``;
* ``radiate_u/v``: the Orlanski radiation of the baroclinic
  velocities, with the optional NUDGED relaxation to the segment data;
* the tracer reservoirs (``init_``, ``update_``,
  ``apply_tracer_reservoirs``) and ``keep_boundary``.

``open_grid_masks`` opens the grid's land masks across the open edges.
Everything runs on one device; the multi-device re-blocking of the
masks (``blockify_obc`` of the JAX package) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import numpy as np
import torch

from mom6_torch.parallel.domain import Domain, tree_map
from mom6_torch.parallel.stencil import ip1, jp1

__all__ = ["Segment", "OpenBoundaries", "parse_segments",
           "build_open_boundaries", "build_obc_data_interp",
           "open_grid_masks"]


@dataclasses.dataclass(frozen=True)
class Segment:
    direction: str            # 'N' | 'S' | 'E' | 'W'
    flather: bool = True
    orlanski: bool = True
    gradient: bool = False
    # NUDGED: the baroclinic velocities relax toward the segment data
    # with separate inflow/outflow timescales [s]
    nudged: bool = False
    tau_in: float = 0.0
    tau_out: float = 0.0
    u_ext: object = 0.0       # float, or along-edge profile array
    v_ext: object = 0.0
    ssh_ext: object = 0.0
    lo: int | None = None     # perpendicular global range [lo, hi);
    hi: int | None = None     # None = the whole edge
    tracer_ext: dict | None = None   # external tracer values by name
    # time-varying file data: key ('U'|'V'|'SSH') ->
    # (series (nt[,len]), times_s, period_s); None when all static
    data_series: dict | None = None


def _load_segment_series(indir: str, fname: str, var: str):
    """(series, times_s, period_s) of a segment-data variable: series is
    (nt,) for scalars or (nt, edge_len) for profiles, with singleton
    axes dropped and any vertical axis averaged."""
    from scipy.io import netcdf_file
    from mom6_torch.framework.interp_external import find_time
    with netcdf_file(os.path.join(indir, fname), "r", mmap=False) as nc:
        v = nc.variables[var]
        taxis, times, period = find_time(nc, v)
        arr = np.array(v[:], dtype=np.float64)
    if taxis is None:
        arr, times = arr[None], np.zeros(1)
    elif taxis != 0:
        arr = np.moveaxis(arr, taxis, 0)
    arr = arr.reshape((arr.shape[0],)
                      + tuple(n for n in arr.shape[1:] if n != 1))
    while arr.ndim > 2:
        arr = arr.mean(axis=1)
    return arr, times, period


def parse_segments(pf, indir: str = ".") -> list[Segment]:
    """OBC_NUMBER_OF_SEGMENTS and OBC_SEGMENT_%03d (+ _DATA, and the
    nudging timescales of NUDGED segments).  A file datum's first record
    is the segment's static value; a file with several records also
    fills ``Segment.data_series``."""
    n = pf.get("OBC_NUMBER_OF_SEGMENTS", int, 0)
    segs = []
    for i in range(1, n + 1):
        spec = pf.get(f"OBC_SEGMENT_{i:03d}", str, "")
        if not spec:
            continue
        up = spec.upper().replace(" ", "")
        m = re.match(r"(I|J)=(0|N)", up)
        if not m:
            raise ValueError(f"Cannot parse OBC segment spec '{spec}'")
        axis, pos = m.group(1), m.group(2)
        # the perpendicular range ("J=N,I=3:10"), normalized; a range
        # over the whole edge stays None
        lo = hi = None
        rm = re.search(r",(?:I|J)=(N|-?\d+):(N|-?\d+)", up)
        if rm and set(rm.groups()) != {"0", "N"}:
            a_, b_ = rm.groups()
            if "N" not in (a_, b_):
                lo, hi = sorted((int(a_), int(b_)))
            else:
                lo = int(b_ if a_ == "N" else a_)
        if axis == "I":
            direction = "W" if pos == "0" else "E"
        else:
            direction = "S" if pos == "0" else "N"
        data = pf.get(f"OBC_SEGMENT_{i:03d}_DATA", str, "")
        vals = {"U": 0.0, "V": 0.0, "SSH": 0.0}
        tracer_ext = {}
        data_series = {}
        for part in data.split(","):
            dm = re.match(r'\s*(\w+)=value:([-0-9.eE+]+)', part)
            fm = re.match(r'\s*(\w+)=file:([^(]+)\((\w+)\)', part)
            if dm:
                key, v = dm.group(1), float(dm.group(2))
            elif fm:
                key = fm.group(1)
                series, times, period = _load_segment_series(
                    indir, fm.group(2), fm.group(3))
                v = float(series[0]) if np.ndim(series[0]) == 0 \
                    else series[0]
                if series.shape[0] > 1 and key in vals:
                    data_series[key] = (series, times, period)
            else:
                continue
            if key in vals:
                vals[key] = v
            else:
                # an external tracer value for the reservoirs; TEMP and
                # SALT are T and S
                name = {"TEMP": "T", "PTEMP": "T",
                        "SALT": "S"}.get(key, key.lower())
                tracer_ext[name] = v
        nudged = "NUDGED" in up
        tau_in = tau_out = 0.0
        if nudged:
            tn = pf.get(f"OBC_SEGMENT_{i:03d}_VELOCITY_NUDGING_TIMESCALES",
                        list, [0.0, 0.0], units="days")
            tau_in = float(tn[0]) * 86400.0
            tau_out = float(tn[1]) * 86400.0 if len(tn) > 1 else tau_in
        segs.append(Segment(direction=direction, flather="FLATHER" in up,
                            orlanski="ORLANSKI" in up,
                            gradient="GRADIENT" in up, nudged=nudged,
                            tau_in=tau_in, tau_out=tau_out,
                            u_ext=vals["U"], v_ext=vals["V"],
                            ssh_ext=vals["SSH"], lo=lo, hi=hi,
                            tracer_ext=tracer_ext,
                            data_series=data_series or None))
    return segs


def _span(s: Segment, n: int, H: int):
    """(lo, hi) of a segment on an edge of n points, and the padded
    range (plo, phi) it owns: a whole-edge segment also owns the corner
    halos."""
    lo = 0 if s.lo is None else max(0, s.lo)
    hi = n if s.hi is None else min(n, s.hi)
    if s.lo is None and s.hi is None:
        return lo, hi, 0, n + 2 * H
    return lo, hi, H + lo, H + hi


def build_obc_data_interp(pf, domain: Domain, obc: "OpenBoundaries",
                          indir: str = "."):
    """When a ``KEY=file:...`` datum has several time records: the
    update ``fn(obc, grid, h, t) -> obc`` that replaces the affected
    ssh_*/u_*/v_* edge fields with the data interpolated linearly to the
    model time ``t`` [s].  None when every datum is static."""
    segs = parse_segments(pf, indir)
    if not any(s.data_series for s in segs):
        return None
    from mom6_torch.framework.interp_external import ExternalField
    H, ni, nj = domain.halo, domain.ni, domain.nj
    extent = {"W": nj, "E": nj, "S": ni, "N": ni}
    field_of = {("W", "U"): "u_w", ("E", "U"): "u_e",
                ("S", "V"): "v_s", ("N", "V"): "v_n",
                ("W", "SSH"): "ssh_w", ("E", "SSH"): "ssh_e",
                ("S", "SSH"): "ssh_s", ("N", "SSH"): "ssh_n"}
    ref = obc.strip_w if obc.strip_w is not None else next(
        s for s in (obc.strip_e, obc.strip_s, obc.strip_n) if s is not None)
    stacks = {}   # field -> (numpy stack (nt, njh, nih), times, period)
    for s in segs:
        for key, (series, times, period) in (s.data_series or {}).items():
            fname = field_of.get((s.direction, key))
            if fname is None:
                continue
            base = getattr(obc, fname)
            base = base.cpu().numpy() if torch.is_tensor(base) \
                else np.asarray(base)
            base2d = base * np.ones((nj + 2 * H, ni + 2 * H))
            n = extent[s.direction]
            lo, hi, plo, phi = _span(s, n, H)
            whole = s.lo is None and s.hi is None
            nt = series.shape[0]
            if fname in stacks:
                stack, t_prev, _ = stacks[fname]
                if stack.shape[0] != nt or not np.array_equal(t_prev, times):
                    raise ValueError(
                        f"OBC segment data for {fname}: segments on the "
                        "same edge must share one time axis")
            else:
                stack = np.repeat(base2d[None], nt, axis=0)
            vals = series if series.ndim == 2 \
                else np.repeat(series[:, None], phi - plo, axis=1)
            if vals.shape[1] == n:
                vals = vals[:, lo:hi] if not whole \
                    else np.pad(vals, ((0, 0), (H, H)), mode="edge")
            elif vals.shape[1] != phi - plo:
                raise ValueError(
                    f"{fname}: segment data profile length "
                    f"{vals.shape[1]} matches neither the segment extent "
                    f"{phi - plo} nor the edge length {n}")
            if s.direction in ("W", "E"):
                stack[:, plo:phi, :] = vals[:, :, None]
            else:
                stack[:, :, plo:phi] = vals[:, None, :]
            stacks[fname] = (stack, times, period)
    efs = {f: ExternalField(torch.as_tensor(st, dtype=ref.dtype,
                                            device=ref.device), t, p)
           for f, (st, t, p) in stacks.items()}

    def update(obc, grid, h, t):
        return dataclasses.replace(obc, **{f: ef.at(t)
                                           for f, ef in efs.items()})
    return update


def _ndim(v) -> int:
    return v.dim() if torch.is_tensor(v) else 0


@dataclasses.dataclass(frozen=True)
class OpenBoundaries:
    """The open edges, their write masks and their external data."""
    open_w: bool
    open_e: bool
    open_s: bool
    open_n: bool
    halo: int
    nil: int
    njl: int
    # external data per edge: scalars, or (njh, nih) fields painted per
    # segment (profile data varies along the edge)
    ssh_w: object = 0.0
    ssh_e: object = 0.0
    ssh_s: object = 0.0
    ssh_n: object = 0.0
    u_w: object = 0.0
    u_e: object = 0.0
    v_s: object = 0.0
    v_n: object = 0.0
    # per-edge (njh, nih) masks: 1 exactly at the cells this edge's
    # operators may modify (boundary face + halo band, inside the
    # segment's strip)
    strip_w: Optional[torch.Tensor] = None
    strip_e: Optional[torch.Tensor] = None
    strip_s: Optional[torch.Tensor] = None
    strip_n: Optional[torch.Tensor] = None
    # per-edge velocity-nudging timescales [s] (0 = not nudged)
    tau_in_w: float = 0.0
    tau_out_w: float = 0.0
    tau_in_e: float = 0.0
    tau_out_e: float = 0.0
    tau_in_s: float = 0.0
    tau_out_s: float = 0.0
    tau_in_n: float = 0.0
    tau_out_n: float = 0.0
    rx_max: float = 10.0          # OBC_RADIATION_MAX
    res_len_out: float = 1.0e4    # OBC_TRACER_RESERVOIR_LENGTH_SCALE_OUT
    res_len_in: float = 3.0e5     # OBC_TRACER_RESERVOIR_LENGTH_SCALE_IN
    # external tracer values from segment DATA:
    # (("E", (("T", 10.0), ...)), ...)
    tracer_ext: tuple = ()

    def _xval(self, v, col):
        """External datum at a W/E boundary column: the per-row profile
        of a painted field, else the scalar."""
        return v[..., :, col] if _ndim(v) == 2 else v

    def _yval(self, v, row):
        return v[..., row, :] if _ndim(v) == 2 else v

    @staticmethod
    def _blend_x(a, cols, val, strip):
        """a[..., :, cols] = val where the W/E mask is open."""
        out = a.clone()
        if strip is None:
            out[..., :, cols] = val
        else:
            out[..., :, cols] = torch.where(strip[:, cols] > 0, val,
                                            a[..., :, cols])
        return out

    @staticmethod
    def _blend_y(a, rows, val, strip):
        out = a.clone()
        if strip is None:
            out[..., rows, :] = val
        else:
            out[..., rows, :] = torch.where(strip[rows, :] > 0, val,
                                            a[..., rows, :])
        return out

    def extend(self, f):
        """Copy the interior edge value into every halo cell beyond each
        open edge, W, E, then S, N (a tensor or a nest of them)."""
        H, ni, nj = self.halo, self.nil, self.njl

        def ext(a):
            if self.open_w:
                a = self._blend_x(a, slice(0, H), a[..., :, H:H + 1],
                                  self.strip_w)
            if self.open_e:
                a = self._blend_x(a, slice(H + ni, None),
                                  a[..., :, H + ni - 1:H + ni], self.strip_e)
            if self.open_s:
                a = self._blend_y(a, slice(0, H), a[..., H:H + 1, :],
                                  self.strip_s)
            if self.open_n:
                a = self._blend_y(a, slice(H + nj, None),
                                  a[..., H + nj - 1:H + nj, :], self.strip_n)
            return a
        return tree_map(ext, f)

    @staticmethod
    def wave_over_depth(D, g: float):
        """sqrt(g max(D, 1e-10)) / max(D, 1e-10), the Flather factor on
        the face depths D, divided tensor by tensor."""
        Dm = torch.clamp(D, min=1e-10)
        return torch.sqrt(g * Dm) / Dm

    def apply_flather_u(self, ubt, eta, D_u, g: float):
        """ubt at the W/E boundary faces by Flather radiation: the E face
        is the east face of the last interior cell (index H+nil-1), the
        W face the west face of the first (index H-1, a halo column)."""
        H, ni = self.halo, self.nil
        if self.open_e:
            iE = H + ni - 1
            val = 0.5 * ((ubt[..., :, iE - 1] + self._xval(self.u_e, iE))
                         + self.wave_over_depth(D_u[..., :, iE], g)
                         * (eta[..., :, iE] - self._xval(self.ssh_e, iE)))
            ubt = self._blend_x(ubt, iE, val, self.strip_e)
        if self.open_w:
            iW = H - 1
            val = 0.5 * ((ubt[..., :, H] + self._xval(self.u_w, iW))
                         + self.wave_over_depth(D_u[..., :, iW], g)
                         * (self._xval(self.ssh_w, iW) - eta[..., :, H]))
            ubt = self._blend_x(ubt, iW, val, self.strip_w)
        return ubt

    def apply_flather_v(self, vbt, eta, D_v, g: float):
        H, nj = self.halo, self.njl
        if self.open_n:
            jN = H + nj - 1
            val = 0.5 * ((vbt[..., jN - 1, :] + self._yval(self.v_n, jN))
                         + self.wave_over_depth(D_v[..., jN, :], g)
                         * (eta[..., jN, :] - self._yval(self.ssh_n, jN)))
            vbt = self._blend_y(vbt, jN, val, self.strip_n)
        if self.open_s:
            jS = H - 1
            val = 0.5 * ((vbt[..., H, :] + self._yval(self.v_s, jS))
                         + self.wave_over_depth(D_v[..., jS, :], g)
                         * (self._yval(self.ssh_s, jS) - eta[..., H, :]))
            vbt = self._blend_y(vbt, jS, val, self.strip_s)
        return vbt

    @staticmethod
    def _nudge(val, ext, outflow, tau_in, tau_out, dt):
        """Relax the radiated value toward the segment data, implicitly
        in dt/tau, with the outflow or the inflow timescale."""
        if dt <= 0.0 or (tau_in <= 0.0 and tau_out <= 0.0):
            return val
        r_in = dt / tau_in if tau_in > 0.0 else 0.0
        r_out = dt / tau_out if tau_out > 0.0 else 0.0
        r = torch.where(outflow, torch.full_like(val, r_out),
                        torch.full_like(val, r_in))
        return val + (r / (1.0 + r)) * (ext - val)

    def _rx(self, num, den):
        """The Orlanski phase speed num/den in [0, rx_max], den nudged
        off zero by 1e-30."""
        eps = 1e-30
        den = torch.where(torch.abs(den) > eps, den, den + eps)
        return torch.clamp(num / den, 0.0, self.rx_max)

    def radiate_u(self, u_new, u_old, dt: float = 0.0):
        """Orlanski (1976) radiation at the open E/W faces: the phase
        speed rx = (u_old - u_new)/(u_old - u_old_in) one face in, and
        u_b = (u_b_old + rx u_new_in)/(1 + rx), then the NUDGED
        relaxation; outflow is rx > 0."""
        H, ni = self.halo, self.nil

        def rad(iB, i1, i2, tau_in, tau_out, ext, strip):
            rx = self._rx(u_old[..., :, i1] - u_new[..., :, i1],
                          u_old[..., :, i1] - u_old[..., :, i2])
            val = (u_old[..., :, iB] + rx * u_new[..., :, i1]) / (1.0 + rx)
            val = self._nudge(val, self._xval(ext, iB), rx > 0.0, tau_in,
                              tau_out, dt)
            return self._blend_x(u_new, iB, val, strip)

        if self.open_e:
            iE = H + ni - 1
            u_new = rad(iE, iE - 1, iE - 2, self.tau_in_e, self.tau_out_e,
                        self.u_e, self.strip_e)
        if self.open_w:
            iW = H - 1
            u_new = rad(iW, iW + 1, iW + 2, self.tau_in_w, self.tau_out_w,
                        self.u_w, self.strip_w)
        return u_new

    def radiate_v(self, v_new, v_old, dt: float = 0.0):
        H, nj = self.halo, self.njl

        def rad(jB, j1, j2, tau_in, tau_out, ext, strip):
            rx = self._rx(v_old[..., j1, :] - v_new[..., j1, :],
                          v_old[..., j1, :] - v_old[..., j2, :])
            val = (v_old[..., jB, :] + rx * v_new[..., j1, :]) / (1.0 + rx)
            val = self._nudge(val, self._yval(ext, jB), rx > 0.0, tau_in,
                              tau_out, dt)
            return self._blend_y(v_new, jB, val, strip)

        if self.open_n:
            jN = H + nj - 1
            v_new = rad(jN, jN - 1, jN - 2, self.tau_in_n, self.tau_out_n,
                        self.v_n, self.strip_n)
        if self.open_s:
            jS = H - 1
            v_new = rad(jS, jS + 1, jS + 2, self.tau_in_s, self.tau_out_s,
                        self.v_s, self.strip_s)
        return v_new

    def init_tracer_reservoirs(self, tracers: dict) -> dict:
        """Per-edge reservoirs seeded from the interior edge cells, or
        from the segment's external value of that tracer: name -> edge
        -> (nk, edge_len)."""
        H, ni, nj = self.halo, self.nil, self.njl
        ext = {e: dict(kv) for e, kv in self.tracer_ext}
        out = {}
        for name, t in tracers.items():
            r = {}
            if self.open_w:
                r["W"] = t[..., :, H]
            if self.open_e:
                r["E"] = t[..., :, H + ni - 1]
            if self.open_s:
                r["S"] = t[..., H, :]
            if self.open_n:
                r["N"] = t[..., H + nj - 1, :]
            for edge in r:
                if name in ext.get(edge, {}):
                    r[edge] = torch.full_like(r[edge], ext[edge][name])
            out[name] = r
        return out

    def update_tracer_reservoirs(self, reservoirs: dict, tracers: dict,
                                 u, v, dt, len_out=None, len_in=None):
        """Outflow drags a reservoir toward the interior edge value at
        the rate |u| dt / L_out; inflow relaxes it toward the segment's
        external value, where one was given, at |u| dt / L_in."""
        H, ni, nj = self.halo, self.nil, self.njl
        len_out = self.res_len_out if len_out is None else len_out
        len_in = self.res_len_in if len_in is None else len_in
        ext = {e: dict(kv) for e, kv in self.tracer_ext}

        def upd(r, t_edge, vel_edge, outflow_positive, ext_val):
            vout = torch.clamp(vel_edge if outflow_positive else -vel_edge,
                               min=0.0)
            r = r + torch.clamp(vout * dt / len_out, 0.0, 1.0) * (t_edge - r)
            if ext_val is not None:
                vin = torch.clamp(-vel_edge if outflow_positive
                                  else vel_edge, min=0.0)
                r = r + torch.clamp(vin * dt / len_in, 0.0, 1.0) \
                    * (ext_val - r)
            return r

        new = {}
        for name, r in reservoirs.items():
            t = tracers[name]
            nr = dict(r)
            if "W" in nr:      # outflow is westward: u < 0
                nr["W"] = upd(nr["W"], t[..., :, H], u[..., :, H - 1],
                              False, ext.get("W", {}).get(name))
            if "E" in nr:
                nr["E"] = upd(nr["E"], t[..., :, H + ni - 1],
                              u[..., :, H + ni - 1], True,
                              ext.get("E", {}).get(name))
            if "S" in nr:
                nr["S"] = upd(nr["S"], t[..., H, :], v[..., H - 1, :],
                              False, ext.get("S", {}).get(name))
            if "N" in nr:
                nr["N"] = upd(nr["N"], t[..., H + nj - 1, :],
                              v[..., H + nj - 1, :], True,
                              ext.get("N", {}).get(name))
            new[name] = nr
        return new

    def keep_boundary(self, orig, filled):
        """The pre-fill values inside the OBC bands after a halo fill
        (which writes zeros beyond a wall and would erase the boundary
        transports and halo thicknesses)."""
        m = None
        for s in (self.strip_w, self.strip_e, self.strip_s, self.strip_n):
            if s is not None:
                m = s if m is None else torch.maximum(m, s)
        if m is None:
            return filled
        return _map2(lambda o, f: torch.where(m > 0, o, f), orig, filled)

    def apply_tracer_reservoirs(self, tracers: dict,
                                reservoirs: dict) -> dict:
        """The halo cells beyond each open edge take the reservoir
        value, so that inflow carries reservoir tracer."""
        H, ni, nj = self.halo, self.nil, self.njl
        out = {}
        for name, t in tracers.items():
            r = reservoirs.get(name, {})
            if "W" in r:
                t = self._blend_x(t, slice(0, H), r["W"][..., :, None],
                                  self.strip_w)
            if "E" in r:
                t = self._blend_x(t, slice(H + ni, None),
                                  r["E"][..., :, None], self.strip_e)
            if "S" in r:
                t = self._blend_y(t, slice(0, H), r["S"][..., None, :],
                                  self.strip_s)
            if "N" in r:
                t = self._blend_y(t, slice(H + nj, None),
                                  r["N"][..., None, :], self.strip_n)
            out[name] = t
        return out


def _map2(fn, a, b):
    """``fn`` over the paired tensor leaves of two nests of one shape."""
    if torch.is_tensor(a):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return type(a)(_map2(fn, x, y) for x, y in zip(a, b))


def build_open_boundaries(pf, domain: Domain, indir: str = ".",
                          dye_tracers: int = 0, *, device="cuda",
                          dtype: torch.dtype = torch.float64
                          ) -> Optional[OpenBoundaries]:
    """The open boundaries the parameters describe, None without
    segments.  With ``dye_tracers``, segment m supplies a unit
    concentration of dye m and none of the others."""
    segs = parse_segments(pf, indir)
    if not segs:
        return None
    if dye_tracers:
        for m, s in enumerate(segs, 1):
            for n in range(1, dye_tracers + 1):
                s.tracer_ext.setdefault(f"dye_{n:02d}",
                                        1.0 if n == m else 0.0)
    dev = dict(device=device, dtype=dtype)
    H, ni, nj = domain.halo, domain.ni, domain.nj
    kw = dict(open_w=False, open_e=False, open_s=False, open_n=False,
              halo=H, nil=domain.ni, njl=domain.nj)
    data = {}
    extent = {"W": nj, "E": nj, "S": ni, "N": ni}
    strips = {d: None for d in extent}

    def seg_strip(d, s):
        st = torch.zeros((nj + 2 * H, ni + 2 * H), **dev)
        _, _, plo, phi = _span(s, extent[d], H)
        if d == "W":
            st[plo:phi, 0:H] = 1.0
        elif d == "E":
            st[plo:phi, H + ni - 1:] = 1.0
        elif d == "S":
            st[0:H, plo:phi] = 1.0
        else:
            st[H + nj - 1:, plo:phi] = 1.0
        return st

    ext_pairs = {d: [] for d in extent}     # (segment, ssh, vel)
    for s in segs:
        d = s.direction
        kw["open_" + d.lower()] = True
        if s.nudged:
            data["tau_in_" + d.lower()] = s.tau_in
            data["tau_out_" + d.lower()] = s.tau_out
        ext_pairs[d].append(
            (s, s.ssh_ext, s.u_ext if d in ("W", "E") else s.v_ext))
        st = seg_strip(d, s)
        strips[d] = st if strips[d] is None else torch.maximum(strips[d], st)
    for d in extent:
        if strips[d] is not None:
            data["strip_" + d.lower()] = strips[d]

    def paint_edge(d, pairs, which):
        """One scalar datum stays a scalar; profiles or several segments
        paint an (njh, nih) field, uniform across the edge."""
        vals = [p[which] for p in pairs]
        if len(pairs) == 1 and np.ndim(vals[0]) == 0:
            return float(vals[0])
        n = extent[d]
        vec = np.zeros(n + 2 * H)
        for (s, *_), v in zip(pairs, vals):
            lo, hi, _, _ = _span(s, n, H)
            v = np.asarray(v, np.float64)
            if v.ndim == 1 and v.size not in (hi - lo, n):
                raise ValueError(
                    f"segment data profile length {v.size} matches neither "
                    f"the segment extent {hi - lo} nor the edge length {n}")
            vec[H + lo:H + hi] = v[lo:hi] if v.ndim == 1 and v.size == n \
                else v
        vec[:H] = vec[H]
        vec[n + H:] = vec[n + H - 1]
        f2 = np.tile(vec[:, None], (1, ni + 2 * H)) if d in ("W", "E") \
            else np.tile(vec[None, :], (nj + 2 * H, 1))
        return torch.as_tensor(f2, **dev)

    for d, s_key, v_key in (("W", "ssh_w", "u_w"), ("E", "ssh_e", "u_e"),
                            ("S", "ssh_s", "v_s"), ("N", "ssh_n", "v_n")):
        if ext_pairs[d]:
            data[s_key] = paint_edge(d, ext_pairs[d], 1)
            data[v_key] = paint_edge(d, ext_pairs[d], 2)
    data["rx_max"] = pf.get("OBC_RADIATION_MAX", float, 10.0)
    data["res_len_out"] = pf.get("OBC_TRACER_RESERVOIR_LENGTH_SCALE_OUT",
                                 float, 1.0e4, units="m")
    data["res_len_in"] = pf.get("OBC_TRACER_RESERVOIR_LENGTH_SCALE_IN",
                                float, 3.0e5, units="m")
    text = {}
    for s in segs:
        if s.tracer_ext:
            text.setdefault(s.direction, {}).update(s.tracer_ext)
    data["tracer_ext"] = tuple(
        (e, tuple(sorted(kv.items()))) for e, kv in sorted(text.items()))
    return OpenBoundaries(**kw, **data)


def open_grid_masks(grid, obc: OpenBoundaries):
    """The grid with its land masks opened across the open edges: halo
    cells beyond a segment become ocean with the edge's depth, and the
    face masks are derived again."""
    maskT = obc.extend(grid.mask2dT)
    maskCu = maskT * ip1(maskT)
    maskCv = maskT * jp1(maskT)
    return dataclasses.replace(grid, mask2dT=maskT,
                               bathyT=obc.extend(grid.bathyT),
                               mask2dCu=maskCu, mask2dCv=maskCv,
                               mask2dBu=maskCu * jp1(maskCu))
