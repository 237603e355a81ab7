"""The obsolete-parameter guard.

Counterpart of ``mom6_tpu.framework.obsolete_params`` (the port keeps its
own copy of the table): a parameter that the reference retired is
flagged when the model is built, FATAL when it has no safe value or
holds another than its safe one, WARNING when it holds its safe value
(which is what the code now always does; the parameter then counts as
read).  ``build_model`` runs it before the unused-parameter audit, so
that a stale configuration fails with the reference's hint text.
"""

from __future__ import annotations

from mom6_torch.framework.error_handler import FATAL, WARNING, MOM_error

__all__ = ["check_obsolete_params"]

# (name, safe value or None, hint); a safe value of None makes any
# occurrence fatal
_OBSOLETE = [
    ("BLOCKED_ANALYTIC_FV_PGF", None,
     "The blocked analytic PGF has been removed."),
    ("ADD_KV_SLOW", None,
     "Kv_slow is always added when set_visc provides it."),
    ("OBC_CONFIG", None, "Use OBC_SEGMENT_xxx instead."),
    ("READ_OBC_ETA", None, "Use OBC segment data files instead."),
    ("READ_OBC_UV", None, "Use OBC segment data files instead."),
    ("READ_OBC_TS", None, "Use OBC segment data files instead."),
    ("EXTEND_OBC_SEGMENTS", None, "Segments are always extended."),
    ("MEKE_VISCOSITY_COEFF", None,
     "Use MEKE_VISCOSITY_COEFF_KU instead."),
    ("CONVERT_THICKNESS_UNITS", True, ""),
    ("MASK_MASSLESS_TRACERS", False, ""),
    ("SALT_REJECT_BELOW_ML", False, ""),
    ("MLE_USE_MLD_AVE_BUG", False, ""),
    ("CORRECT_DENSITY", True, ""),
    ("WINDSTRESS_STAGGER", "C", "Use WIND_STAGGER instead."),
    ("VSTAR_SCALE_FACTOR", None,
     "Use EPBL_VEL_SCALE_FACTOR instead."),
    ("VSTAR_SCALE_COEF", None, ""),
    ("ZSTAR_RIGID_SURFACE_THRESHOLD", None, ""),
    ("HENYEY_IGW_BACKGROUND_NEW", None, ""),
    ("CONTINUITY_SCHEME", "PPM",
     "Only the PPM continuity scheme remains."),
    ("BT_MASS_SOURCE_LIMIT", 0.0, ""),
    ("FIRST_GUESS_SURFACE_LAYER_DEPTH", None, ""),
    ("CORRECT_SURFACE_LAYER_AVERAGE", None, ""),
    ("SEAMOUNT_LENGTH_SCALE", None,
     "Use SEAMOUNT_X_LENGTH_SCALE instead."),
    ("USE_LATERAL_BOUNDARY_DIFFUSION", None,
     "Use USE_HORIZONTAL_BOUNDARY_DIFFUSION instead."),
    ("MSTAR_FIXED", None, "Instead use MSTAR_MODE."),
    ("USE_VISBECK_SLOPE_BUG", False, ""),
    ("Use_PP81", None,
     "get_param is case sensitive so use USE_PP81."),
    ("ALLOW_CLOCKS_IN_OMP_LOOPS", True, ""),
    ("LARGE_FILE_SUPPORT", True, ""),
    ("MIN_Z_DIAG_INTERVAL", None, ""),
]


def check_obsolete_params(pf, skip=()) -> None:
    """Flag every obsolete parameter that the configuration sets, but
    the entries of the table named in ``skip``."""
    for name, safe, hint in _OBSOLETE:
        if name in skip or not pf.has(name):
            continue
        val = pf.get(name, type(safe) if safe is not None else str,
                     safe if safe is not None else "",
                     desc="OBSOLETE parameter")
        suffix = f" {hint}" if hint else ""
        if safe is None:
            MOM_error(FATAL, f"{name} is an obsolete parameter.{suffix}")
        elif val != safe:
            MOM_error(FATAL, f"{name} is obsolete and can only take the "
                      f"value {safe!r}.{suffix}")
        else:
            MOM_error(WARNING, f"{name} is obsolete (harmless at "
                      f"{safe!r}); remove it.{suffix}")
