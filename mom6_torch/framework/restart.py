"""Checkpoint/restart of the model state.

Counterpart of ``mom6_tpu.framework.restart`` with the same files: a
``<path>.npz`` holding one array per leaf under ``<tree>__NNNN`` keys,
and a ``<path>.json`` manifest with each tree's keys and its metadata
(step, model time, truncation count).  A restarted run continues bit
for bit.

The leaves of a tree come in the JAX package's order, so that a
restart written by either package restores in the other: a ``State``,
``SplitDynState`` or ``SplitBDynState`` in the JAX package's field
order (``_FIELDS``) with the None fields skipped, a dict in sorted key
order (tracers, or the nested dicts of the open-boundary tracer
reservoirs, name then edge), a single tensor as one leaf, and None (an
unsplit model's split state) as no leaf.  The solo driver saves the
step's carries as single-tensor trees under the JAX driver's names
(``carry_u``, ``carry_mld``, ..., the stochastic pattern as
``carry_sppt``, or ``carry_sppt_p`` and ``carry_sppt_k`` with SKEB).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["save_restart", "restore_restart", "query_restart"]

# the JAX package's field order of its State and SplitDynState pytrees;
# fields the port's containers lack are None
_FIELDS = {
    "State": ("u", "v", "h", "T", "S", "meke", "frazil"),
    "SplitDynState": ("u_av", "v_av", "h_av", "uh", "vh", "eta", "diffu",
                      "diffv"),
    "SplitBDynState": ("du_av_inst", "dv_av_inst", "eta"),
}


def _flatten(tree) -> tuple[list[torch.Tensor], str]:
    """The tree's leaves and a description of its structure."""
    if tree is None:
        return [], "PyTreeDef(None)"
    if isinstance(tree, torch.Tensor):
        return [tree], "PyTreeDef(*)"
    if isinstance(tree, dict):
        leaves, descs = [], []
        for k in sorted(tree):
            sub, d = _flatten(tree[k])
            leaves += sub
            descs.append(f"'{k}': " + d[len("PyTreeDef("):-1])
        return leaves, "PyTreeDef({" + ", ".join(descs) + "})"
    if dataclasses.is_dataclass(tree):
        name = type(tree).__name__
        vals = [getattr(tree, f, None) for f in _FIELDS[name]]
        slots = ", ".join("*" if v is not None else "None" for v in vals)
        return ([v for v in vals if v is not None],
                f"PyTreeDef(CustomNode({name}[()], [{slots}]))")
    raise TypeError(f"no restart layout for {type(tree).__name__}")


def _unflatten(template, leaves: list[torch.Tensor]):
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return leaves[0]
    if isinstance(template, dict):
        out, at = {}, 0
        for k in sorted(template):
            n = len(_flatten(template[k])[0])
            out[k] = _unflatten(template[k], leaves[at:at + n])
            at += n
        return out
    it = iter(leaves)
    kw = {f: next(it) for f in _FIELDS[type(template).__name__]
          if getattr(template, f, None) is not None}
    return dataclasses.replace(template, **kw)


def save_restart(path: str, trees: dict[str, Any],
                 meta: dict[str, Any] | None = None) -> None:
    """Save named trees and metadata; ``path`` without extension."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, Any] = {"trees": {}}
    for name, tree in trees.items():
        leaves, treedef = _flatten(tree)
        keys = []
        for i, leaf in enumerate(leaves):
            key = f"{name}__{i:04d}"
            arrays[key] = leaf.detach().cpu().numpy()
            keys.append(key)
        manifest["trees"][name] = {"keys": keys, "treedef": treedef}
    manifest["meta"] = meta or {}
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1, default=str)


def restore_restart(path: str, templates: dict[str, Any]
                    ) -> tuple[dict[str, Any], dict[str, Any]]:
    """Restore trees shaped like ``templates``; each leaf takes the
    device and dtype of the template's leaf it replaces.  Returns
    (trees, meta).  Raises if a template's leaf count differs from what
    was saved."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    data = np.load(path + ".npz")
    out: dict[str, Any] = {}
    for name, template in templates.items():
        if name not in manifest["trees"]:
            raise KeyError(f"restart file has no tree '{name}'")
        keys = manifest["trees"][name]["keys"]
        leaves, _ = _flatten(template)
        if len(leaves) != len(keys):
            raise ValueError(
                f"tree '{name}': template has {len(leaves)} leaves but "
                f"restart stores {len(keys)} — schema mismatch")
        new = [torch.as_tensor(data[k], dtype=t.dtype, device=t.device)
               for k, t in zip(keys, leaves)]
        out[name] = _unflatten(template, new)
    return out, manifest["meta"]


def query_restart(path: str) -> bool:
    return os.path.exists(path + ".npz") and os.path.exists(path + ".json")
