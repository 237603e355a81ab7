"""DEBUG_NANS: stop at the first step whose outputs hold a NaN, and name
the operation that made it.

The counterpart of the JAX driver's ``jax_debug_nans``, which checks the
outputs of each compiled step and, only when one holds a NaN, runs the
step again operation by operation to find the first that made one.  So
here: ``has_nan`` checks a step's outputs with one read from the device,
and the driver runs a step that failed it again under ``NanCheck``,
which checks every aten operation's floating outputs and raises at the
first NaN, naming the operation and the step.  A NaN that a step makes
and masks away (a 0/0 that a ``torch.where`` replaces) stops nothing.
Hand-written kernels launched through their own bindings are not aten
operations: a NaN they make is named at the next aten operation that
reads it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["NanCheck", "has_nan"]


def _tensors(tree):
    """The tensors of a tree of tensors, dataclasses, dicts, lists and
    tuples (None and other leaves are skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def has_nan(*trees) -> bool:
    """Whether a floating tensor of ``trees`` holds a NaN (one read from
    the device)."""
    flags = [torch.isnan(t).any() for t in _tensors(trees)
             if t.is_floating_point() and t.numel()]
    return bool(torch.stack(flags).any()) if flags else False


class NanCheck(TorchDispatchMode):
    """Raise on the first aten operation with a NaN in a floating output;
    ``step`` labels the message."""

    def __init__(self, step=None):
        super().__init__()
        self.step = step

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel() and bool(torch.isnan(t).any()):
                where = "" if self.step is None else f" in step {self.step}"
                raise FloatingPointError(
                    f"DEBUG_NANS: {func} made a NaN{where} "
                    f"(output shape {tuple(t.shape)})")
        return out
