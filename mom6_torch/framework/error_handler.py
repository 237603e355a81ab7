"""Error / message channel (after ``mom6_tpu.framework.error_handler``,
which imports nothing of JAX; the port keeps its own copy, without the
callTree trail that nothing of the port enters).

``MOM_error(FATAL|WARNING|NOTE, msg)`` is routed through one channel
with a registered log sink and ``MOM_mesg`` filters by verbosity.
FATAL raises ``FatalError`` after logging, so drivers and tests can
intercept it.
"""

from __future__ import annotations

import sys

__all__ = ["FATAL", "WARNING", "NOTE", "FatalError", "MOM_error",
           "MOM_mesg", "set_verbosity", "set_log_file"]

FATAL, WARNING, NOTE = 0, 1, 2
_LABEL = {FATAL: "FATAL", WARNING: "WARNING", NOTE: "NOTE"}


class FatalError(RuntimeError):
    """Raised by MOM_error(FATAL, ...) — the MOM6 abort path."""


_state = {"verbosity": 2, "log": None}


def set_verbosity(level: int):
    """0 = errors only, 1 = +warnings, 2 = +notes, 3+ = +debug mesg."""
    _state["verbosity"] = int(level)


def set_log_file(fileobj):
    """Additionally write every message to this open file object."""
    _state["log"] = fileobj


def _emit(line: str):
    print(line, file=sys.stderr)
    if _state["log"] is not None:
        _state["log"].write(line + "\n")
        _state["log"].flush()


def MOM_error(level: int, message: str):
    if level == FATAL or level <= _state["verbosity"]:
        _emit(f"{_LABEL.get(level, 'NOTE')}: {message}")
    if level == FATAL:
        raise FatalError(message)


def MOM_mesg(message: str, verbosity: int = 2):
    if verbosity <= _state["verbosity"]:
        _emit(message)

