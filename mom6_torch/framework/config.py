"""Runtime parameter system reading the MOM_input dialect (a copy of
``mom6_tpu.framework.config``, which imports nothing of JAX; the port
keeps its own).

A host-side typed parameter registry that reads unmodified
``MOM_input``/``MOM_override`` files:

* ``KEY = value`` assignments (value may contain spaces for lists),
* ``!`` line comments and ``/* ... */`` block comments,
* ``#override KEY = value`` lines, which take precedence over plain
  assignments (duplicate plain assignments of the same key with
  different values are an error),
* booleans ``True``/``False``, Fortran-style floats (``8.64E+04``),
  quoted strings, and comma-separated lists.

Every ``get`` self-documents (name, type, units, default, description)
into a registry from which ``MOM_parameter_doc.all`` and ``.short`` are
written, and reading is audited: ``unused()`` lists the parameters that
the input sets and nothing read.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
from typing import Any, Sequence

__all__ = ["ParamFile", "param_doc_text"]


_OVERRIDE_RE = re.compile(r"^#override\s+(.*)$", re.IGNORECASE)
_ASSIGN_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_%]*)\s*=\s*(.*)$")


def _strip_block_comments(text: str) -> str:
    """Remove C-style /* ... */ block comments (may span lines)."""
    return re.sub(r"/\*.*?\*/", " ", text, flags=re.DOTALL)


def _strip_line_comment(line: str) -> str:
    """Remove trailing '!' comment, respecting double-quoted strings."""
    out = []
    in_str = False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        if ch == "!" and not in_str:
            break
        out.append(ch)
    return "".join(out)


def _parse_text(text: str):
    """Yield (key, raw_value, is_override) from MOM_input-dialect text."""
    text = _strip_block_comments(text)
    for raw in text.splitlines():
        line = _strip_line_comment(raw).strip()
        if not line:
            continue
        override = False
        m = _OVERRIDE_RE.match(line)
        if m:
            override = True
            line = m.group(1).strip()
        m = _ASSIGN_RE.match(line)
        if m:
            yield m.group(1).upper(), m.group(2).strip(), override


def _coerce(raw: str, ptype: type, name: str) -> Any:
    """Convert a raw string value to the requested python type."""
    raw = raw.strip()
    if ptype is bool:
        low = raw.lower().rstrip(".").lstrip(".")
        if low in ("true", "t"):
            return True
        if low in ("false", "f"):
            return False
        raise ValueError(f"Parameter {name}: cannot parse '{raw}' as Boolean")
    if ptype is int:
        return int(float(raw))  # tolerate "4." and "1E2"
    if ptype is float:
        # Fortran doubles may be written 1.0d0
        return float(raw.lower().replace("d", "e"))
    if ptype is str:
        if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
            return raw[1:-1]
        return raw
    if ptype is list:
        parts = [p.strip() for p in raw.split(",") if p.strip()]
        return [float(p.lower().replace("d", "e")) for p in parts]
    raise TypeError(f"Unsupported parameter type {ptype} for {name}")


@dataclasses.dataclass
class _DocEntry:
    name: str
    ptype: str
    value: Any
    default: Any
    units: str
    desc: str
    module: str
    layout: bool = False
    debugging: bool = False

    @property
    def non_default(self) -> bool:
        return self.default is None or self.value != self.default


class ParamFile:
    """Parsed run-time parameters plus the get_param/doc registry.

    Construct from one or more files (``MOM_input`` then ``MOM_override``)
    or from a raw string / dict for tests.
    """

    def __init__(self, *sources: str, text: str | None = None,
                 overrides: dict[str, Any] | None = None):
        self._plain: dict[str, str] = {}
        self._over: dict[str, str] = {}
        self._used: set[str] = set()
        self._doc: dict[str, _DocEntry] = {}
        self._module = "?"
        self._closed = False
        # case (run) directory: where MOM_input lives; used to find
        # sibling tables (data_table, diag_table)
        self.case_dir = os.path.dirname(sources[0]) if sources else "."
        for path in sources:
            with open(path) as f:
                self._ingest(f.read(), label=os.path.basename(path))
        if text is not None:
            self._ingest(text, label="<text>")
        if overrides:
            for k, v in overrides.items():
                self._over[k.upper()] = _to_raw(v)

    # -- ingestion -----------------------------------------------------
    def _ingest(self, text: str, label: str):
        for key, raw, is_override in _parse_text(text):
            if is_override:
                self._over[key] = raw
            else:
                if key in self._plain and self._plain[key] != raw:
                    raise ValueError(
                        f"Parameter {key} set twice with different values in "
                        f"{label}; use #override to supersede an earlier value.")
                self._plain[key] = raw

    # -- reading -------------------------------------------------------
    def module(self, name: str):
        """Set the current module name used for doc grouping."""
        self._module = name
        return self

    def has(self, name: str) -> bool:
        name = name.upper()
        return name in self._over or name in self._plain

    def raw(self, name: str) -> str | None:
        name = name.upper()
        if name in self._over:
            return self._over[name]
        return self._plain.get(name)

    def get(self, name: str, ptype: type = float, default: Any = None, *,
            units: str = "", desc: str = "", module: str | None = None,
            layout: bool = False, debugging: bool = False) -> Any:
        """Typed parameter read with self-documentation (get_param)."""
        key = name.upper()
        raw = self.raw(key)
        if raw is None:
            value = default
        else:
            value = _coerce(raw, ptype, key)
            self._used.add(key)
        self._doc[key] = _DocEntry(
            name=key, ptype=ptype.__name__, value=value, default=default,
            units=units, desc=desc, module=module or self._module,
            layout=layout, debugging=debugging)
        return value

    # -- auditing / docs ----------------------------------------------
    def unused(self) -> list[str]:
        present = set(self._plain) | set(self._over)
        return sorted(present - self._used)

    def close(self, fatal_unused: bool = True):
        """Audit for unused (misspelled) parameters, as the reference
        does at close_param_file (MOM_file_parser.F90:260)."""
        self._closed = True
        bad = self.unused()
        if bad and fatal_unused:
            raise ValueError(
                "Unused (possibly misspelled) parameters in input files: "
                + ", ".join(bad))
        return bad

    def doc_entries(self) -> list[_DocEntry]:
        return list(self._doc.values())

    def write_docs(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "MOM_parameter_doc.all"), "w") as f:
            f.write(param_doc_text(self, short=False))
        with open(os.path.join(directory, "MOM_parameter_doc.short"), "w") as f:
            f.write(param_doc_text(self, short=True))


def _to_raw(v: Any) -> str:
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, (list, tuple)):
        return ", ".join(repr(float(x)) for x in v)
    return str(v)


def _fmt_val(v: Any) -> str:
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, float):
        return f"{v:G}"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return ", ".join(_fmt_val(float(x)) for x in v)
    return str(v)


def param_doc_text(pf: ParamFile, short: bool = False) -> str:
    """Render the MOM_parameter_doc format (MOM_document.F90)."""
    buf = io.StringIO()
    last_module = None
    for e in pf.doc_entries():
        if short and not e.non_default:
            continue
        if e.module != last_module:
            buf.write(f"\n! === module {e.module} ===\n")
            last_module = e.module
        unit = f"   [{e.units}]" if e.units else ""
        dflt = f" default = {_fmt_val(e.default)}" if e.default is not None else ""
        buf.write(f"{e.name} = {_fmt_val(e.value)}{unit}{dflt}\n")
        for line in (e.desc or "").splitlines():
            buf.write(f"                                ! {line.strip()}\n")
    return buf.getvalue()
