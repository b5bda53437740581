"""Declarative option system (a copy of `ctdirect_tpu.utils.options`; pure
Python): OptionDef(name, type, default, aliases, description) + strict vs
permissive build modes."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


class OptionError(ValueError):
    pass


@dataclass(frozen=True)
class OptionDef:
    name: str
    type: type
    default: Any
    aliases: Tuple[str, ...] = ()
    description: str = ""
    validate: Optional[Callable[[Any], bool]] = None

    def coerce(self, value):
        if value is None:
            return value
        if self.type is float and isinstance(value, int):
            value = float(value)
        if not isinstance(value, self.type):
            try:
                value = self.type(value)
            except Exception:
                raise OptionError(
                    f"option {self.name!r} expects {self.type.__name__}, "
                    f"got {type(value).__name__} ({value!r})"
                )
        if self.validate is not None and not self.validate(value):
            raise OptionError(f"invalid value for option {self.name!r}: {value!r}")
        return value


class OptionSet:
    """A set of option definitions with alias resolution and strict/permissive
    merge (strict: unknown keys raise; permissive: they pass through)."""

    def __init__(self, defs: Sequence[OptionDef]):
        self.defs = {d.name: d for d in defs}
        self._alias = {}
        for d in defs:
            for a in (d.name, *d.aliases):
                if a in self._alias:
                    raise ValueError(f"duplicate option name/alias {a!r}")
                self._alias[a] = d.name

    def metadata(self) -> Dict[str, OptionDef]:
        return dict(self.defs)

    def build(self, kwargs: Dict[str, Any], mode: str = "strict") -> Dict[str, Any]:
        """Resolve aliases, validate, and fill defaults. Returns
        (resolved options + any passthrough keys when permissive)."""
        if mode not in ("strict", "permissive"):
            raise OptionError(f"unknown mode {mode!r}")
        out = {name: d.default for name, d in self.defs.items()}
        extra = {}
        for key, val in kwargs.items():
            if key in self._alias:
                name = self._alias[key]
                out[name] = self.defs[name].coerce(val)
            elif mode == "permissive":
                extra[key] = val
            else:
                known = sorted(self._alias)
                raise OptionError(
                    f"unknown option {key!r} (strict mode); known: {known}"
                )
        out.update(extra)
        return out

    def describe(self) -> str:
        lines = []
        for d in self.defs.values():
            al = f" (aliases: {', '.join(d.aliases)})" if d.aliases else ""
            lines.append(
                f"  {d.name}: {d.type.__name__} = {d.default!r}{al} — {d.description}"
            )
        return "\n".join(lines)
