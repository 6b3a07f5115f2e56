"""Declared backend-options schemas: one validation path for every backend.

Counterpart of :mod:`repro.pipeline.options`.  Every registered backend
declares its options -- name, kind, default, help, optional choices and a
value check -- next to its registry entry
(:func:`repro_torch.pipeline.backend.register_backend` takes the schema).
Unknown names and ill-typed values fail with one uniform, friendly
:class:`ValueError` on every backend at session construction, never as a
shape crash or a silent ignore mid-profile.  The same declaration types
``profile_run --backend-option KEY=VALUE`` strings (:meth:`parse_cli`)
and lists each backend's options (``--list-backends``, :meth:`describe`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

#: kind -> (accepted python types, human label).  ``bool`` is checked
#: before ``int``/``number`` everywhere because bool subclasses int.
_KINDS: dict[str, tuple[tuple[type, ...], str]] = {
    "int": ((int,), "an integer"),
    "number": ((int, float), "a number"),
    "bool": ((bool,), "a bool"),
    "str": ((str,), "a string"),
}


@dataclasses.dataclass(frozen=True)
class Option:
    """One declared backend option.

    Attributes:
      name: the ``backend_options`` key.
      kind: value kind -- ``"int"`` / ``"number"`` / ``"bool"`` / ``"str"``.
      default: the value used when the option is absent (documentation;
        the backend owns the real default).
      help: one-line description.
      choices: optional closed set of allowed values.
      check: optional ``value -> error text | None`` refinement (range,
        divisibility, ...) run after the kind/choices checks pass.
    """

    name: str
    kind: str
    default: object = None
    help: str = ""
    choices: tuple | None = None
    check: Callable[[object], str | None] | None = None

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"option {self.name!r}: unknown kind "
                             f"{self.kind!r}; one of {sorted(_KINDS)}")

    def describe(self) -> str:
        """``name=kind (default ...)  help`` row for ``--list-backends``."""
        spec = self.kind
        if self.choices is not None:
            spec = "|".join(str(c) for c in self.choices)
        return f"{self.name}={spec} (default {self.default!r})" + (
            f"  {self.help}" if self.help else "")


class OptionError(ValueError):
    """An unknown or ill-typed backend option (uniform across backends)."""


@dataclasses.dataclass(frozen=True)
class OptionsSchema:
    """The declared option set of one registered backend.

    ``validate`` applies the one uniform error contract:

    * unknown name  -> ``<backend> got unknown option 'x'; valid options:
      a, b, c`` (or ``takes no options`` for option-less backends);
    * wrong type    -> ``<backend> option 'x' must be an integer, got ...``;
    * bad choice    -> ``<backend> option 'x' must be one of ...``;
    * failed check  -> ``<backend> option 'x' <check's message>``.
    """

    backend: str
    options: tuple[Option, ...] = ()
    #: unknown options are forwarded to a wrapped backend's schema instead
    #: of failing here (the ``sharded`` wrapper).
    passthrough: bool = False

    def __post_init__(self) -> None:
        names = [o.name for o in self.options]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate option names in schema for "
                             f"{self.backend!r}: {names}")

    def option(self, name: str) -> Option | None:
        for o in self.options:
            if o.name == name:
                return o
        return None

    def unknown_error(self, name: str) -> OptionError:
        if not self.options:
            return OptionError(
                f"{self.backend} got unknown option {name!r}; "
                f"{self.backend} takes no options")
        return OptionError(
            f"{self.backend} got unknown option {name!r}; valid options: "
            f"{', '.join(sorted(o.name for o in self.options))}")

    def check_value(self, opt: Option, value: object) -> None:
        """Kind + choices + refinement check for one provided value."""
        types, label = _KINDS[opt.kind]
        if isinstance(value, bool) and opt.kind != "bool":
            raise OptionError(f"{self.backend} option {opt.name!r} must be "
                              f"{label}, got {value!r}")
        if not isinstance(value, types):
            raise OptionError(f"{self.backend} option {opt.name!r} must be "
                              f"{label}, got {value!r}")
        if opt.choices is not None and value not in opt.choices:
            raise OptionError(
                f"{self.backend} option {opt.name!r} must be one of "
                f"{list(opt.choices)}, got {value!r}")
        if opt.check is not None:
            msg = opt.check(value)
            if msg:
                raise OptionError(
                    f"{self.backend} option {opt.name!r} {msg}, "
                    f"got {value!r}")

    def validate(self, options: Mapping[str, object]) -> dict[str, object]:
        """Check every provided option; returns the ones this schema
        declares (with ``passthrough``, the rest are :meth:`split` off for
        the wrapped backend)."""
        return self.split(options)[0]

    def split(self, options: Mapping[str, object]
              ) -> tuple[dict[str, object], dict[str, object]]:
        """Split provided options into ``(own, rest)`` after checking.

        ``own`` holds the validated options this schema declares; ``rest``
        holds the remainder -- empty unless ``passthrough`` (a non-empty
        remainder without passthrough raises the uniform unknown error).
        """
        own: dict[str, object] = {}
        rest: dict[str, object] = {}
        for name, value in dict(options).items():
            opt = self.option(name)
            if opt is None:
                if self.passthrough:
                    rest[name] = value
                    continue
                raise self.unknown_error(name)
            self.check_value(opt, value)
            own[name] = value
        return own, rest

    def parse_cli(self, name: str, raw: str) -> object:
        """Coerce a ``--backend-option`` raw string by the declared kind."""
        opt = self.option(name)
        if opt is None:
            raise self.unknown_error(name)
        value = coerce(raw, opt.kind)
        if value is None:
            _, label = _KINDS[opt.kind]
            raise OptionError(f"{self.backend} option {name!r} must be "
                              f"{label}, got {raw!r}")
        self.check_value(opt, value)
        return value

    def describe(self) -> list[str]:
        """One row per option (empty for option-less backends)."""
        return [o.describe() for o in self.options]


def coerce(raw: str, kind: str) -> object | None:
    """Parse a CLI string as ``kind``; None when it doesn't parse."""
    if kind == "str":
        return raw
    if kind == "bool":
        low = raw.lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
        return None
    try:
        as_int = int(raw)
    except ValueError:
        as_int = None
    if kind == "int":
        return as_int
    # number: prefer the int reading (keeps e.g. seed=3 an int), fall
    # back to float
    if as_int is not None:
        return as_int
    try:
        return float(raw)
    except ValueError:
        return None


# -- common refinement checks (shared across backend declarations) ---------

def positive(v) -> str | None:
    return None if v > 0 else "must be > 0"


def non_negative(v) -> str | None:
    return None if v >= 0 else "must be >= 0"


def unit_interval(v) -> str | None:
    return None if 0.0 <= v <= 1.0 else "must be in [0, 1]"
