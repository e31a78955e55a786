"""Algorithm metadata, option declarations and runtime environments.

Mirrors the semantics of tudocomp's Meta / Env / OptionValue
(include/tudocomp/Meta.hpp:34-332, include/tudocomp/Env.hpp,
include/tudocomp/OptionValue.hpp): every pluggable unit declares a Meta with
its type ("compressor", "coder", ...), id name, docs and options. Options are
either *templated* (select a sub-algorithm of a given type; part of the
static signature) or *dynamic* (runtime values). The evaluated option tree is
carried by an Env handed down to sub-algorithms. The port's copy of
tudocomp_tpu/meta.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .io.restrict import InputRestrictions


@dataclass
class OptionDecl:
    name: str
    kind: str = "dynamic"  # "templated" | "dynamic" | "dynamic_compressor"
    algo_type: Optional[str] = None  # for templated: the sub-algorithm type
    default: Optional[str] = None  # default id-string or stringified value


class _OptionBuilder:
    def __init__(self, meta: "Meta", name: str):
        self._meta = meta
        self._name = name

    def templated(self, algo_type: str, default: Optional[str] = None) -> None:
        """Declare a sub-algorithm option (Meta.hpp:104-160)."""
        self._meta.options[self._name] = OptionDecl(
            self._name, "templated", algo_type, default
        )

    def dynamic(self, default: Any = None) -> None:
        """Declare a runtime-value option (Meta.hpp:162-199)."""
        if isinstance(default, bool):
            default = "true" if default else "false"
        elif default is not None:
            default = str(default)
        self._meta.options[self._name] = OptionDecl(self._name, "dynamic", None, default)

    def dynamic_compressor(self) -> None:
        """Declare a runtime-dispatched compressor option (Meta.hpp:201-211)."""
        self._meta.options[self._name] = OptionDecl(
            self._name, "dynamic_compressor", "compressor", None
        )


class Meta:
    """Per-algorithm metadata (Meta.hpp:34)."""

    def __init__(self, algo_type: str, name: str, doc: str = ""):
        self.type = algo_type
        self.name = name
        self.doc = doc
        self.options: dict[str, OptionDecl] = {}
        self.input_restrictions = InputRestrictions()

    def option(self, name: str) -> _OptionBuilder:
        return _OptionBuilder(self, name)

    def needs_sentinel_terminator(self) -> None:
        """Require a 0 sentinel appended to the input (Meta.hpp:262-273)."""
        self.input_restrictions = self.input_restrictions | InputRestrictions(
            (0,), True
        )

    def set_input_restrictions(self, rest: InputRestrictions) -> None:
        self.input_restrictions = self.input_restrictions | rest


@dataclass
class AlgorithmValue:
    """An evaluated algorithm selection: name + evaluated options.

    Mirror of OptionValue.hpp:35 AlgorithmValue; `options` values are either
    strings (dynamic) or AlgorithmValue (sub-algorithms).
    """

    name: str
    options: dict[str, Any] = field(default_factory=dict)
    # algo type ("compressor", "coder", "d_coding", ...); disambiguates
    # same-named algorithms of different types during sub-instantiation
    type: Optional[str] = None

    def id_string(self) -> str:
        if not self.options:
            return self.name
        parts = []
        for k, v in self.options.items():
            parts.append(f"{k}={v.id_string() if isinstance(v, AlgorithmValue) else v}")
        return f"{self.name}({', '.join(parts)})"


class OptionValue:
    """Typed view of one evaluated option (OptionValue.hpp)."""

    def __init__(self, value: Any):
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def as_string(self) -> str:
        if isinstance(self._value, AlgorithmValue):
            return self._value.name
        return str(self._value)

    def as_integer(self) -> int:
        return int(self.as_string())

    def as_bool(self) -> bool:
        s = self.as_string()
        if s == "true" or s == "1":
            return True
        if s == "false" or s == "0":
            return False
        raise ValueError(f"not a bool: {s!r}")

    def as_algorithm(self) -> AlgorithmValue:
        assert isinstance(self._value, AlgorithmValue), self._value
        return self._value


class Env:
    """Runtime option context passed down the sub-algorithm tree (Env.hpp)."""

    def __init__(self, registry, av: AlgorithmValue):
        self.registry = registry
        self.av = av

    def option(self, name: str) -> OptionValue:
        return OptionValue(self.av.options[name])

    def has_option(self, name: str) -> bool:
        return name in self.av.options

    def env_for_option(self, name: str) -> "Env":
        return Env(self.registry, self.option(name).as_algorithm())

    def algorithm_for_option(self, name: str):
        """Resolve a templated option to (class, sub_env)."""
        sub_av = self.option(name).as_algorithm()
        if sub_av.type is not None:
            cls = self.registry.get_class(sub_av.type, sub_av.name)
        else:
            # legacy path: search all types (unique names assumed)
            cls = self.registry.find_class(sub_av.name)
        return cls, Env(self.registry, sub_av)

    def instantiate(self, name: str):
        """Instantiate the sub-algorithm selected by a templated option."""
        cls, env = self.algorithm_for_option(name)
        return cls(env)


class Algorithm:
    """Base for every pluggable unit (include/tudocomp/Algorithm.hpp:15)."""

    def __init__(self, env: Env):
        self._env = env

    @property
    def env(self) -> Env:
        return self._env

    @classmethod
    def meta(cls) -> Meta:  # pragma: no cover - abstract
        raise NotImplementedError
