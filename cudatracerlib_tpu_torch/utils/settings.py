"""Typed, constrained parameter collections.

Port of cudatracerlib_tpu/utils/settings.py (plain Python, a copy); the port keeps its
own so that it imports nothing of the JAX package.

Counterpart of reference ``Kernel/TracerSettings.h`` (interval/set-constrained
typed parameters :29-79, enum parameters with string round-trip :136-172,
hierarchical collections :221, CLI overrides via TracerArguments :352-383).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Generic, Optional, Sequence, TypeVar

T = TypeVar("T")


class Parameter(Generic[T]):
    """A typed parameter with an optional constraint (interval or value set)."""

    def __init__(self, name: str, value: T,
                 interval: Optional[tuple] = None,
                 choices: Optional[Sequence] = None,
                 enum: Optional[Dict[str, Any]] = None):
        self.name = name
        self.interval = interval
        self.choices = list(choices) if choices is not None else None
        self.enum = dict(enum) if enum else None
        self._value = None
        self.set(value)

    def _check(self, v):
        if self.interval is not None:
            lo, hi = self.interval
            if not (lo <= v <= hi):
                raise ValueError(f"{self.name}={v!r} outside [{lo}, {hi}]")
        if self.choices is not None and v not in self.choices:
            raise ValueError(f"{self.name}={v!r} not in {self.choices}")

    def set(self, v):
        if self.enum is not None and isinstance(v, str):
            if v not in self.enum:
                raise ValueError(f"{self.name}: unknown enum value {v!r}; "
                                 f"options: {sorted(self.enum)}")
            v = self.enum[v]
        self._check(v)
        self._value = v

    def get(self) -> T:
        return self._value

    def as_string(self) -> str:
        if self.enum is not None:
            for k, v in self.enum.items():
                if v == self._value:
                    return k
        return str(self._value)

    def __repr__(self):
        return f"Parameter({self.name}={self.as_string()})"


class ParameterCollection:
    """Hierarchical named parameter collection with dotted-path access and
    CLI-style overrides ("a.b.c=value", TracerSettings.h:352-383)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._params: Dict[str, Parameter] = {}
        self._children: Dict[str, "ParameterCollection"] = {}

    def add(self, param: Parameter) -> Parameter:
        self._params[param.name] = param
        return param

    def add_child(self, child: "ParameterCollection") -> "ParameterCollection":
        self._children[child.name] = child
        return child

    def __getitem__(self, path: str):
        head, _, rest = path.partition(".")
        if rest:
            return self._children[head][rest]
        if head in self._params:
            return self._params[head].get()
        return self._children[head]

    def set(self, path: str, value):
        head, _, rest = path.partition(".")
        if rest:
            self._children[head].set(rest, value)
        else:
            self._params[head].set(value)

    def apply_overrides(self, args: Sequence[str]):
        """Apply "path=value" overrides, parsing numbers/bools."""
        for a in args:
            if "=" not in a:
                raise ValueError(f"override {a!r} is not of the form path=value")
            path, _, raw = a.partition("=")
            v: Any = raw
            for cast in (int, float):
                try:
                    v = cast(raw)
                    break
                except ValueError:
                    continue
            if raw.lower() in ("true", "false"):
                v = raw.lower() == "true"
            self.set(path.strip(), v)

    def to_dict(self) -> dict:
        out: dict = {k: p.get() for k, p in self._params.items()}
        for k, c in self._children.items():
            out[k] = c.to_dict()
        return out

    def __repr__(self):
        return f"ParameterCollection({self.to_dict()})"
