"""Strict JSON <-> dataclass codec for model configs.

Mirrors the reference's config discipline (uzu `#[uzu_config]` /
`#[uzu_config_abstract]`, reference: crates/proc-macros/src/uzu_config.rs):

- every concrete config node is a dataclass; polymorphic ("abstract") families
  are tagged unions dispatched on a ``"type"`` field whose value is the
  concrete config's class name (e.g. ``"AttentionConfig"``, ``"IntSpec"``);
- unknown JSON fields are an error (``deny_unknown_fields``);
- required (non-Optional) fields must be present;
- enums serialize as snake_case strings.

This module is pure Python (no jax import) so configs load anywhere.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import types
import typing
from typing import Any, Optional, Type, TypeVar, Union

T = TypeVar("T")

# Registry: family name -> {tag -> concrete class}
_FAMILIES: dict[str, dict[str, type]] = {}


class ConfigError(ValueError):
    """Raised on malformed / non-strict config JSON."""

    def __init__(self, msg: str, path: str = ""):
        super().__init__(f"{path or '<root>'}: {msg}")
        self.path = path


def config(cls: Type[T]) -> Type[T]:
    """Decorator: mark a dataclass as a config node (strict serde)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.__uzu_config__ = True  # type: ignore[attr-defined]
    return cls


def config_member(family: str, tag: str | None = None):
    """Decorator: register a concrete config in a polymorphic family.

    The JSON representation carries ``"type": <tag>`` (tag defaults to the
    class name, matching uzu's MustBe!(StructIdent) convention).
    """

    def wrap(cls: Type[T]) -> Type[T]:
        cls = config(cls)
        t = tag or cls.__name__
        _FAMILIES.setdefault(family, {})[t] = cls
        cls.__uzu_family__ = family  # type: ignore[attr-defined]
        cls.__uzu_tag__ = t  # type: ignore[attr-defined]
        return cls

    return wrap


class Family:
    """Sentinel generic for polymorphic fields: ``Family["TokenMixerConfig"]``.

    At parse time the JSON object's "type" tag selects the concrete class
    registered under the family name.
    """

    def __class_getitem__(cls, family: str):
        return typing.Annotated[object, ("uzu_family", family)]


def _family_of(tp: Any) -> str | None:
    if typing.get_origin(tp) is typing.Annotated:
        for meta in typing.get_args(tp)[1:]:
            if isinstance(meta, tuple) and len(meta) == 2 and meta[0] == "uzu_family":
                return meta[1]
    return None


def _is_optional(tp: Any) -> tuple[bool, Any]:
    origin = typing.get_origin(tp)
    if origin is Union or origin is types.UnionType:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1 and type(None) in typing.get_args(tp):
            return True, args[0]
    return False, tp


def parse(tp: Any, value: Any, path: str = "") -> Any:
    """Parse a JSON value into type ``tp`` strictly."""
    optional, tp = _is_optional(tp)
    if value is None:
        if optional:
            return None
        raise ConfigError(f"null not allowed for {tp}", path)

    family = _family_of(tp)
    if family is not None:
        return _parse_family(family, value, path)

    origin = typing.get_origin(tp)
    if origin in (tuple, list):
        args = typing.get_args(tp)
        if not isinstance(value, list):
            raise ConfigError(f"expected list, got {type(value).__name__}", path)
        if origin is tuple and not (len(args) == 2 and args[1] is Ellipsis):
            # fixed-arity tuple, e.g. clipping pairs
            if len(value) != len(args):
                raise ConfigError(f"expected {len(args)} items, got {len(value)}", path)
            return tuple(parse(a, v, f"{path}[{i}]") for i, (a, v) in enumerate(zip(args, value)))
        elem = args[0] if args else Any
        return tuple(parse(elem, v, f"{path}[{i}]") for i, v in enumerate(value))

    if origin is dict:
        kt, vt = typing.get_args(tp) or (str, Any)
        if not isinstance(value, dict):
            raise ConfigError(f"expected object, got {type(value).__name__}", path)
        return {k: parse(vt, v, f"{path}.{k}") for k, v in value.items()}

    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        try:
            return tp(value)
        except ValueError:
            raise ConfigError(f"invalid enum value {value!r} for {tp.__name__}", path) from None

    if isinstance(tp, type) and getattr(tp, "__uzu_config__", False):
        return _parse_struct(tp, value, path)

    if tp is bool:
        if not isinstance(value, bool):
            raise ConfigError(f"expected bool, got {type(value).__name__}", path)
        return value
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"expected int, got {type(value).__name__}", path)
        return value
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f"expected number, got {type(value).__name__}", path)
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            raise ConfigError(f"expected string, got {type(value).__name__}", path)
        return value
    if tp is Any or tp is object:
        return value

    raise ConfigError(f"unsupported config type {tp!r}", path)


def _parse_family(family: str, value: Any, path: str) -> Any:
    members = _FAMILIES.get(family)
    if not members:
        raise ConfigError(f"unknown config family {family!r}", path)
    if not isinstance(value, dict):
        raise ConfigError(f"expected tagged object for {family}", path)
    tag = value.get("type")
    if tag is None:
        raise ConfigError(f"missing \"type\" tag for {family}", path)
    cls = members.get(tag)
    if cls is None:
        raise ConfigError(
            f"unknown {family} variant {tag!r} (known: {sorted(members)})", path
        )
    return _parse_struct(cls, value, path, skip={"type"})


def _parse_struct(cls: type, value: Any, path: str, skip: frozenset | set = frozenset()) -> Any:
    if not isinstance(value, dict):
        raise ConfigError(f"expected object for {cls.__name__}, got {type(value).__name__}", path)
    hints = typing.get_type_hints(cls, include_extras=True)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    tag = getattr(cls, "__uzu_tag__", None)
    if tag is not None and "type" in value:
        if value["type"] != tag:
            raise ConfigError(f"type tag {value['type']!r} != {tag!r}", path)
        skip = set(skip) | {"type"}
    unknown = set(value) - set(fields) - set(skip)
    if unknown:
        raise ConfigError(f"unknown fields for {cls.__name__}: {sorted(unknown)}", path)
    kwargs = {}
    for name, f in fields.items():
        tp = hints[name]
        optional, _ = _is_optional(tp)
        if name not in value:
            if optional:
                kwargs[name] = None
                continue
            if f.default is not dataclasses.MISSING:
                kwargs[name] = f.default
                continue
            if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                kwargs[name] = f.default_factory()  # type: ignore[misc]
                continue
            raise ConfigError(f"missing required field {name!r} for {cls.__name__}", path)
        kwargs[name] = parse(tp, value[name], f"{path}.{name}" if path else name)
    return cls(**kwargs)


def dump(obj: Any) -> Any:
    """Serialize a config object back to plain JSON data."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [dump(v) for v in obj]
    if isinstance(obj, dict):
        return {k: dump(v) for k, v in obj.items()}
    if getattr(obj, "__uzu_config__", False):
        out: dict[str, Any] = {}
        tag = getattr(obj, "__uzu_tag__", None)
        if tag is not None:
            out["type"] = tag
        for f in dataclasses.fields(obj):
            out[f.name] = dump(getattr(obj, f.name))
        return out
    raise TypeError(f"cannot dump {type(obj).__name__}")


def loads(tp: Any, text: str) -> Any:
    return parse(tp, json.loads(text))


def dumps(obj: Any) -> str:
    return json.dumps(dump(obj))
