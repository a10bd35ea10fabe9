"""Config dataclass -> argparse rendering.

Counterpart of ``spine_vision_tpu/cli/config_args.py``, which walks a
pydantic model's ``model_fields``; the port's configs are dataclasses, so
this walks ``dataclasses.fields`` with the types of
``typing.get_type_hints`` (the config modules postpone their annotations,
so a field's ``type`` is a string). The rules are the JAX package's:
booleans get ``--flag/--no-flag`` pairs, tuples become fixed-arity nargs
(``tuple[X, ...]`` and lists variadic nargs), Literals become choices,
Optionals parse their inner type, and ``cli_aliases`` add short names (``-v``
for ``verbose``). Defaults are the fields' ``default`` or
``default_factory()``; help text is a field's ``metadata["help"]`` where it
has one.
"""

from __future__ import annotations

import argparse
import dataclasses
import types
import typing
from pathlib import Path
from typing import Any, Literal, Union


def _unwrap_optional(annotation: Any) -> tuple[Any, bool]:
    """Optional[X] -> (X, True); anything else -> (annotation, False)."""
    origin = typing.get_origin(annotation)
    if origin is Union or origin is types.UnionType:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return annotation, False


def _scalar_parser(annotation: Any) -> Any:
    if annotation is Path:
        return Path
    if annotation in (int, float, str):
        return annotation
    return str


def _fields(config_cls: type) -> list[tuple[dataclasses.Field, Any]]:
    """Each init field of the dataclass with its resolved type."""
    hints = typing.get_type_hints(config_cls)
    return [(f, hints[f.name]) for f in dataclasses.fields(config_cls) if f.init]


def _default(field: dataclasses.Field) -> Any:
    if field.default is not dataclasses.MISSING:
        return field.default
    if field.default_factory is not dataclasses.MISSING:
        return field.default_factory()
    return None


def add_config_args(
    parser: argparse.ArgumentParser,
    config_cls: type,
    skip: set[str] | None = None,
) -> None:
    """Add one argparse option per config field."""
    skip = skip or set()
    aliases: dict[str, list[str]] = getattr(config_cls, "cli_aliases", {})

    for field, hint in _fields(config_cls):
        name = field.name
        if name in skip:
            continue
        flag = "--" + name.replace("_", "-")
        names = aliases.get(name, []) + [flag]
        annotation, _ = _unwrap_optional(hint)
        origin = typing.get_origin(annotation)
        help_text = field.metadata.get("help", "")
        default = _default(field)

        if annotation is bool:
            parser.add_argument(
                *names, action=argparse.BooleanOptionalAction, default=default, help=help_text
            )
        elif origin is Literal:
            parser.add_argument(
                *names, choices=list(typing.get_args(annotation)), default=default,
                help=help_text,
            )
        elif origin is tuple:
            args = typing.get_args(annotation)
            variadic = len(args) == 2 and args[1] is Ellipsis
            parser.add_argument(
                *names, nargs="*" if variadic else len(args), type=_scalar_parser(args[0]),
                default=default, help=help_text,
            )
        elif origin is list:
            (elem,) = typing.get_args(annotation) or (str,)
            parser.add_argument(
                *names, nargs="*", type=_scalar_parser(elem), default=default, help=help_text
            )
        else:
            parser.add_argument(
                *names, type=_scalar_parser(annotation), default=default, help=help_text
            )


def config_from_args(
    config_cls: type,
    args: argparse.Namespace,
    overrides: dict[str, Any] | None = None,
) -> Any:
    """Instantiate a config from parsed args (tuple fields re-tupled)."""
    values: dict[str, Any] = {}
    for field, hint in _fields(config_cls):
        if not hasattr(args, field.name):
            continue
        value = getattr(args, field.name)
        annotation, _ = _unwrap_optional(hint)
        if typing.get_origin(annotation) is tuple and isinstance(value, list):
            value = tuple(value)
        values[field.name] = value
    if overrides:
        values.update(overrides)
    return config_cls(**values)
