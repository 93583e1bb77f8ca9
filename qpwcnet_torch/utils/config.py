"""Typed dataclass config + CLI (port of qpwcnet_tpu/utils/config.py,
without the JAX compile cache).

Every dataclass field becomes a ``--field-name value`` flag; ``--config
path.json`` loads a snapshot first.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
from typing import Callable, Type, TypeVar, get_type_hints

T = TypeVar("T")


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def parse_config(cls: Type[T], argv=None) -> T:
    parser = argparse.ArgumentParser(description=cls.__doc__)
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config snapshot to load first")
    hints = get_type_hints(cls)
    for field in dataclasses.fields(cls):
        ftype = hints.get(field.name, str)
        parser.add_argument(
            "--" + field.name.replace("_", "-"),
            type=_parse_bool if ftype is bool else (
                ftype if ftype in (int, float, str) else str),
            default=field.default)
    ns = parser.parse_args(argv)

    values = {}
    if ns.config:
        with open(ns.config) as f:
            values.update(json.load(f))
    for field in dataclasses.fields(cls):
        cli_val = getattr(ns, field.name)
        if field.name not in values or cli_val != field.default:
            values[field.name] = cli_val
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in values.items() if k in names})


def with_args(cls: Type[T]):
    """Decorator: ``main(cfg)`` becomes ``main(argv=None)`` with cfg parsed
    from the command line."""

    def decorator(fn: Callable[[T], None]):
        @functools.wraps(fn)
        def wrapped(argv=None):
            return fn(parse_config(cls, argv))

        return wrapped

    return decorator
