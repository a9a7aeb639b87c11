"""Argument/state checking helpers (Catalyst ``Assert`` equivalent)."""

from __future__ import annotations

from typing import TypeVar

T = TypeVar("T")


def check_not_null(value: T | None, message: str = "value cannot be null") -> T:
    if value is None:
        raise ValueError(message)
    return value


def check_arg(condition: bool, message: str = "illegal argument", *args: object) -> None:
    if not condition:
        raise ValueError(message % args if args else message)


def check_state(condition: bool, message: str = "illegal state", *args: object) -> None:
    if not condition:
        raise RuntimeError(message % args if args else message)
