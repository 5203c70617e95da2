"""Typed errors and check helpers (the port of ``paddle_tpu/errors.py``,
the analog of ``paddle/common/enforce.h``): the reference's error hierarchy
and its small enforce helpers."""

from __future__ import annotations


class EnforceNotMet(RuntimeError):
    """Base error for failed runtime checks."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


def enforce(cond: bool, msg: str = "", exc: type = InvalidArgumentError) -> None:
    if not cond:
        raise exc(msg or "Enforce failed.")


def enforce_eq(a, b, msg: str = "") -> None:
    if a != b:
        raise InvalidArgumentError(f"{msg} (expected {a!r} == {b!r})")


def enforce_shape_match(shape_a, shape_b, msg: str = "") -> None:
    if tuple(shape_a) != tuple(shape_b):
        raise InvalidArgumentError(f"{msg} (shape {tuple(shape_a)} vs {tuple(shape_b)})")
