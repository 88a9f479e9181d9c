"""argparse types shared by the port's CLIs: the JAX package's click types
(``cli/options.py``'s ``CommaSeparated``, click's ``BOOL``, ``IntRange``,
``FloatRange``, ``Path(exists=True, file_okay=False)``) with the same
accepted values and the same failures (argparse exits 2, as click does)."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Callable

_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}


def str2bool(value: str) -> bool:
    """click's ``BOOL`` words, case-insensitive."""
    norm = value.strip().lower()
    if norm in _TRUE:
        return True
    if norm in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"{value!r} is not a valid boolean")


def comma_separated(type_: type = str, n: int | None = None) -> Callable[[str], list[Any]]:
    """Parse "a,b,c" into a typed list; optionally exactly ``n`` items."""
    if n is not None and n <= 0:
        raise ValueError("n must be None or a positive integer")

    def parse(value: str) -> list[Any]:
        value = value.strip()
        if value == "":
            return []
        items = value.split(",")
        if n is not None and len(items) != n:
            raise argparse.ArgumentTypeError(
                f"{value} does not contain exactly {n} comma separated values")
        try:
            return [type_(item) for item in items]
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{value} is not a valid comma separated list of {type_.__name__}") from None

    parse.__name__ = "comma_separated"
    return parse


def number_range(type_: type, min: float | None = None, max: float | None = None,
                 min_open: bool = False, max_open: bool = False) -> Callable[[str], Any]:
    """click's ``IntRange`` / ``FloatRange`` (no clamping)."""

    def parse(value: str) -> Any:
        try:
            x = type_(value)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{value!r} is not a valid {type_.__name__}") from None
        low = min is not None and (x <= min if min_open else x < min)
        high = max is not None and (x >= max if max_open else x > max)
        if low or high:
            lo = "" if min is None else f"{min}{'<' if min_open else '<='}"
            hi = "" if max is None else f"{'<' if max_open else '<='}{max}"
            raise argparse.ArgumentTypeError(f"{value} is not in the range {lo}x{hi}")
        return x

    parse.__name__ = type_.__name__
    return parse


def existing_dir(value: str) -> Path:
    path = Path(value)
    if not path.exists():
        raise argparse.ArgumentTypeError(f"Directory '{value}' does not exist.")
    if not path.is_dir():
        raise argparse.ArgumentTypeError(f"Directory '{value}' is a file.")
    return path
