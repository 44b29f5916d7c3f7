"""Exact rational arithmetic for rates, aspect ratios and carrier frequencies.

The reference keeps every timing-critical constant as an exact {num, den}
rational (src/common.c:58-207 `r64_*`).  We use Python's arbitrary-precision
integers wrapped in a tiny immutable type so derived quantities (samples per
line, carrier phase steps, resampler ratios) stay exact until the final
float conversion on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class Rational:
    num: int
    den: int = 1

    def __post_init__(self) -> None:
        num, den = self.num, self.den
        if den == 0:
            object.__setattr__(self, "num", 0)
            return
        if den < 0:
            num, den = -num, -den
        g = math.gcd(num, den) or 1
        object.__setattr__(self, "num", num // g)
        object.__setattr__(self, "den", den // g)

    # -- arithmetic ---------------------------------------------------------
    def __mul__(self, other: "Rational | int") -> "Rational":
        other = _coerce(other)
        return Rational(self.num * other.num, self.den * other.den)

    __rmul__ = __mul__

    def __truediv__(self, other: "Rational | int") -> "Rational":
        other = _coerce(other)
        return Rational(self.num * other.den, self.den * other.num)

    def __rtruediv__(self, other: "Rational | int") -> "Rational":
        return _coerce(other) / self

    def __add__(self, other: "Rational | int") -> "Rational":
        other = _coerce(other)
        return Rational(self.num * other.den + other.num * self.den,
                        self.den * other.den)

    __radd__ = __add__

    def __sub__(self, other: "Rational | int") -> "Rational":
        other = _coerce(other)
        return Rational(self.num * other.den - other.num * self.den,
                        self.den * other.den)

    def __neg__(self) -> "Rational":
        return Rational(-self.num, self.den)

    # -- comparison ---------------------------------------------------------
    def cmp(self, other: "Rational | int") -> int:
        other = _coerce(other)
        c = self.num * other.den - self.den * other.num
        return -1 if c < 0 else (1 if c > 0 else 0)

    def __lt__(self, other):
        return self.cmp(other) < 0

    def __le__(self, other):
        return self.cmp(other) <= 0

    def __gt__(self, other):
        return self.cmp(other) > 0

    def __ge__(self, other):
        return self.cmp(other) >= 0

    # -- conversion ---------------------------------------------------------
    def __float__(self) -> float:
        return self.num / self.den

    def __bool__(self) -> bool:
        return self.num != 0 and self.den != 0

    def __repr__(self) -> str:
        return f"{self.num}/{self.den}"


def _coerce(v: "Rational | int") -> Rational:
    if isinstance(v, Rational):
        return v
    if isinstance(v, int):
        return Rational(v, 1)
    raise TypeError(f"cannot coerce {type(v)} to Rational")


def nearest(ref: Rational, a: Rational, b: Rational) -> Rational:
    """Return `a` or `b`, whichever is nearest `ref` (`a` on a tie).

    Mirrors src/common.c:80-85 `r64_nearest`.
    """
    half = Rational(a.num * b.den + a.den * b.num, a.den * b.den * 2)
    return a if ref.cmp(half) <= 0 else b


def parse(text: str) -> Rational:
    """Parse a decimal number, optionally with exponent, or an `x:y` / `x/y`
    ratio — the accepted grammar of the reference CLI (src/common.c:87-207).
    """
    s = text.strip()
    for sep in (":", "/"):
        if sep in s:
            a, b = s.split(sep, 1)
            return _parse_decimal(a) / _parse_decimal(b)
    return _parse_decimal(s)


def _parse_decimal(s: str) -> Rational:
    s = s.strip()
    neg = s.startswith("-")
    if s and s[0] in "+-":
        s = s[1:]
    mant, _, exp = s.partition("e") if "e" in s else s.partition("E")
    exp_v = int(exp) if exp else 0
    if "." in mant:
        int_part, frac = mant.split(".", 1)
    else:
        int_part, frac = mant, ""
    if not (int_part or frac):
        raise ValueError(f"invalid rational: {s!r}")
    num = int((int_part or "0") + frac) if (int_part or frac) else 0
    den = 10 ** len(frac)
    if exp_v > 0:
        num *= 10 ** exp_v
    elif exp_v < 0:
        den *= 10 ** -exp_v
    if neg:
        num = -num
    return Rational(num, den)
