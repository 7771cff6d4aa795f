"""Polynomials over Fr and G2 commitments — the subset the DKG needs.

The port's own copy of part of ``hbbft_tpu/crypto/poly.py``: Lagrange
interpolation at zero, univariate ``Poly``, its coefficient-wise G2
``Commitment`` (with ``evaluate``), and ``BivarPoly.random``, which
draws a dealer's symmetric coefficient matrix from the same rng stream
as the reference, so both packages deal identical polynomials from one
seed.  The bivariate commitment and the row helpers are not part of
this slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from . import fields as F
from .curve import G2, G2_GEN, g2_multi_exp
from ..core.serialize import wire

R = F.R


def _rand_fr(rng) -> int:
    return rng.randrange(R)


_LAGRANGE_CACHE: dict = {}


def lagrange_coefficients_at_zero(xs: Sequence[int]) -> List[int]:
    """λᵢ = Π_{j≠i} xⱼ/(xⱼ−xᵢ) mod r, for interpolation at x = 0
    (``xs`` distinct and nonzero; index+1 is the evaluation point).
    Cached by the point set."""
    key = tuple(xs)
    cached = _LAGRANGE_CACHE.get(key)
    if cached is not None:
        return list(cached)
    lams = []
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if i == j:
                continue
            num = num * xj % R
            den = den * (xj - xi) % R
        lams.append(num * pow(den, -1, R) % R)
    if len(_LAGRANGE_CACHE) >= 64:
        _LAGRANGE_CACHE.pop(next(iter(_LAGRANGE_CACHE)))
    _LAGRANGE_CACHE[key] = lams
    return list(lams)


def interpolate_at_zero(points: Sequence[Tuple[int, int]]) -> int:
    """Interpolate scalar shares (x, y) at 0 over Fr."""
    lams = lagrange_coefficients_at_zero([x for x, _ in points])
    return sum(lam * y for lam, (_, y) in zip(lams, points)) % R


@wire("Poly")
@dataclasses.dataclass
class Poly:
    """Univariate polynomial over Fr, coefficient order low→high."""

    coeffs: List[int]

    @classmethod
    def random(cls, degree: int, rng) -> "Poly":
        return cls([_rand_fr(rng) for _ in range(degree + 1)])

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % R
        return acc

    def commitment(self) -> "Commitment":
        return Commitment([G2_GEN * c for c in self.coeffs])


@wire("Commitment")
@dataclasses.dataclass
class Commitment:
    """Coefficient-wise G2 commitment of a :class:`Poly`."""

    coeffs: List[G2]

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int) -> G2:
        """Σⱼ Cⱼ·xʲ as one MSM over [1, x, x², …]."""
        x = x % R
        powers, acc = [], 1
        for _ in self.coeffs:
            powers.append(acc)
            acc = acc * x % R
        return g2_multi_exp(self.coeffs, powers)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Commitment)
            and len(self.coeffs) == len(other.coeffs)
            and all(a == b for a, b in zip(self.coeffs, other.coeffs))
        )


@dataclasses.dataclass
class BivarPoly:
    """Symmetric bivariate polynomial p(x, y) of degree ≤ t in each
    variable; ``coeffs[i][j] == coeffs[j][i]``."""

    coeffs: List[List[int]]  # (t+1) x (t+1), symmetric

    @classmethod
    def random(cls, degree: int, rng) -> "BivarPoly":
        """The upper triangle row by row from ``rng``, mirrored — the
        reference's draw order."""
        t = degree
        c = [[0] * (t + 1) for _ in range(t + 1)]
        for i in range(t + 1):
            for j in range(i, t + 1):
                v = _rand_fr(rng)
                c[i][j] = v
                c[j][i] = v
        return cls(c)
