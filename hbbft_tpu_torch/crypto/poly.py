"""Polynomials over Fr and G2 commitments — the Shamir layer.

The port's own copy of ``hbbft_tpu/crypto/poly.py``: Lagrange
interpolation at zero, univariate ``Poly`` and its coefficient-wise G2
``Commitment``, the symmetric ``BivarPoly`` a DKG dealer draws (from the
same rng stream as the reference, so both packages deal identical
polynomials from one seed) and its G2 ``BivarCommitment``, which the
sequential ``SyncKeyGen`` checks rows and values against.  Every
commitment evaluation is one G2 MSM (native host Pippenger).  Wire
names are the reference's.
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

    def __add__(self, other: "Commitment") -> "Commitment":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [G2.infinity()] * (n - len(self.coeffs))
        b = other.coeffs + [G2.infinity()] * (n - len(other.coeffs))
        return Commitment([x + y for x, y in zip(a, b)])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Commitment)
            and len(self.coeffs) == len(other.coeffs)
            and all(a == b for a, b in zip(self.coeffs, other.coeffs))
        )


@wire("BivarPoly")
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

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int, y: int) -> int:
        acc = 0
        for row in reversed(self.coeffs):
            inner = 0
            for c in reversed(row):
                inner = (inner * y + c) % R
            acc = (acc * x + inner) % R
        return acc

    def row(self, x: int) -> Poly:
        """The univariate polynomial q(y) = p(x, y)."""
        t = self.degree
        out = []
        for j in range(t + 1):
            acc = 0
            for i in reversed(range(t + 1)):
                acc = (acc * x + self.coeffs[i][j]) % R
            out.append(acc)
        return Poly(out)

    def commitment(self) -> "BivarCommitment":
        return BivarCommitment([[G2_GEN * c for c in row] for row in self.coeffs])


def _powers(x: int, n: int) -> List[int]:
    """[1, x, …, x^(n−1)] mod r."""
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * x % R
    return out


@wire("BivarCommitment")
@dataclasses.dataclass
class BivarCommitment:
    """G2 commitment matrix of a symmetric :class:`BivarPoly`."""

    coeffs: List[List[G2]]

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int, y: int) -> G2:
        """Σᵢⱼ xⁱyʲ·Cᵢⱼ as one flattened MSM."""
        t = self.degree
        xp, yp = _powers(x % R, t + 1), _powers(y % R, t + 1)
        pts = [c for row in self.coeffs for c in row]
        scalars = [xp[i] * yp[j] % R for i in range(t + 1) for j in range(t + 1)]
        return g2_multi_exp(pts, scalars)

    def row(self, x: int) -> Commitment:
        """Commitment of the row polynomial p(x, ·): one MSM a column."""
        t = self.degree
        xp = _powers(x % R, t + 1)
        return Commitment(
            [g2_multi_exp([self.coeffs[i][j] for i in range(t + 1)], xp) for j in range(t + 1)]
        )

    def is_symmetric(self) -> bool:
        t = self.degree
        if any(len(row) != t + 1 for row in self.coeffs):
            return False
        return all(
            self.coeffs[i][j] == self.coeffs[j][i]
            for i in range(t + 1)
            for j in range(i + 1, t + 1)
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BivarCommitment)
            and len(self.coeffs) == len(other.coeffs)
            and all(
                len(r1) == len(r2) and all(a == b for a, b in zip(r1, r2))
                for r1, r2 in zip(self.coeffs, other.coeffs)
            )
        )
