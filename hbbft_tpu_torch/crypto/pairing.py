"""Optimal ate pairing on BLS12-381 (host).

The port's own copy of ``hbbft_tpu/crypto/pairing.py``: the product
pairing check runs natively when the C++ library is built, else through
the pure-Python Miller loop and final exponentiation below.  Replaces
the pairing engine of the reference's ``pairing`` crate — the
workhorse behind every ``threshold_crypto`` verify call (signature-share
verify ``common_coin.rs:151``, decryption-share verify
``honey_badger.rs:229``, DKG value checks ``sync_key_gen.rs:449``).

Implementation notes:
- Miller loop runs with ``T`` in *affine Fq2 on the twist* (cheap), and
  each line is evaluated at the G1 point as a sparse Fq12 element.
  Lines are scaled by ``w³``; that factor lies in a subfield-torsion
  coset killed by the final exponentiation, so pairing values are
  unaffected (standard trick).
- Final exponentiation uses the cyclotomic decomposition
  ``3·(p⁴−p²+1)/r = (x−1)²·(x+p)·(x²+p²−1) + 3`` (Hayashida–Hayasaka–
  Teruya); we therefore compute the pairing raised to the fixed power 3,
  which (3 ∤ r) is still bilinear and non-degenerate.  The identity is
  asserted at import so the formula cannot silently be wrong.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from . import fields as F
from .fields import (
    FQ2_ZERO,
    FQ12_ONE,
    P,
    R,
    X_SIGNED,
    Z,
    fq2_add,
    fq2_inv,
    fq2_mul,
    fq2_neg,
    fq2_scalar,
    fq2_sq,
    fq2_sub,
    fq12_conj,
    fq12_frobenius,
    fq12_frobenius2,
    fq12_inv,
    fq12_mul,
    fq12_sq,
)
from .curve import G1, G2

# Verify the final-exponentiation decomposition at import time.
assert (P**4 - P**2 + 1) % R == 0
assert (
    3 * ((P**4 - P**2 + 1) // R)
    == (X_SIGNED - 1) ** 2 * (X_SIGNED + P) * (X_SIGNED**2 + P**2 - 1) + 3
), "BLS12 hard-part decomposition failed"
assert R % 3 != 0  # cubing is a bijection on the r-torsion of roots of unity

_Z_BITS = [(Z >> i) & 1 for i in range(Z.bit_length() - 2, -1, -1)]


# ---------------------------------------------------------------------------
# Sparse Fq6/Fq12 multiplications for line evaluation
# ---------------------------------------------------------------------------


def _fq6_mul_by_01(c, s0, s1):
    """(c0,c1,c2)·(s0,s1,0) in Fq6."""
    c0, c1, c2 = c
    return (
        fq2_add(fq2_mul(c0, s0), F.fq2_mul_xi(fq2_mul(c2, s1))),
        fq2_add(fq2_mul(c0, s1), fq2_mul(c1, s0)),
        fq2_add(fq2_mul(c1, s1), fq2_mul(c2, s0)),
    )


def _fq6_mul_by_1(c, s1):
    """(c0,c1,c2)·(0,s1,0) in Fq6."""
    c0, c1, c2 = c
    return (F.fq2_mul_xi(fq2_mul(c2, s1)), fq2_mul(c0, s1), fq2_mul(c1, s1))


def _mul_by_line(f, a0, a1, b1):
    """f · l where l = (a0 + a1·v) + (b1·v)·w   (sparse Fq12)."""
    f0, f1 = f
    t0 = _fq6_mul_by_01(f0, a0, a1)
    t1 = _fq6_mul_by_1(f1, b1)
    # c1 = (f0+f1)·(a + b) − t0 − t1, with a+b = (a0, a1+b1, 0)
    fs = F.fq6_add(f0, f1)
    c1 = F.fq6_sub(F.fq6_sub(_fq6_mul_by_01(fs, a0, fq2_add(a1, b1)), t0), t1)
    c0 = F.fq6_add(t0, F.fq6_mul_by_v(t1))
    return (c0, c1)


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def _line_dbl(T, xP, yP):
    """Tangent line at T=(X,Y)∈E'(Fq2), evaluated at P=(xP,yP)∈E(Fq).

    Returns (line components (a0,a1,b1), 2T)."""
    X, Y = T
    lam = fq2_mul(fq2_scalar(fq2_sq(X), 3), fq2_inv(fq2_scalar(Y, 2)))
    X3 = fq2_sub(fq2_sq(lam), fq2_scalar(X, 2))
    Y3 = fq2_sub(fq2_mul(lam, fq2_sub(X, X3)), Y)
    a0 = fq2_sub(fq2_mul(lam, X), Y)
    a1 = fq2_scalar(fq2_neg(lam), xP)
    b1 = (yP, 0)
    return (a0, a1, b1), (X3, Y3)


def _line_add(T, Q, xP, yP):
    """Line through T and Q on the twist, evaluated at P."""
    X1, Y1 = T
    X2, Y2 = Q
    lam = fq2_mul(fq2_sub(Y2, Y1), fq2_inv(fq2_sub(X2, X1)))
    X3 = fq2_sub(fq2_sub(fq2_sq(lam), X1), X2)
    Y3 = fq2_sub(fq2_mul(lam, fq2_sub(X1, X3)), Y1)
    a0 = fq2_sub(fq2_mul(lam, X1), Y1)
    a1 = fq2_scalar(fq2_neg(lam), xP)
    b1 = (yP, 0)
    return (a0, a1, b1), (X3, Y3)


def miller_loop(p: G1, q: G2) -> F.Fq12:
    """f_{|x|,Q}(P), conjugated for the negative BLS parameter."""
    paff = p.affine()
    qaff = q.affine()
    if paff is None or qaff is None:
        return FQ12_ONE
    xP, yP = paff
    Q = qaff
    T = Q
    f = FQ12_ONE
    for bit in _Z_BITS:
        f = fq12_sq(f)
        line, T = _line_dbl(T, xP, yP)
        f = _mul_by_line(f, *line)
        if bit:
            line, T = _line_add(T, Q, xP, yP)
            f = _mul_by_line(f, *line)
    return fq12_conj(f)  # parameter x < 0


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def _exp_by_z(m: F.Fq12) -> F.Fq12:
    """m^Z (Z = |x|) by square-and-multiply; m must be cyclotomic."""
    result = m
    for bit in _Z_BITS:
        result = fq12_sq(result)
        if bit:
            result = fq12_mul(result, m)
    return result


def _exp_by_x(m: F.Fq12) -> F.Fq12:
    """m^x with x = -Z, using conjugation as cyclotomic inverse."""
    return fq12_conj(_exp_by_z(m))


def final_exponentiation(f: F.Fq12) -> F.Fq12:
    """f^{3·(p¹²−1)/r} — the pairing raised to a fixed power coprime to r."""
    # easy part: f^((p^6-1)(p^2+1))
    f = fq12_mul(fq12_conj(f), fq12_inv(f))
    f = fq12_mul(fq12_frobenius2(f), f)
    m = f
    # hard part: m^((x-1)^2 (x+p) (x^2+p^2-1)) · m^3
    t0 = fq12_mul(_exp_by_x(m), fq12_conj(m))  # m^(x-1)
    t0 = fq12_mul(_exp_by_x(t0), fq12_conj(t0))  # m^((x-1)^2)
    t1 = fq12_mul(_exp_by_x(t0), fq12_frobenius(t0))  # t0^(x+p)
    t3 = _exp_by_x(_exp_by_x(t1))  # t1^(x^2)
    out = fq12_mul(fq12_mul(t3, fq12_frobenius2(t1)), fq12_conj(t1))
    return fq12_mul(out, fq12_mul(m, fq12_sq(m)))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _native():
    from .. import native as NT

    return NT.backend()


def pairing_check(pairs: Iterable[Tuple[G1, G2]]) -> bool:
    """True iff Π e(Pᵢ, Qᵢ) == 1.

    One shared final exponentiation over the product of Miller loops —
    this is what makes batched (random-linear-combination) share
    verification cheap on the host side.
    """
    pairs = list(pairs)
    nt = _native()
    if nt is not None:
        return nt.pairing_check(
            [nt.g1_wire(p) for p, _ in pairs], [nt.g2_wire(q) for _, q in pairs]
        )
    acc = FQ12_ONE
    for p, q in pairs:
        acc = fq12_mul(acc, miller_loop(p, q))
    return final_exponentiation(acc) == FQ12_ONE
