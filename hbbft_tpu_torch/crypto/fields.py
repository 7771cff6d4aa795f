"""BLS12-381 field tower — pure-Python host implementation.

The PyTorch port's own copy of ``hbbft_tpu/crypto/fields.py`` (the port
imports nothing of the JAX package).  Replaces the reference's
``pairing`` crate (``Cargo.toml:22``; used via ``threshold_crypto``
everywhere and directly in ``sync_key_gen.rs:160-161``).

Representation choices are deliberately *functional over plain tuples of
ints* rather than classes: it is measurably faster in CPython, and the
device limb form (``hbbft_tpu_torch/ops/limbs.py``) converts to and
from these plain ints at the host boundary.

Tower: Fq2 = Fq[u]/(u²+1);  Fq6 = Fq2[v]/(v³−ξ), ξ=u+1;  Fq12 = Fq6[w]/(w²−v).

All curve constants are verified by arithmetic identities at import time
(cheap asserts) so a mis-remembered constant fails loudly, not subtly.
"""

from __future__ import annotations

from typing import Tuple

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

# Base field modulus
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus (group order r)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS curve parameter x (negative); Z is its absolute value.
Z = 0xD201000000010000
X_SIGNED = -Z

# G1 cofactor h1 = (x-1)^2 / 3 and identity p = h1*r + x
H1 = ((X_SIGNED - 1) ** 2) // 3
assert ((X_SIGNED - 1) ** 2) % 3 == 0
assert P == H1 * R + X_SIGNED, "BLS12 parameterisation identity failed"
assert R == Z**4 - Z**2 + 1, "r(x) identity failed"
assert P % 4 == 3 and P % 6 == 1

# G2 cofactor h2 = (x^8 - 4x^7 + 5x^6 - 4x^4 + 6x^3 - 4x^2 - 4x + 13) / 9
H2 = (Z**8 - 4 * Z**7 + 5 * Z**6 - 4 * Z**4 + 6 * Z**3 - 4 * Z**2 - 4 * Z + 13) // 9

Fq = int
Fq2 = Tuple[int, int]
Fq6 = Tuple[Fq2, Fq2, Fq2]
Fq12 = Tuple[Fq6, Fq6]

# ---------------------------------------------------------------------------
# Fq — integers mod P (helpers; mostly inlined at call sites)
# ---------------------------------------------------------------------------


def fq_inv(a: int) -> int:
    return pow(a, -1, P)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (p ≡ 3 mod 4): a^((p+1)/4); None if non-residue."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

FQ2_ZERO: Fq2 = (0, 0)
FQ2_ONE: Fq2 = (1, 0)
XI: Fq2 = (1, 1)  # ξ = 1 + u, the Fq6 non-residue


def fq2_add(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a: Fq2) -> Fq2:
    return (-a[0] % P, -a[1] % P)


def fq2_mul(a: Fq2, b: Fq2) -> Fq2:
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0b1 + a1b0
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fq2_sq(a: Fq2) -> Fq2:
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fq2_scalar(a: Fq2, k: int) -> Fq2:
    return (a[0] * k % P, a[1] * k % P)


def fq2_conj(a: Fq2) -> Fq2:
    return (a[0], -a[1] % P)


def fq2_inv(a: Fq2) -> Fq2:
    a0, a1 = a
    d = pow(a0 * a0 + a1 * a1, -1, P)
    return (a0 * d % P, -a1 * d % P)


def fq2_mul_xi(a: Fq2) -> Fq2:
    """Multiply by ξ = 1+u: (a0 - a1) + (a0 + a1)u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fq2_pow(a: Fq2, e: int) -> Fq2:
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sq(base)
        e >>= 1
    return result


def fq2_sqrt(a: Fq2) -> Fq2 | None:
    """Square root in Fq2 for p ≡ 3 mod 4 (Adj–Rodríguez-Henríquez Alg. 9)."""
    if a == FQ2_ZERO:
        return FQ2_ZERO
    a1 = fq2_pow(a, (P - 3) // 4)
    x0 = fq2_mul(a1, a)
    alpha = fq2_mul(a1, x0)  # a^((p-1)/2)
    if alpha == (P - 1, 0):  # alpha == -1
        x = (-x0[1] % P, x0[0])  # u * x0
    else:
        b = fq2_pow(fq2_add(FQ2_ONE, alpha), (P - 1) // 2)
        x = fq2_mul(b, x0)
    return x if fq2_sq(x) == a else None


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v³ − ξ)
# ---------------------------------------------------------------------------

FQ6_ZERO: Fq6 = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE: Fq6 = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a: Fq6, b: Fq6) -> Fq6:
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a: Fq6, b: Fq6) -> Fq6:
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a: Fq6) -> Fq6:
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a: Fq6, b: Fq6) -> Fq6:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    # c0 = t0 + ξ((a1+a2)(b1+b2) - t1 - t2)
    c0 = fq2_add(
        t0,
        fq2_mul_xi(
            fq2_sub(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), t1), t2)
        ),
    )
    # c1 = (a0+a1)(b0+b1) - t0 - t1 + ξ t2
    c1 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), t0), t1),
        fq2_mul_xi(t2),
    )
    # c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    c2 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), t0), t2), t1
    )
    return (c0, c1, c2)


def fq6_sq(a: Fq6) -> Fq6:
    return fq6_mul(a, a)


def fq6_mul_by_v(a: Fq6) -> Fq6:
    """Multiply by v: (c0,c1,c2) -> (ξ·c2, c0, c1)."""
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a: Fq6) -> Fq6:
    c0, c1, c2 = a
    t0 = fq2_sub(fq2_sq(c0), fq2_mul_xi(fq2_mul(c1, c2)))
    t1 = fq2_sub(fq2_mul_xi(fq2_sq(c2)), fq2_mul(c0, c1))
    t2 = fq2_sub(fq2_sq(c1), fq2_mul(c0, c2))
    d = fq2_add(
        fq2_mul(c0, t0),
        fq2_mul_xi(fq2_add(fq2_mul(c1, t2), fq2_mul(c2, t1))),
    )
    dinv = fq2_inv(d)
    return (fq2_mul(t0, dinv), fq2_mul(t1, dinv), fq2_mul(t2, dinv))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w² − v)
# ---------------------------------------------------------------------------

FQ12_ONE: Fq12 = (FQ6_ONE, FQ6_ZERO)


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sq(a: Fq12) -> Fq12:
    a0, a1 = a
    t = fq6_mul(a0, a1)
    c0 = fq6_sub(
        fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_v(a1))), t),
        fq6_mul_by_v(t),
    )
    return (c0, fq6_add(t, t))


def fq12_conj(a: Fq12) -> Fq12:
    """Conjugation = Frobenius^6; equals inverse on the cyclotomic subgroup."""
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a: Fq12) -> Fq12:
    a0, a1 = a
    d = fq6_sub(fq6_sq(a0), fq6_mul_by_v(fq6_sq(a1)))
    dinv = fq6_inv(d)
    return (fq6_mul(a0, dinv), fq6_neg(fq6_mul(a1, dinv)))


def fq12_pow(a: Fq12, e: int) -> Fq12:
    if e < 0:
        a = fq12_inv(a)
        e = -e
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        e >>= 1
    return result


# -- Frobenius --------------------------------------------------------------
# Constants computed (not memorised): γ1 = ξ^((p-1)/6) governs w^p = γ1·w.

_G1C = fq2_pow(XI, (P - 1) // 6)  # ξ^((p-1)/6)
_FROB6_C1 = fq2_pow(XI, (P - 1) // 3)  # v^p = C1 · v
_FROB6_C2 = fq2_pow(XI, 2 * (P - 1) // 3)  # v^{2p} = C2 · v²


def fq6_frobenius(a: Fq6) -> Fq6:
    return (
        fq2_conj(a[0]),
        fq2_mul(fq2_conj(a[1]), _FROB6_C1),
        fq2_mul(fq2_conj(a[2]), _FROB6_C2),
    )


def _fq6_scale_fq2(a: Fq6, s: Fq2) -> Fq6:
    return (fq2_mul(a[0], s), fq2_mul(a[1], s), fq2_mul(a[2], s))


def fq12_frobenius(a: Fq12) -> Fq12:
    c0 = fq6_frobenius(a[0])
    c1 = _fq6_scale_fq2(fq6_frobenius(a[1]), _G1C)
    return (c0, c1)


def fq12_frobenius2(a: Fq12) -> Fq12:
    return fq12_frobenius(fq12_frobenius(a))
