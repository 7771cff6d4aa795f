"""BLS12-381 G1/G2 group arithmetic and zcash-format serialization.

The port's own copy of the host group layer of
``hbbft_tpu/crypto/curve.py``: Jacobian ``(X, Y, Z)`` tuples over Fq /
Fq2 (``Z == 0`` ⇒ infinity) from one shared formula source, the
compressed zcash encoding (48-byte G1 / 96-byte G2, flag bits
0x80/0x40/0x20) used for cache keys, Fiat–Shamir transcripts and the
``@wire`` codec (``from_bytes`` decodes it strictly: on the curve and in
the r-torsion subgroup), the native 96/192-byte wire, Montgomery batch
normalization, and the host MSMs (native Pippenger when the C++ library
is built, naive double-and-add otherwise).
"""

from __future__ import annotations

from typing import Any

from . import fields as F
from ..core.serialize import wire


def _native():
    """The C++ BLS backend (``hbbft_tpu_torch.native``) or None."""
    from .. import native as NT

    return NT.backend()

# ---------------------------------------------------------------------------
# Generic Jacobian arithmetic over a field given by its op table
# ---------------------------------------------------------------------------


def _jacobian_ops(zero, one, add, sub, neg, mul, sq, scalar, inv, eq):
    """Build Jacobian point ops for y² = x³ + b over an abstract field."""

    INF = (zero, one, zero)

    def is_inf(p):
        return eq(p[2], zero)

    def double(p):
        X1, Y1, Z1 = p
        if eq(Z1, zero) or eq(Y1, zero):
            return INF
        A = sq(X1)
        B = sq(Y1)
        C = sq(B)
        D = scalar(sub(sub(sq(add(X1, B)), A), C), 2)
        E = scalar(A, 3)
        Fv = sq(E)
        X3 = sub(Fv, scalar(D, 2))
        Y3 = sub(mul(E, sub(D, X3)), scalar(C, 8))
        Z3 = scalar(mul(Y1, Z1), 2)
        return (X3, Y3, Z3)

    def padd(p, q):
        if eq(p[2], zero):
            return q
        if eq(q[2], zero):
            return p
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1 = sq(Z1)
        Z2Z2 = sq(Z2)
        U1 = mul(X1, Z2Z2)
        U2 = mul(X2, Z1Z1)
        S1 = mul(mul(Y1, Z2), Z2Z2)
        S2 = mul(mul(Y2, Z1), Z1Z1)
        if eq(U1, U2):
            if eq(S1, S2):
                return double(p)
            return INF
        H = sub(U2, U1)
        I = sq(scalar(H, 2))
        J = mul(H, I)
        rr = scalar(sub(S2, S1), 2)
        V = mul(U1, I)
        X3 = sub(sub(sq(rr), J), scalar(V, 2))
        Y3 = sub(mul(rr, sub(V, X3)), scalar(mul(S1, J), 2))
        Z3 = mul(sub(sub(sq(add(Z1, Z2)), Z1Z1), Z2Z2), H)
        return (X3, Y3, Z3)

    def pneg(p):
        return (p[0], neg(p[1]), p[2])

    def mul_raw(p, k: int):
        if k == 0 or eq(p[2], zero):
            return INF
        result = INF
        bit = 1 << (k.bit_length() - 1)
        while bit:
            result = double(result)
            if k & bit:
                result = padd(result, p)
            bit >>= 1
        return result

    def mul_scalar(p, k: int):
        # Protocol scalars live in Fr; reduce before the double-and-add.
        return mul_raw(p, k % F.R)

    def to_affine(p):
        if eq(p[2], zero):
            return None
        zinv = inv(p[2])
        zinv2 = sq(zinv)
        return (mul(p[0], zinv2), mul(mul(p[1], zinv), zinv2))

    def batch_to_affine(pts):
        """Affine forms of many points with ONE field inversion
        (Montgomery's trick): prefix products of the Z coordinates,
        a single ``inv`` of the running product, then a back-sweep
        peeling off each 1/Zᵢ with two muls.  Every field op is
        canonical (reduced representatives), so each recovered
        inverse equals ``inv(Zᵢ)`` exactly and the output is
        bit-identical to per-point :func:`to_affine`."""
        idx = [i for i, p in enumerate(pts) if not eq(p[2], zero)]
        out = [None] * len(pts)
        if not idx:
            return out
        zs = [pts[i][2] for i in idx]
        prefix = []
        acc = None
        for z in zs:
            acc = z if acc is None else mul(acc, z)
            prefix.append(acc)
        acc = inv(prefix[-1])
        for j in range(len(idx) - 1, -1, -1):
            zinv = mul(acc, prefix[j - 1]) if j else acc
            acc = mul(acc, zs[j])
            p = pts[idx[j]]
            zinv2 = sq(zinv)
            out[idx[j]] = (mul(p[0], zinv2), mul(mul(p[1], zinv), zinv2))
        return out

    def from_affine(a):
        if a is None:
            return INF
        return (a[0], a[1], one)

    def point_eq(p, q):
        pi, qi = eq(p[2], zero), eq(q[2], zero)
        if pi or qi:
            return pi and qi
        # X1·Z2² == X2·Z1², Y1·Z2³ == Y2·Z1³
        Z1Z1, Z2Z2 = sq(p[2]), sq(q[2])
        if not eq(mul(p[0], Z2Z2), mul(q[0], Z1Z1)):
            return False
        return eq(mul(mul(p[1], q[2]), Z2Z2), mul(mul(q[1], p[2]), Z1Z1))

    return {
        "INF": INF,
        "is_inf": is_inf,
        "mul_raw": mul_raw,
        "double": double,
        "add": padd,
        "neg": pneg,
        "mul": mul_scalar,
        "to_affine": to_affine,
        "batch_to_affine": batch_to_affine,
        "from_affine": from_affine,
        "eq": point_eq,
    }


# Fq op table ---------------------------------------------------------------

_fq_ops = _jacobian_ops(
    zero=0,
    one=1,
    add=lambda a, b: (a + b) % F.P,
    sub=lambda a, b: (a - b) % F.P,
    neg=lambda a: -a % F.P,
    mul=lambda a, b: a * b % F.P,
    sq=lambda a: a * a % F.P,
    scalar=lambda a, k: a * k % F.P,
    inv=F.fq_inv,
    eq=lambda a, b: a == b,
)

_fq2_ops = _jacobian_ops(
    zero=F.FQ2_ZERO,
    one=F.FQ2_ONE,
    add=F.fq2_add,
    sub=F.fq2_sub,
    neg=F.fq2_neg,
    mul=F.fq2_mul,
    sq=F.fq2_sq,
    scalar=F.fq2_scalar,
    inv=F.fq2_inv,
    eq=lambda a, b: a == b,
)

B1 = 4  # G1: y² = x³ + 4
B2 = F.fq2_scalar(F.XI, 4)  # G2: y² = x³ + 4(1+u)

# Generators (standard BLS12-381 generators; verified on-curve below).
_G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
_G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
_G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
_G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

assert (_G1_Y * _G1_Y - (_G1_X**3 + B1)) % F.P == 0, "G1 generator not on curve"
assert F.fq2_sub(
    F.fq2_sq(_G2_Y), F.fq2_add(F.fq2_mul(F.fq2_sq(_G2_X), _G2_X), B2)
) == F.FQ2_ZERO, "G2 generator not on curve"


def _is_lex_largest_fq(y: int) -> bool:
    return y > F.P - y


def _is_lex_largest_fq2(y: F.Fq2) -> bool:
    ny = F.fq2_neg(y)
    return (y[1], y[0]) > (ny[1], ny[0])


class _Point:
    """Shared wrapper over Jacobian tuples; subclassed per group.

    ``_wire`` / ``_cbytes`` memoize the native wire and the compressed
    encoding (pure functions of the immutable ``jac``)."""

    __slots__ = ("jac", "_wire", "_cbytes")
    ops: dict
    b: Any

    def __init__(self, jac):
        self.jac = jac

    def __add__(self, other):
        return type(self)(self.ops["add"](self.jac, other.jac))

    def __sub__(self, other):
        return self + (-other)

    def __neg__(self):
        return type(self)(self.ops["neg"](self.jac))

    def __mul__(self, k: int):
        nt = _native()
        if nt is not None:
            return self._native_mul(nt, int(k) % F.R)
        return type(self)(self.ops["mul"](self.jac, k))

    __rmul__ = __mul__

    def is_infinity(self) -> bool:
        return self.ops["is_inf"](self.jac)

    def affine(self):
        return self.ops["to_affine"](self.jac)

    def to_bytes(self) -> bytes:
        """Canonical compressed encoding, memoized."""
        cached = getattr(self, "_cbytes", None)
        if cached is None:
            cached = self._encode_affine(self.affine())
            self._cbytes = cached
        return cached

    @classmethod
    def batch_affine(cls, points):
        """Affine forms of many points sharing ONE field inversion
        (Montgomery batch inversion) — bit-identical to per-point
        :meth:`affine`."""
        return cls.ops["batch_to_affine"]([p.jac for p in points])

    @classmethod
    def batch_serialize(cls, points):
        """Fill the ``_cbytes`` and ``_wire`` memos of every point in one
        batch-inversion pass (points carrying both are skipped)."""
        todo = [
            p
            for p in points
            if getattr(p, "_cbytes", None) is None
            or getattr(p, "_wire", None) is None
        ]
        if not todo:
            return
        for p, aff in zip(todo, cls.batch_affine(todo)):
            if getattr(p, "_cbytes", None) is None:
                p._cbytes = cls._encode_affine(aff)
            if getattr(p, "_wire", None) is None:
                p._wire = cls._wire_affine(aff)

    def __eq__(self, other) -> bool:
        return isinstance(other, type(self)) and self.ops["eq"](self.jac, other.jac)

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.affine()))

    @classmethod
    def infinity(cls):
        return cls(cls.ops["INF"])

    @classmethod
    def from_affine(cls, aff):
        pt = cls(cls.ops["from_affine"](aff))
        if aff is not None and not pt.is_on_curve():
            raise ValueError("point not on curve")
        return pt

    def in_subgroup(self) -> bool:
        # unreduced multiply-by-r (``mul`` reduces mod r and would be
        # vacuous here)
        nt = _native()
        if nt is not None:
            return self._native_mul(nt, F.R).is_infinity()
        return self.ops["is_inf"](self.ops["mul_raw"](self.jac, F.R))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_bytes().hex()[:16]}…)"

    def _wire_fields(self):
        return (self.to_bytes(),)

    @classmethod
    def _from_wire(cls, data: bytes):
        return cls.from_bytes(data)


@wire("G1")
class G1(_Point):
    """Point on E(Fq): y² = x³ + 4 (48-byte compressed)."""

    __slots__ = ()
    ops = _fq_ops
    b = B1

    def is_on_curve(self) -> bool:
        X, Y, Zc = self.jac
        if Zc == 0:
            return True
        # Y² = X³ + 4·Z⁶
        return (Y * Y - (X**3 + B1 * pow(Zc, 6, F.P))) % F.P == 0

    def _native_mul(self, nt, k: int) -> "G1":
        return nt.g1_unwire(nt.g1_mul(nt.g1_wire(self), k), G1)

    @staticmethod
    def _encode_affine(aff) -> bytes:
        if aff is None:
            return bytes([0xC0]) + bytes(47)
        x, y = aff
        buf = bytearray(x.to_bytes(48, "big"))
        buf[0] |= 0x80
        if _is_lex_largest_fq(y):
            buf[0] |= 0x20
        return bytes(buf)

    @staticmethod
    def _wire_affine(aff) -> bytes:
        # the native 96-byte x||y wire, all-zero = infinity
        if aff is None:
            return bytes(96)
        return aff[0].to_bytes(48, "big") + aff[1].to_bytes(48, "big")

    @classmethod
    def from_bytes(cls, data: bytes) -> "G1":
        if len(data) != 48:
            raise ValueError("G1 must be 48 bytes compressed")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G1 not supported")
        if flags & 0x40:
            if any(data[1:]) or flags != 0xC0:
                raise ValueError("malformed G1 infinity")
            return cls.infinity()
        x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if x >= F.P:
            raise ValueError("G1 x out of range")
        y = F.fq_sqrt((x**3 + B1) % F.P)
        if y is None:
            raise ValueError("G1 x not on curve")
        if bool(flags & 0x20) != _is_lex_largest_fq(y):
            y = F.P - y
        pt = cls.from_affine((x, y))
        if not pt.in_subgroup():
            raise ValueError("G1 point not in subgroup")
        pt._cbytes = bytes(data)  # strictly validated ⇒ canonical
        return pt


@wire("G2")
class G2(_Point):
    """Point on the twist E'(Fq2): y² = x³ + 4(1+u) (96-byte compressed)."""

    __slots__ = ()
    ops = _fq2_ops
    b = B2

    def is_on_curve(self) -> bool:
        X, Y, Zc = self.jac
        if Zc == F.FQ2_ZERO:
            return True
        z2 = F.fq2_sq(Zc)
        z6 = F.fq2_mul(F.fq2_sq(z2), z2)
        rhs = F.fq2_add(F.fq2_mul(F.fq2_sq(X), X), F.fq2_mul(B2, z6))
        return F.fq2_sq(Y) == rhs

    def _native_mul(self, nt, k: int) -> "G2":
        return nt.g2_unwire(nt.g2_mul(nt.g2_wire(self), k), G2)

    @staticmethod
    def _encode_affine(aff) -> bytes:
        if aff is None:
            return bytes([0xC0]) + bytes(95)
        (x0, x1), y = aff
        buf = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
        buf[0] |= 0x80
        if _is_lex_largest_fq2(y):
            buf[0] |= 0x20
        return bytes(buf)

    @staticmethod
    def _wire_affine(aff) -> bytes:
        # the native 192-byte x.c0||x.c1||y.c0||y.c1 wire
        if aff is None:
            return bytes(192)
        (x0, x1), (y0, y1) = aff
        return b"".join(v.to_bytes(48, "big") for v in (x0, x1, y0, y1))

    @classmethod
    def from_bytes(cls, data: bytes) -> "G2":
        if len(data) != 96:
            raise ValueError("G2 must be 96 bytes compressed")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G2 not supported")
        if flags & 0x40:
            if any(data[1:]) or flags != 0xC0:
                raise ValueError("malformed G2 infinity")
            return cls.infinity()
        x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
        x0 = int.from_bytes(data[48:], "big")
        if x0 >= F.P or x1 >= F.P:
            raise ValueError("G2 x out of range")
        x = (x0, x1)
        y = F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), B2))
        if y is None:
            raise ValueError("G2 x not on curve")
        if bool(flags & 0x20) != _is_lex_largest_fq2(y):
            y = F.fq2_neg(y)
        pt = cls.from_affine((x, y))
        if not pt.in_subgroup():
            raise ValueError("G2 point not in subgroup")
        pt._cbytes = bytes(data)  # strictly validated ⇒ canonical
        return pt


G1_GEN = G1.from_affine((_G1_X, _G1_Y))
G2_GEN = G2.from_affine((_G2_X, _G2_Y))


def g1_multi_exp(points, scalars) -> G1:
    """Σ kᵢ·Pᵢ on the host — native Pippenger when available, naive
    double-and-add otherwise."""
    points = list(points)
    scalars = list(scalars)
    nt = _native()
    if nt is not None and points:
        return nt.g1_unwire(
            nt.g1_msm([nt.g1_wire(p) for p in points], [int(k) % F.R for k in scalars]),
            G1,
        )
    acc = G1.infinity()
    for p, k in zip(points, scalars):
        acc = acc + p * k
    return acc


def g2_multi_exp(points, scalars) -> G2:
    points = list(points)
    scalars = list(scalars)
    nt = _native()
    if nt is not None and points:
        return nt.g2_unwire(
            nt.g2_msm([nt.g2_wire(p) for p in points], [int(k) % F.R for k in scalars]),
            G2,
        )
    acc = G2.infinity()
    for p, k in zip(points, scalars):
        acc = acc + p * k
    return acc
