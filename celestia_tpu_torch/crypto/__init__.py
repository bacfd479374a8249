"""Keys, signatures, addresses.

The reference inherits secp256k1 ECDSA keys and bech32 account addresses
from the Cosmos SDK (pkg/user/signer.go signs SIGN_MODE_DIRECT with a
secp256k1 keyring key; addresses are bech32("celestia",
ripemd160(sha256(compressed_pubkey)))). The JAX package builds these on
the ``cryptography`` wheel; the port computes them on Python integers and
needs no wheel: the same keys, addresses and cosmos-compatible low-S,
64-byte (r ‖ s) signatures, with the nonce from RFC 6979 (HMAC-SHA256), so
a key signs a message the same way every time. Any valid low-S signature
verifies here and under the JAX package alike.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import secrets

# bech32 (BIP-173) lives in celestia_tpu_torch.bech32; re-exported here so
# key-holding callers keep importing everything from one place.
from celestia_tpu_torch.bech32 import (  # noqa: F401
    BECH32_HRP,
    bech32_decode,
    bech32_encode,
)
from celestia_tpu_torch.crypto.ripemd160 import ripemd160

# secp256k1 (SEC 2 §2.4.1): y^2 = x^3 + 7 over F_p, base point G of order n
_SECP256K1_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
_SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# a point in Jacobian coordinates (X, Y, Z) stands for (X/Z^2, Y/Z^3);
# Z = 0 is the point at infinity
_INFINITY = (1, 1, 0)
_G = (_GX, _GY, 1)


def _double(pt: tuple[int, int, int]) -> tuple[int, int, int]:
    """2·pt (dbl-2009-l, for a = 0)."""
    p = _SECP256K1_P
    x1, y1, z1 = pt
    if z1 == 0 or y1 == 0:
        return _INFINITY
    a = x1 * x1 % p
    b = y1 * y1 % p
    c = b * b % p
    d = 2 * ((x1 + b) * (x1 + b) - a - c) % p
    e = 3 * a % p
    x3 = (e * e - 2 * d) % p
    return x3, (e * (d - x3) - 8 * c) % p, 2 * y1 * z1 % p


def _add(p1: tuple[int, int, int], p2: tuple[int, int, int]) -> tuple[int, int, int]:
    """p1 + p2 (add-2007-bl), doubling where the two are one point."""
    p = _SECP256K1_P
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % p
    z2z2 = z2 * z2 % p
    u1 = x1 * z2z2 % p
    u2 = x2 * z1z1 % p
    s1 = y1 * z2 * z2z2 % p
    s2 = y2 * z1 * z1z1 % p
    if u1 == u2:
        return _double(p1) if s1 == s2 else _INFINITY
    h = u2 - u1
    i = 4 * h * h % p
    j = h * i % p
    r = 2 * (s2 - s1) % p
    v = u1 * i % p
    x3 = (r * r - j - 2 * v) % p
    y3 = (r * (v - x3) - 2 * s1 * j) % p
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % p
    return x3, y3, z3


def _affine(pt: tuple[int, int, int]) -> tuple[int, int] | None:
    """(x, y), or None for the point at infinity."""
    p = _SECP256K1_P
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, -1, p)
    zi2 = zi * zi % p
    return x * zi2 % p, y * zi2 * zi % p


def _mul_add(a: int, pa: tuple[int, int, int], b: int = 0,
             pb: tuple[int, int, int] = _INFINITY) -> tuple[int, int, int]:
    """a·pa + b·pb in one left-to-right pass over the bits of both
    scalars (Shamir's trick): one doubling a bit, one addition where
    either bit is set."""
    both = _add(pa, pb)
    acc = _INFINITY
    for i in range(max(a.bit_length(), b.bit_length()) - 1, -1, -1):
        acc = _double(acc)
        bits = (a >> i & 1, b >> i & 1)
        if bits == (1, 1):
            acc = _add(acc, both)
        elif bits == (1, 0):
            acc = _add(acc, pa)
        elif bits == (0, 1):
            acc = _add(acc, pb)
    return acc


def _decode_point(encoded: bytes) -> tuple[int, int, int]:
    """A SEC1 public key (33-byte compressed 02/03, or 65-byte
    uncompressed 04) as a Jacobian point; ValueError unless it is a point
    on the curve with coordinates below p."""
    p = _SECP256K1_P
    encoded = bytes(encoded)
    if len(encoded) == 33 and encoded[0] in (2, 3):
        x = int.from_bytes(encoded[1:], "big")
        if x >= p:
            raise ValueError("point coordinate out of range")
        rhs = (x * x * x + 7) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p != rhs:
            raise ValueError("x is not the coordinate of a curve point")
        if y & 1 != encoded[0] & 1:
            y = p - y
        return x, y, 1
    if len(encoded) == 65 and encoded[0] == 4:
        x = int.from_bytes(encoded[1:33], "big")
        y = int.from_bytes(encoded[33:], "big")
        if x >= p or y >= p or (y * y - x * x * x - 7) % p:
            raise ValueError("not a point on secp256k1")
        return x, y, 1
    raise ValueError("invalid SEC1 point encoding")


def _compressed(pt: tuple[int, int, int]) -> bytes:
    x, y = _affine(pt)
    return bytes([2 | y & 1]) + x.to_bytes(32, "big")


def _rfc6979_nonces(secret: int, digest: bytes):
    """RFC 6979 §3.2's candidate nonces for a 256-bit key and SHA-256
    digest, in order (HMAC-SHA256 as the PRF)."""
    n = _SECP256K1_N
    bx = secret.to_bytes(32, "big") + (int.from_bytes(digest, "big") % n).to_bytes(32, "big")
    k = b"\x00" * 32
    v = b"\x01" * 32
    k = hmac.new(k, v + b"\x00" + bx, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + bx, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < n:
            yield cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


# --- secp256k1 keys ---


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def address_from_pubkey(compressed_pubkey: bytes) -> bytes:
    """20-byte account address = ripemd160(sha256(pubkey))."""
    return ripemd160(_sha256(compressed_pubkey))


def bech32_address(compressed_pubkey: bytes, hrp: str = BECH32_HRP) -> str:
    return bech32_encode(hrp, address_from_pubkey(compressed_pubkey))


@dataclasses.dataclass
class PrivateKey:
    _key: int  # the secret scalar, in [1, n - 1]

    @classmethod
    def generate(cls) -> "PrivateKey":
        return cls(secrets.randbelow(_SECP256K1_N - 1) + 1)

    @classmethod
    def from_secret(cls, secret: bytes) -> "PrivateKey":
        """Deterministic key from a 32-byte secret (test fixtures)."""
        return cls(int.from_bytes(_sha256(secret), "big") % (_SECP256K1_N - 1) + 1)

    def public_key(self) -> bytes:
        """33-byte compressed SEC1 public key."""
        return _compressed(_mul_add(self._key, _G))

    def address(self) -> bytes:
        return address_from_pubkey(self.public_key())

    def bech32_address(self) -> str:
        return bech32_address(self.public_key())

    def sign(self, msg: bytes) -> bytes:
        """64-byte (r ‖ s) signature over sha256(msg), low-S normalized."""
        n = _SECP256K1_N
        digest = _sha256(msg)
        e = int.from_bytes(digest, "big")
        for k in _rfc6979_nonces(self._key, digest):
            r = _affine(_mul_add(k, _G))[0] % n
            if r == 0:
                continue
            s = pow(k, -1, n) * (e + r * self._key) % n
            if s == 0:
                continue
            if s > n // 2:
                s = n - s
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def verify_signature(compressed_pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    n = _SECP256K1_N
    if len(sig) != 64:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if s > n // 2:  # reject malleable high-S signatures
        return False
    if not (0 < r < n and 0 < s < n):
        return False
    try:
        q = _decode_point(compressed_pubkey)
    except ValueError:
        return False
    w = pow(s, -1, n)
    e = int.from_bytes(_sha256(msg), "big")
    xy = _affine(_mul_add(e * w % n, _G, r * w % n, q))
    return xy is not None and xy[0] % n == r
