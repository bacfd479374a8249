"""The port's keys, signatures and addresses, on Python integers, against
the JAX package's (built on the ``cryptography`` wheel): the same keys and
addresses from a secret, signatures that verify on either side, the same
refusals, and RFC 6979 nonces equal to OpenSSL's deterministic ECDSA."""

import hashlib
import os

import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import decode_dss_signature
from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

from celestia_tpu import crypto as jcrypto
from celestia_tpu_torch import crypto as pcrypto
from celestia_tpu_torch.crypto.ripemd160 import ripemd160

N = pcrypto._SECP256K1_N
P = pcrypto._SECP256K1_P


def test_ripemd160_equals_hashlib_at_every_length_to_300():
    """Lengths 0..300 cross every padding edge: 55 (one block), 56 (the
    length spills into a second block), 64 (a whole block), and their
    multiples."""
    r = np.random.default_rng(5)
    for n in range(301):
        data = r.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ripemd160(data) == hashlib.new("ripemd160", data).digest(), n


@pytest.mark.parametrize("data, digest", [
    (b"", "9c1185a5c5e9fc54612808977ee8f548b2258d31"),
    (b"abc", "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"),
    (b"message digest", "5d0689ef49d2fae572b881b123a85ffa21595f36"),
    (b"a" * 1_000_000, "52783243c1697bdbe16d37f97f68f08325dc1528"),
])
def test_ripemd160_published_vectors(data, digest):
    """The test vectors of the RIPEMD-160 paper."""
    assert ripemd160(data).hex() == digest


def test_addresses_never_ask_hashlib_for_ripemd160(monkeypatch):
    """The address is the port's own RIPEMD-160 even where hashlib would
    offer one, so a host whose OpenSSL lacks the legacy provider derives
    the same addresses."""
    real_new = hashlib.new

    def new(name, *args, **kwargs):
        if name.lower().replace("-", "") == "ripemd160":
            raise ValueError("unsupported hash type ripemd160")
        return real_new(name, *args, **kwargs)

    monkeypatch.setattr(hashlib, "new", new)
    key = pcrypto.PrivateKey.from_secret(b"no-openssl-ripemd")
    assert key.address() == ripemd160(hashlib.sha256(key.public_key()).digest())
    monkeypatch.undo()
    assert key.bech32_address() == jcrypto.PrivateKey.from_secret(
        b"no-openssl-ripemd").bech32_address()


def test_from_secret_gives_the_jax_packages_keys_and_addresses():
    for i in range(50):
        secret = hashlib.sha256(b"secret-%d" % i).digest()
        mine, theirs = pcrypto.PrivateKey.from_secret(secret), jcrypto.PrivateKey.from_secret(secret)
        assert mine._key == theirs._key.private_numbers().private_value
        assert mine.public_key() == theirs.public_key()
        assert mine.address() == theirs.address()
        assert mine.bech32_address() == theirs.bech32_address()
        assert pcrypto.bech32_address(mine.public_key()) == jcrypto.bech32_address(
            theirs.public_key())


def test_signatures_verify_on_either_side():
    r = np.random.default_rng(9)
    for i in range(12):
        secret = b"cross-%d" % i
        mine, theirs = pcrypto.PrivateKey.from_secret(secret), jcrypto.PrivateKey.from_secret(secret)
        doc = r.integers(0, 256, int(r.integers(0, 400)), dtype=np.uint8).tobytes()
        pub = mine.public_key()
        assert jcrypto.verify_signature(pub, doc, mine.sign(doc))
        assert pcrypto.verify_signature(pub, doc, theirs.sign(doc))
        assert pcrypto.verify_signature(pub, doc, mine.sign(doc))


def test_signatures_are_deterministic_low_s_rfc6979():
    """The nonce is RFC 6979's: the signature equals OpenSSL's
    deterministic ECDSA over SHA-256, low-S normalised."""
    for i in range(12):
        secret = b"rfc6979-%d" % i
        mine = pcrypto.PrivateKey.from_secret(secret)
        openssl = ec.derive_private_key(mine._key, ec.SECP256K1())
        doc = os.urandom(3 * i)
        sig = mine.sign(doc)
        assert sig == mine.sign(doc)
        s = int.from_bytes(sig[32:], "big")
        assert 0 < s <= N // 2
        r_ref, s_ref = decode_dss_signature(
            openssl.sign(doc, ec.ECDSA(hashes.SHA256(), deterministic_signing=True)))
        assert sig == r_ref.to_bytes(32, "big") + min(s_ref, N - s_ref).to_bytes(32, "big")


def test_rfc6979_published_secp256k1_vector():
    """Key 1, message "Satoshi Nakamoto": the r of the widely published
    deterministic-nonce vector, and its s made low."""
    sig = pcrypto.PrivateKey(1).sign(b"Satoshi Nakamoto")
    assert sig.hex() == (
        "934b1ea10a4b3c1757e2b0c017d0b6143ce3c9a7e6a4a49860d7a6ab210ee3d8"
        "2442ce9d2b916064108014783e923ec36b49743e2ffa1c4496f01a512aafd9e5")


def test_generate_draws_a_valid_key():
    key = pcrypto.PrivateKey.generate()
    assert 1 <= key._key < N
    assert len(key.public_key()) == 33
    assert pcrypto.verify_signature(key.public_key(), b"doc", key.sign(b"doc"))


KEY = pcrypto.PrivateKey.from_secret(b"refusals")
DOC = b"the sign doc"
SIG = KEY.sign(DOC)
R, S = int.from_bytes(SIG[:32], "big"), int.from_bytes(SIG[32:], "big")
PUB = KEY.public_key()
UNCOMPRESSED = ec.derive_private_key(KEY._key, ec.SECP256K1()).public_key().public_bytes(
    Encoding.X962, PublicFormat.UncompressedPoint)


def _sig(r: int, s: int) -> bytes:
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def _flip(b: bytes, bit: int) -> bytes:
    out = bytearray(b)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def _off_curve_x() -> int:
    """The least x with no curve point (x^3 + 7 not a square mod p)."""
    x = 1
    while pow((x ** 3 + 7) % P, (P - 1) // 2, P) == 1:
        x += 1
    return x


REFUSALS = {
    "short signature": (PUB, DOC, SIG[:63]),
    "long signature": (PUB, DOC, SIG + b"\x00"),
    "empty signature": (PUB, DOC, b""),
    "high s": (PUB, DOC, _sig(R, N - S)),
    "r zero": (PUB, DOC, _sig(0, S)),
    "s zero": (PUB, DOC, _sig(R, 0)),
    "r equal to n": (PUB, DOC, _sig(N, S)),
    "r above n": (PUB, DOC, _sig(N + 1, S)),
    "s equal to n": (PUB, DOC, _sig(R, N)),
    "s all ones": (PUB, DOC, _sig(R, (1 << 256) - 1)),
    "wrong message": (PUB, DOC + b"!", SIG),
    "one bit of r flipped": (PUB, DOC, _flip(SIG, 3)),
    "one bit of s flipped": (PUB, DOC, _flip(SIG, 300)),
    "another key": (pcrypto.PrivateKey.from_secret(b"other").public_key(), DOC, SIG),
    "empty pubkey": (b"", DOC, SIG),
    "pubkey prefix 05": (b"\x05" + PUB[1:], DOC, SIG),
    "pubkey prefix 00": (b"\x00" + PUB[1:], DOC, SIG),
    "compressed pubkey too short": (PUB[:32], DOC, SIG),
    "compressed pubkey too long": (PUB + b"\x00", DOC, SIG),
    "uncompressed prefix on 33 bytes": (b"\x04" + PUB[1:], DOC, SIG),
    "compressed prefix on 65 bytes": (b"\x02" + UNCOMPRESSED[1:], DOC, SIG),
    "x off the curve": (b"\x02" + _off_curve_x().to_bytes(32, "big"), DOC, SIG),
    "x equal to p": (b"\x02" + P.to_bytes(32, "big"), DOC, SIG),
    "uncompressed y wrong": (UNCOMPRESSED[:64] + bytes([UNCOMPRESSED[64] ^ 1]), DOC, SIG),
    "uncompressed x equal to p": (b"\x04" + P.to_bytes(32, "big") + UNCOMPRESSED[33:], DOC, SIG),
    "other parity": (bytes([PUB[0] ^ 1]) + PUB[1:], DOC, SIG),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_are_false_on_both_sides(case):
    pub, doc, sig = REFUSALS[case]
    assert jcrypto.verify_signature(pub, doc, sig) is False
    assert pcrypto.verify_signature(pub, doc, sig) is False


def test_the_uncompressed_key_verifies_on_both_sides():
    """The 65-byte SEC1 form is a valid point, which cryptography's
    from_encoded_point accepts, so the port accepts it too."""
    assert len(UNCOMPRESSED) == 65 and UNCOMPRESSED[0] == 4
    assert jcrypto.verify_signature(UNCOMPRESSED, DOC, SIG) is True
    assert pcrypto.verify_signature(UNCOMPRESSED, DOC, SIG) is True
    assert pcrypto._decode_point(UNCOMPRESSED) == pcrypto._decode_point(PUB)
