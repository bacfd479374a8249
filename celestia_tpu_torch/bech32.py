"""bech32 (BIP-173) encoding — pure python, no key material.

A copy of the JAX package's ``bech32``. ``celestia_tpu_torch.crypto``
re-exports these names unchanged, so key-holding callers import
everything from one place.
"""

from __future__ import annotations

BECH32_HRP = "celestia"

_CHARSET = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"


def _bech32_polymod(values):
    gen = [0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3]
    chk = 1
    for v in values:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            chk ^= gen[i] if ((top >> i) & 1) else 0
    return chk


def _bech32_hrp_expand(hrp):
    return [ord(x) >> 5 for x in hrp] + [0] + [ord(x) & 31 for x in hrp]


def _bech32_create_checksum(hrp, data):
    values = _bech32_hrp_expand(hrp) + data
    polymod = _bech32_polymod(values + [0, 0, 0, 0, 0, 0]) ^ 1
    return [(polymod >> 5 * (5 - i)) & 31 for i in range(6)]


def _convertbits(data, frombits, tobits, pad=True):
    acc = 0
    bits = 0
    ret = []
    maxv = (1 << tobits) - 1
    for value in data:
        acc = (acc << frombits) | value
        bits += frombits
        while bits >= tobits:
            bits -= tobits
            ret.append((acc >> bits) & maxv)
    if pad:
        if bits:
            ret.append((acc << (tobits - bits)) & maxv)
    elif bits >= frombits or ((acc << (tobits - bits)) & maxv):
        raise ValueError("invalid bech32 padding")
    return ret


def bech32_encode(hrp: str, data: bytes) -> str:
    d = _convertbits(data, 8, 5)
    checksum = _bech32_create_checksum(hrp, d)
    return hrp + "1" + "".join(_CHARSET[x] for x in d + checksum)


def bech32_decode(addr: str) -> tuple[str, bytes]:
    if addr.lower() != addr and addr.upper() != addr:
        raise ValueError("mixed-case bech32")
    addr = addr.lower()
    pos = addr.rfind("1")
    if pos < 1 or pos + 7 > len(addr):
        raise ValueError("invalid bech32")
    hrp, rest = addr[:pos], addr[pos + 1 :]
    data = [_CHARSET.find(c) for c in rest]
    if -1 in data:
        raise ValueError("invalid bech32 character")
    if _bech32_polymod(_bech32_hrp_expand(hrp) + data) != 1:
        raise ValueError("invalid bech32 checksum")
    return hrp, bytes(_convertbits(data[:-6], 5, 8, pad=False))
