"""Batched SHA-256 of equal-length messages: layout helpers and ``sha256_fixed``.

Port of the JAX package's ops/sha256_jax.py. The DA hot loop hashes hundreds
of thousands of independent, equal-length messages per block (NMT leaves over
namespace-prefixed shares, inner nodes over two 90-byte children). Messages
of one batch share one length, so the padding is one constant tail.

PyTorch has no SHA-256, so ``sha256_fixed`` runs the compression through
``sha256_cuda.sha256_words``: kernel K3 on a CUDA tensor, its plain PyTorch
version on a CPU tensor.

Word layout: big-endian 32-bit message words, held as ``torch.uint32``. The
byte <-> word conversions are pure data movement (a byte flip and a dtype
view on the little-endian host and device), so they need none of the
arithmetic that PyTorch does not implement for uint32.
"""

from __future__ import annotations

import numpy as np
import torch

# the round constants and initial state (FIPS 180-4 §4.2.2, §5.3.3)
K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

H0 = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)


def padded_length(msg_len: int) -> int:
    """Total padded byte length for a msg_len-byte message (multiple of 64)."""
    return ((msg_len + 8) // 64 + 1) * 64


def pad_tail(msg_len: int) -> np.ndarray:
    """The constant SHA-256 padding suffix for a msg_len-byte message."""
    total = padded_length(msg_len)
    tail = np.zeros(total - msg_len, dtype=np.uint8)
    tail[0] = 0x80
    bit_len = msg_len * 8
    tail[-8:] = np.frombuffer(int(bit_len).to_bytes(8, "big"), dtype=np.uint8)
    return tail


def bytes_to_words(msg: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 4L) big-endian -> uint32 (..., L)."""
    b = msg.reshape(*msg.shape[:-1], -1, 4).flip(-1).contiguous()
    return b.view(torch.int32).squeeze(-1).view(torch.uint32)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """uint32 (..., L) -> uint8 (..., 4L) big-endian."""
    w = words.view(torch.int32).contiguous()
    b = w.view(torch.uint8).reshape(*w.shape, 4).flip(-1)
    return b.reshape(*w.shape[:-1], 4 * w.shape[-1])


def sha256_fixed(msgs: torch.Tensor, sha_words=None) -> torch.Tensor:
    """SHA-256 of a batch of equal-length messages.

    msgs: uint8 (..., L). Returns uint8 (..., 32). ``sha_words`` is the
    compression over (16·nb, B) padded words; the default is
    ``sha256_cuda.sha256_words`` (K3 on CUDA tensors)."""
    from celestia_tpu_torch.ops import sha256_cuda

    if sha_words is None:
        sha_words = sha256_cuda.sha256_words
    batch_shape = msgs.shape[:-1]
    flat = msgs.reshape(batch_shape.numel(), msgs.shape[-1])
    digests = sha_words(sha256_cuda.message_words(flat))  # (8, B)
    return words_to_bytes(digests.view(torch.int32).T).reshape(*batch_shape, 32)
