"""Kernel K3: batched SHA-256 over padded message words, batch on the lanes.

Replaces the Pallas kernel ``sha256_words`` of the JAX package
(celestia_tpu/ops/sha256_pallas.py:129, ``pallas_call`` at :112). Source:
``csrc/sha256_words.cu``, sharing ``csrc/sha256.cuh`` with K1 and K2.

Layout contract (the Pallas one): ``sha256_words(words)`` takes big-endian
message words transposed to (16·nb, B) uint32 — column b is message b — and
returns (8, B) uint32 digest words. One CUDA thread hashes one message; word
row w is read at ``words[w, lane]``, so a warp's loads coalesce.

The tree kernel (``ops/nmt_cuda.py``, ``csrc/nmt_tree.cu``) carries every
NMT inner-node level and the merkle kernel (``ops/merkle_cuda.py``,
``csrc/dah_merkle.cu``) the device DAH, so no entry's path runs K3; it
serves ``sha256.sha256_fixed`` on CUDA tensors. PyTorch has no SHA-256 of
its own, so this kernel has no library counterpart.

What bounds it on the H100: integer ALU work. A 64-byte block compiles to
1,265 operations on the ALU pipe (SHF, LOP3, IADD3) and 118 IMAD on the FMA
pipe for sm_90a (nvcc 12.8; ``chip_smoke.py`` counts them from the SASS of
this kernel's block loop, ``csrc/sha256_words.cu``), against 64 INT32 lanes
× 132 SMs × 1.98 GHz (the Hopper white paper's SM layout); the bytes (64 in,
32 out per message) are far below the 3.35 TB/s line. A small launch is
bound instead by one warp's chain of its blocks. The design keeps the whole
compression in registers (the 16-word schedule window and the 8 state
words, rounds fully unrolled, rotates on ``__funnelshift_r``).
"""

from __future__ import annotations

import functools
from typing import List

import torch

from celestia_tpu_torch.ops import _cuda
from celestia_tpu_torch.ops.sha256 import H0, K, bytes_to_words, pad_tail

_M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32, by way of a wrapping int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(torch.uint32)


def _core(w_all: torch.Tensor, k: List[int], h0: List[int]) -> torch.Tensor:
    """The compression of every block: int64 words in [0, 2^32), (16·nb, B)
    -> the (8, B) state. PyTorch implements only ``& | ^`` for uint32, so
    the arithmetic runs in int64, masked to 32 bits after every sum."""
    m32 = 0xFFFFFFFF  # a literal: TorchScript reads no module global
    nb = w_all.shape[0] // 16
    batch = w_all.shape[1]
    state = [torch.full((batch,), h, dtype=torch.int64, device=w_all.device) for h in h0]
    for blk in range(nb):
        w = [w_all[blk * 16 + i] for i in range(16)]
        for t in range(16, 64):
            wm15 = w[t - 15]
            wm2 = w[t - 2]
            s0 = _rotr(wm15, 7) ^ _rotr(wm15, 18) ^ (wm15 >> 3)
            s1 = _rotr(wm2, 17) ^ _rotr(wm2, 19) ^ (wm2 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & m32)
        a, b, c, d = state[0], state[1], state[2], state[3]
        e, f, g, h = state[4], state[5], state[6], state[7]
        for t in range(64):
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ ((e ^ m32) & g)
            t1 = (h + s1 + ch + k[t] + w[t]) & m32
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = (s0 + maj) & m32
            a, b, c, d, e, f, g, h = (t1 + t2) & m32, a, b, c, (d + t1) & m32, e, f, g
        rounds = [a, b, c, d, e, f, g, h]
        state = [(state[i] + rounds[i]) & m32 for i in range(8)]
    return torch.stack(state)


_K = [int(v) for v in K]
_H0 = [int(v) for v in H0]


@functools.lru_cache(maxsize=1)
def _core_script():
    """``_core`` as one TorchScript function, for CPU tensors. Eager, each of
    its ~3,300 operations a block releases and retakes the interpreter lock,
    so in a process whose other threads want the lock (a node's request
    threads, a scenario's load) each retake waits a switch interval and the
    hash starves; the scripted call releases it once. The operations are
    ``_core``'s, and the JIT fuses nothing on the CPU."""
    return torch.jit.script(_core)


def sha_core_reference(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: (16·nb, B) uint32 -> (8, B) uint32. On a
    CPU tensor ``_core`` runs scripted (``_core_script``), on a CUDA tensor
    eagerly."""
    w_all = words.view(torch.int32).to(torch.int64) & _M32
    core = _core_script() if words.device.type == "cpu" else _core
    return _to_u32(core(w_all, _K, _H0))


def sha256_words(words: torch.Tensor) -> torch.Tensor:
    """(16·nb, B) uint32 padded message words -> (8, B) uint32 digest words.

    A CPU tensor runs the plain version; a CUDA tensor launches K3."""
    if words.device.type == "cpu":
        return sha_core_reference(words)
    wlen, batch = words.shape
    if wlen == 0 or wlen % 16:
        raise ValueError(f"word rows must be a positive multiple of 16, got {wlen}")
    _cuda.require(words, "words", torch.uint32, (wlen, batch), words.device)
    out = torch.empty((8, batch), dtype=torch.uint32, device=words.device)
    if batch == 0:
        return out
    lib = _cuda.library()
    rc = lib.celestia_sha256_words(
        words.data_ptr(), out.data_ptr(), wlen // 16, batch,
        words.device.index or 0, _cuda.stream_of(words))
    _cuda.check(rc, "sha256_words")
    _cuda.LAUNCHES["sha256_words"] += 1
    return out


def message_words(msgs: torch.Tensor) -> torch.Tensor:
    """The kernel's input layout in one place: uint8 (B, L) messages ->
    (16·nb, B) big-endian padded words, lanes = batch."""
    tail = torch.as_tensor(pad_tail(msgs.shape[-1]), device=msgs.device)
    padded = torch.cat([msgs, tail.expand(msgs.shape[0], tail.shape[0])], dim=-1)
    words = bytes_to_words(padded)  # (B, 16·nb)
    return words.view(torch.int32).T.contiguous().view(torch.uint32)
