"""The port's SHA-256 (the plain version of kernel K3 and the byte/word
layout around it) against hashlib and the JAX package, byte for byte."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celestia_tpu.ops import sha256_jax, sha256_pallas
from celestia_tpu_torch.ops import sha256, sha256_cuda

MAX_LEN = 600


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _msg(length, seed):
    return np.random.default_rng(seed).integers(0, 256, size=length, dtype=np.uint8)


@pytest.mark.parametrize("nb", range(1, sha256.padded_length(MAX_LEN) // 64 + 1))
def test_plain_sha_matches_hashlib_every_length(nb):
    """Every message length 0..600, grouped by padded block count so one
    plain compression pass covers every length of a group."""
    lengths = [n for n in range(MAX_LEN + 1) if sha256.padded_length(n) == 64 * nb]
    msgs = [_msg(n, seed=n) for n in lengths]
    words = torch.cat([
        sha256_cuda.message_words(torch.from_numpy(m)[None]) for m in msgs
    ], dim=1)
    assert words.shape == (16 * nb, len(lengths))
    digests = sha256.words_to_bytes(
        sha256_cuda.sha256_words(words).view(torch.int32).T).numpy()
    for m, d in zip(msgs, digests):
        assert d.tobytes() == hashlib.sha256(m.tobytes()).digest()


@pytest.mark.parametrize("length", [0, 55, 56, 64, 65, 91, 181, 542, 600])
def test_sha256_fixed_matches_hashlib(length):
    msgs = np.random.default_rng(length).integers(0, 256, size=(2, 3, length),
                                                  dtype=np.uint8)
    ours = sha256.sha256_fixed(torch.from_numpy(msgs)).numpy()
    assert ours.shape == (2, 3, 32)
    for idx in np.ndindex(2, 3):
        assert ours[idx].tobytes() == hashlib.sha256(msgs[idx].tobytes()).digest()


@pytest.mark.parametrize("nb", [1, 2, 3, 9])
def test_sha256_words_plain_matches_pallas_core(nb):
    words = np.random.default_rng(nb).integers(0, 2**32, size=(16 * nb, 64),
                                               dtype=np.uint32)
    ours = sha256_cuda.sha256_words(torch.from_numpy(words))
    assert ours.dtype == torch.uint32 and ours.shape == (8, 64)
    ref = np.asarray(sha256_pallas.sha_core_reference(jnp.asarray(words)))
    assert np.array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("length", [0, 91, 181, 542])
def test_message_words_matches_pallas_layout(length):
    msgs = np.random.default_rng(length).integers(0, 256, size=(5, length),
                                                  dtype=np.uint8)
    ours = sha256_cuda.message_words(torch.from_numpy(msgs)).numpy()
    assert np.array_equal(ours, np.asarray(sha256_pallas.message_words(jnp.asarray(msgs))))


@pytest.mark.parametrize("length", [0, 1, 55, 56, 119, 542])
def test_padding_matches_jax(length):
    assert sha256.padded_length(length) == sha256_jax.padded_length(length)
    assert np.array_equal(sha256.pad_tail(length), sha256_jax.pad_tail(length))


def test_word_byte_round_trip_matches_jax():
    raw = np.random.default_rng(5).integers(0, 256, size=(3, 64), dtype=np.uint8)
    words = sha256.bytes_to_words(torch.from_numpy(raw))
    assert np.array_equal(words.numpy(), np.asarray(sha256_jax.bytes_to_words(jnp.asarray(raw))))
    back = sha256.words_to_bytes(words).numpy()
    assert np.array_equal(back, raw)
    assert np.array_equal(
        back, np.asarray(sha256_jax.words_to_bytes(jnp.asarray(words.numpy()))))
