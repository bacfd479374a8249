"""The port's main path (square -> EDS -> NMT roots -> DAH) and its da
module, byte for byte against the JAX package and the reference oracles.

The JAX side runs as its own tests run it on the CPU: the jitted host
entries of ops/extend_tpu on XLA:CPU. The port runs with device="cpu",
where the kernel wrappers take their plain PyTorch versions.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu import namespace as jax_ns
from celestia_tpu import shares as jax_shares
from celestia_tpu.ops import extend_tpu
from celestia_tpu.ops import nmt_host as jax_nmt_host
from celestia_tpu_torch import da
from celestia_tpu_torch import namespace as ns
from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.ops import extend, nmt_host

SMALL_K = [1, 2, 4, 8, 16]
# (k, tail-padding shares): the five sizes, plus a square whose content does
# not fill k², so Q0 carries TAIL_PADDING namespaces after real ones
CASES = [(k, 0) for k in SMALL_K] + [(4, 5)]

# pkg/da/data_availability_header_test.go:28, :44, :50
MIN_DAH = "3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353"
TYPICAL_DAH = "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"
MAX_DAH = "0bd3abeeacfbb0b92dfbdac4a154868e3c4e79666f7fcf6c620bb90dd3a0dcf0"
PARITY = ns.PARITY_SHARES_NAMESPACE.bytes


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def square(k: int, seed: int = 42, pad_tail: int = 0) -> np.ndarray:
    """Valid k×k Q0: sorted v0 namespaces over random bytes; the last
    `pad_tail` shares carry TAIL_PADDING_NAMESPACE."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 256, size=(k * k, SHARE_SIZE), dtype=np.uint8)
    body = k * k - pad_tail
    subs = sorted(rng.integers(0, 200, size=(body, 10), dtype=np.uint8).tolist())
    for i, sub in enumerate(subs):
        flat[i, :NAMESPACE_SIZE] = np.frombuffer(ns.new_v0(bytes(sub)).bytes, np.uint8)
    for i in range(body, k * k):
        flat[i, :NAMESPACE_SIZE] = np.frombuffer(ns.TAIL_PADDING_NAMESPACE.bytes, np.uint8)
    return flat.reshape(k, k, SHARE_SIZE)


@functools.lru_cache(maxsize=None)
def jax_extend_and_root(k: int, pad_tail: int):
    return extend_tpu.extend_and_root_device(square(k, pad_tail=pad_tail))


def oracle_shares(count: int) -> list[bytes]:
    """data_availability_header_test.go:218-231: one v0 share, repeated."""
    ns1 = ns.new_v0(b"\x01" * ns.NAMESPACE_VERSION_ZERO_ID_SIZE)
    return [ns1.bytes + b"\xff" * (SHARE_SIZE - NAMESPACE_SIZE)] * count


@pytest.mark.parametrize("k,pad_tail", CASES)
def test_extend_and_root_device_matches_jax(k, pad_tail):
    eds, rows, cols, dah = extend.extend_and_root_device(
        square(k, pad_tail=pad_tail), device="cpu")
    j_eds, j_rows, j_cols, j_dah = jax_extend_and_root(k, pad_tail)
    assert eds.shape == (2 * k, 2 * k, SHARE_SIZE)
    assert rows.shape == cols.shape == (2 * k, extend.NMT_NODE_SIZE)
    assert np.array_equal(eds, j_eds)
    assert np.array_equal(rows, j_rows)
    assert np.array_equal(cols, j_cols)
    assert np.array_equal(dah, j_dah)


@pytest.mark.parametrize("k,pad_tail", CASES)
def test_extend_roots_device_entries_match_jax(k, pad_tail):
    sq = square(k, pad_tail=pad_tail)
    j_eds, j_rows, j_cols, _ = jax_extend_and_root(k, pad_tail)
    eds, rows, cols = extend.extend_roots_device(sq, device="cpu")
    assert np.array_equal(eds, j_eds)
    assert np.array_equal(rows, j_rows) and np.array_equal(cols, j_cols)
    eds_t, rows, cols = extend.extend_roots_device_resident(sq, device="cpu")
    assert isinstance(eds_t, torch.Tensor)
    assert np.array_equal(eds_t.numpy(), j_eds)
    assert np.array_equal(rows, j_rows) and np.array_equal(cols, j_cols)


@pytest.mark.parametrize("k,pad_tail", CASES)
def test_eds_roots_device_matches_jax(k, pad_tail):
    j_eds, j_rows, j_cols, _ = jax_extend_and_root(k, pad_tail)
    rows, cols = extend.eds_roots_device(j_eds, device="cpu")
    assert np.array_equal(rows, j_rows) and np.array_equal(cols, j_cols)


@pytest.mark.parametrize("k,pad_tail", CASES)
def test_da_matches_jax_host_da(k, pad_tail):
    sq = square(k, pad_tail=pad_tail)
    eds = da.extend_shares(sq.reshape(k * k, SHARE_SIZE), device="cpu")
    dah = da.new_data_availability_header(eds)
    j_eds = jax_da.extend_shares(sq.reshape(k * k, SHARE_SIZE))
    j_dah = jax_da.new_data_availability_header(j_eds)
    assert np.array_equal(eds.data, j_eds.data)
    assert dah.row_roots == j_dah.row_roots
    assert dah.column_roots == j_dah.column_roots
    assert dah.hash() == j_dah.hash()
    assert dah.square_size() == k


def test_min_dah_oracle():
    dah = da.min_data_availability_header(device="cpu")
    assert dah.hash().hex() == MIN_DAH
    dah.validate_basic()
    assert da.tail_padding_share() == jax_shares.tail_padding_share().to_bytes()


def test_typical_dah_oracle():
    dah = da.new_data_availability_header(da.extend_shares(oracle_shares(4), device="cpu"))
    assert len(dah.row_roots) == len(dah.column_roots) == 4
    assert dah.hash().hex() == TYPICAL_DAH


def test_typical_dah_device_hash_equals_host_hash():
    sq = np.frombuffer(b"".join(oracle_shares(4)), np.uint8).reshape(2, 2, SHARE_SIZE)
    _eds, rows, cols, dah = extend.extend_and_root_device(sq, device="cpu")
    host = da.DataAvailabilityHeader([r.tobytes() for r in rows],
                                     [c.tobytes() for c in cols])
    assert dah.tobytes() == host.hash()
    assert host.hash().hex() == TYPICAL_DAH


@pytest.mark.slow
def test_max_dah_oracle():
    dah = da.new_data_availability_header(
        da.extend_shares(oracle_shares(128 * 128), device="cpu"))
    assert len(dah.row_roots) == len(dah.column_roots) == 256
    assert dah.hash().hex() == MAX_DAH


@pytest.mark.slow
@pytest.mark.parametrize("k", [32, 64, 128])
def test_extend_and_root_device_matches_jax_large(k):
    sq = square(k)
    ours = extend.extend_and_root_device(sq, device="cpu")
    theirs = extend_tpu.extend_and_root_device(sq)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_dah_json_round_trip_and_validation():
    dah = da.min_data_availability_header(device="cpu")
    back = da.DataAvailabilityHeader.from_json(dah.to_json())
    assert back == dah and back.hash() == dah.hash()
    assert dah.to_json() == jax_da.min_data_availability_header().to_json()
    with pytest.raises(ValueError):
        da.DataAvailabilityHeader(dah.row_roots, dah.column_roots[:1]).validate_basic()
    with pytest.raises(ValueError):
        da.DataAvailabilityHeader(dah.row_roots[:1], dah.column_roots[:1]).validate_basic()
    assert da.nil_dah_hash() == hashlib.sha256(b"").digest() == jax_da.nil_dah_hash()


def test_extend_shares_rejects_malformed_input():
    with pytest.raises(ValueError):
        da.extend_shares(oracle_shares(3), device="cpu")
    with pytest.raises(ValueError):
        da.extend_shares(np.zeros((4, SHARE_SIZE), np.int32), device="cpu")
    with pytest.raises(ValueError):
        extend.roots_device(np.zeros((2, 3, SHARE_SIZE), np.uint8), device="cpu")


def test_eds_data_setter_drops_device_copy_and_roots():
    eds = da.extend_shares(oracle_shares(4), device="cpu")
    assert eds.device_data is not None
    before = eds.row_roots()
    data = eds.data.copy()
    data[0, 0, 40] ^= 1  # a byte past the namespace
    eds.data = data
    assert eds.device_data is None
    assert eds.row_roots()[0] != before[0]
    assert eds.row_roots()[1:] == before[1:]


# ---- the two-branch max-namespace rule against the general host hasher
# (the adversarial vectors of tests/test_nmt_semantics.py)


def mk_ns(b: int) -> bytes:
    return bytes(NAMESPACE_SIZE - 1) + bytes([b])


def _port_row_root(ns_row: list[bytes], data: list[bytes]) -> bytes:
    leaf_ns = torch.from_numpy(np.stack([np.frombuffer(n, np.uint8) for n in ns_row]))
    cells = torch.from_numpy(np.stack([np.frombuffer(d, np.uint8) for d in data]))
    return bytes(extend.nmt_reduce_axis(extend.nmt_leaf_nodes(leaf_ns, cells)).numpy())


def _agree(ns_row, data):
    leaves = [n + d for n, d in zip(ns_row, data)]
    root = _port_row_root(ns_row, data)
    assert root == nmt_host.nmt_root(leaves) == jax_nmt_host.nmt_root(leaves)
    return root


def test_max_ns_leaf_in_q0_matches_general_hasher():
    k = 4
    data = [bytes([i] * (SHARE_SIZE - NAMESPACE_SIZE)) for i in range(2 * k)]
    _agree([mk_ns(1), mk_ns(2), mk_ns(3), PARITY] + [PARITY] * k, data)


def test_all_parity_row_matches():
    k = 4
    data = [bytes([7 + i] * (SHARE_SIZE - NAMESPACE_SIZE)) for i in range(2 * k)]
    root = _agree([PARITY] * (2 * k), data)
    assert root[:NAMESPACE_SIZE] == root[NAMESPACE_SIZE:2 * NAMESPACE_SIZE] == PARITY


def test_honest_row_shape_matches():
    k = 8
    data = [bytes([i] * (SHARE_SIZE - NAMESPACE_SIZE)) for i in range(2 * k)]
    _agree([mk_ns(i + 1) for i in range(k)] + [PARITY] * k, data)


@pytest.mark.parametrize("seed", range(6))
def test_reduce_once_matches_hash_node_on_ordered_pairs(seed):
    """One level of the port's _nmt_reduce_once against nmt_host.hash_node
    on random ordered sibling pairs, parity-valued children included."""
    rng = np.random.default_rng(1234 + seed)
    nodes = []
    for _ in range(8):
        lo, hi = sorted(int(b) for b in rng.integers(1, 200, size=2))
        left_min, left_max = mk_ns(lo), mk_ns(hi)
        right_kind = rng.integers(0, 3)
        if right_kind == 0:
            right_min = right_max = PARITY
        elif right_kind == 1:
            right_min, right_max = mk_ns(hi), PARITY
        else:
            right_min, right_max = mk_ns(hi), mk_ns(int(rng.integers(hi, 256)))
        dig = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(2)]
        nodes += [left_min + left_max + dig[0], right_min + right_max + dig[1]]
    arr = torch.from_numpy(np.stack([np.frombuffer(n, np.uint8) for n in nodes]))
    out = extend._nmt_reduce_once(arr).numpy()
    for i in range(8):
        expect = jax_nmt_host.hash_node(nodes[2 * i], nodes[2 * i + 1])
        assert out[i].tobytes() == expect == nmt_host.hash_node(nodes[2 * i], nodes[2 * i + 1])


def test_namespace_copy_matches_jax():
    for name in ("TX_NAMESPACE", "PAY_FOR_BLOB_NAMESPACE", "TAIL_PADDING_NAMESPACE",
                 "PARITY_SHARES_NAMESPACE", "PRIMARY_RESERVED_PADDING_NAMESPACE"):
        assert getattr(ns, name).bytes == getattr(jax_ns, name).bytes
    assert ns.new_v0(b"\x07" * 10).bytes == jax_ns.new_v0(b"\x07" * 10).bytes
    with pytest.raises(ValueError):
        ns.new_v0(b"\x00" * 11)
