"""The port's proofs (celestia_tpu_torch/proof) against the JAX package's
proof module.

For each k from 1 to 16, one square (sorted v0 namespaces over random bytes,
made with numpy from a seed) is extended by the port on the CPU. The port's
row levels (``extend.eds_row_levels_device(device="cpu")``) equal the JAX
package's; the port's provers, host-built and seeded from those levels,
give the JAX provers' roots and proofs byte for byte; ``das_sample_docs``
gives the JAX documents; every proof verifies against the port's DAH row
roots and fails for a changed share; and every ValueError the JAX module
raises, the port raises. The Merkle, absence, share and tx inclusion
proofs (squares built from the same txs by both packages, the port's
extended on the CPU) equal the JAX proofs and verify against the DAH.
"""

import functools

import numpy as np
import pytest

from celestia_tpu import blob as jax_blob
from celestia_tpu import da as jax_da
from celestia_tpu import namespace as jax_ns
from celestia_tpu import proof as jax_proof
from celestia_tpu import square as jax_square
from celestia_tpu.shares import to_bytes as jax_to_bytes
from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch import da, proof
from celestia_tpu_torch import square as square_pkg
from celestia_tpu_torch import namespace as ns_pkg
from celestia_tpu_torch.ops import extend
from celestia_tpu_torch.ops.nmt_host import merkle_root, nmt_root
from celestia_tpu_torch.shares import to_bytes
from celestia_tpu_torch.shares.splitters import Range
from tests.test_torch_extend import square

KS = [1, 2, 4, 8, 16]


@functools.lru_cache(maxsize=None)
def eds_of(k: int) -> np.ndarray:
    return extend.extend_roots_device(square(k, seed=100 + k), device="cpu")[0]


@functools.lru_cache(maxsize=None)
def levels_of(k: int):
    return extend.eds_row_levels_device(eds_of(k), device="cpu")


def cells(eds: np.ndarray, i: int) -> list[bytes]:
    return [eds[i, j].tobytes() for j in range(eds.shape[0])]


def test_erasured_leaves_equal_jax():
    eds = eds_of(4)
    for i in range(8):
        row = cells(eds, i)
        assert da.erasured_axis_leaves(row, i, 4) == jax_da.erasured_axis_leaves(row, i, 4)
        for j in (0, 3, 4, 7):
            assert da.erasured_leaf_namespace(i, j, row[j], 4) == \
                jax_da.erasured_leaf_namespace(i, j, row[j], 4)
    assert da.PARITY_NS == jax_da.PARITY_NS


@pytest.mark.parametrize("k", KS)
def test_row_levels_equal_jax(k):
    ours = levels_of(k)
    theirs = extend_tpu.eds_row_levels_device(eds_of(k))
    assert len(ours) == len(theirs) == (2 * k).bit_length()
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))


def ranges(w: int) -> list[tuple[int, int]]:
    out = [(j, j + 1) for j in range(w)] + [(0, w)]
    if w > 2:
        out += [(1, w - 1), (w // 2 - 1, w // 2 + 1), (0, w // 2), (w // 2, w)]
    return out


def nodes_of(p) -> tuple:
    return (p.start, p.end, tuple(p.nodes), p.tree_size)


@pytest.mark.parametrize("k", KS)
def test_provers_equal_jax(k):
    eds = eds_of(k)
    w = 2 * k
    levels = levels_of(k)
    for i in sorted({0, k - 1, k, w - 1}):
        leaves = da.erasured_axis_leaves(cells(eds, i), i, k)
        ours = proof.NmtRowProver(leaves)
        theirs = jax_proof.NmtRowProver(leaves)
        seeded = proof.NmtRowProver.from_node_levels([lv[i] for lv in levels])
        jax_seeded = jax_proof.NmtRowProver.from_node_levels([lv[i] for lv in levels])
        assert ours.root() == theirs.root() == seeded.root() == jax_seeded.root()
        assert ours.tree_size == seeded.tree_size == w
        for start, end in ranges(w):
            want = nodes_of(theirs.prove_range(start, end))
            assert nodes_of(ours.prove_range(start, end)) == want
            assert nodes_of(seeded.prove_range(start, end)) == want
            assert nodes_of(proof.nmt_prove_range(leaves, start, end)) == \
                nodes_of(jax_proof.nmt_prove_range(leaves, start, end)) == want


@pytest.mark.parametrize("k", KS)
def test_das_sample_docs_equal_jax_and_verify(k):
    eds = eds_of(k)
    w = 2 * k
    rng = np.random.default_rng(k)
    coords = [(int(i), int(j)) for i, j in rng.integers(w, size=(12, 2))]
    coords += [coords[0], (0, 0), (w - 1, w - 1)]  # a duplicate and the corners
    rows = {i: cells(eds, i) for i, _j in coords}
    theirs = jax_proof.das_sample_docs(rows, coords, k)
    assert proof.das_sample_docs(rows, coords, k) == theirs
    levels = levels_of(k)
    seeded = {i: proof.NmtRowProver.from_node_levels([lv[i] for lv in levels]) for i in rows}
    assert proof.das_sample_docs(rows, coords, k, provers=seeded) == theirs
    memo: dict = {}
    assert proof.das_sample_docs(rows, coords, k, provers=memo) == theirs
    assert sorted(memo) == sorted(rows)  # the host-built provers are kept
    row_roots = da.ExtendedDataSquare(eds, k, "cpu").row_roots()
    for (i, j), doc in zip(coords, theirs):
        share = bytes.fromhex(doc["share"])
        p = doc["proof"]
        pr = proof.NmtRangeProof(p["start"], p["end"], [bytes.fromhex(x) for x in p["nodes"]],
                                 p["tree_size"])
        ns = da.erasured_leaf_namespace(i, j, share, k)
        pr.verify_inclusion(row_roots[i], [ns], [share])
        bad = bytes([share[-1] ^ 1])
        with pytest.raises(ValueError):
            pr.verify_inclusion(row_roots[i], [ns], [share[:-1] + bad])


def _leaves():
    eds = eds_of(2)
    return da.erasured_axis_leaves(cells(eds, 1), 1, 2)


ERRORS = {
    "prove_empty_range": lambda m: m.nmt_prove_range(_leaves(), 2, 2),
    "prove_past_end": lambda m: m.nmt_prove_range(_leaves(), 3, 5),
    "prove_negative": lambda m: m.nmt_prove_range(_leaves(), -1, 1),
    "prover_range": lambda m: m.NmtRowProver(_leaves()).prove_range(0, 9),
    "prover_empty_root": lambda m: m.NmtRowProver([]).root(),
    "levels_not_pow2": lambda m: m.NmtRowProver.from_node_levels(
        [[b"\x00" * 90] * 3, [b"\x00" * 90]]),
    "levels_incomplete": lambda m: m.NmtRowProver.from_node_levels(
        [[b"\x00" * 90] * 4, [b"\x00" * 90] * 2]),
    "verify_count": lambda m: m.NmtRangeProof(0, 2, [], 4).verify_inclusion(
        b"", [b"a"], [b"b"]),
    "verify_no_size": lambda m: m.NmtRangeProof(0, 1, []).verify_inclusion(
        b"", [b"\x00" * 29], [b"\x00"]),
    "verify_range_outside": lambda m: m.NmtRangeProof(4, 5, [b"\x00" * 90], 4).verify_inclusion(
        b"", [b"\x00" * 29], [b"\x00"]),
    "verify_leftover": lambda m: _leftover(m),
    "verify_wrong_root": lambda m: m.nmt_prove_range(_leaves(), 1, 2).verify_inclusion(
        b"\x00" * 90, [_leaves()[1][:29]], [_leaves()[1][29:]]),
    "merkle_wrong_leaf": lambda m: m.merkle_proofs([b"a", b"b", b"c"])[1][1].verify(
        m.merkle_proofs([b"a", b"b", b"c"])[0], b"c"),
    "merkle_wrong_root": lambda m: m.merkle_proofs([b"a", b"b"])[1][0].verify(b"\x00" * 32, b"a"),
    "merkle_bad_index": lambda m: m._hash_from_aunts(3, 3, b"", []),
    "absence_present": lambda m: m.nmt_prove_absence(_ns_leaves(2, 4, 8), _ns(4)),
    "absence_outside": lambda m: m.nmt_prove_absence(_ns_leaves(2, 4, 8), _ns(9)),
    "absence_required": lambda m: m.verify_namespace_absent(
        nmt_root(_ns_leaves(5, 6, 7, 8)), _ns(6), None),
    "absence_not_above": lambda m: m.nmt_prove_absence(_ns_leaves(2, 4, 8, 9), _ns(5)).verify(
        nmt_root(_ns_leaves(2, 4, 8, 9)), _ns(9)),
    "absence_wrong_tree": lambda m: m.nmt_prove_absence(_ns_leaves(2, 4, 8, 9), _ns(5)).verify(
        nmt_root(_ns_leaves(2, 5, 8, 9)), _ns(5)),
}


def _ns(b: int) -> bytes:
    return bytes(28) + bytes([b])


def _ns_leaves(*bs: int) -> list[bytes]:
    return [_ns(b) + b"\x07" * 16 for b in bs]


def _leftover(m):
    leaves = _leaves()
    p = m.nmt_prove_range(leaves, 1, 2)
    p.nodes.append(p.nodes[0])
    p.verify_inclusion(m.NmtRowProver(leaves).root(), [leaves[1][:29]], [leaves[1][29:]])


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_value_errors_equal_jax(case):
    with pytest.raises(ValueError) as theirs:
        ERRORS[case](jax_proof)
    with pytest.raises(ValueError) as ours:
        ERRORS[case](proof)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
def test_merkle_proofs_equal_jax(n):
    rng = np.random.default_rng(n)
    items = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]
    root, proofs = proof.merkle_proofs(items)
    j_root, j_proofs = jax_proof.merkle_proofs(items)
    assert root == j_root
    assert [(p.total, p.index, p.leaf_hash, p.aunts) for p in proofs] == [
        (p.total, p.index, p.leaf_hash, p.aunts) for p in j_proofs]
    if n:
        assert root == merkle_root(items)
    for i, p in enumerate(proofs):
        p.verify(root, items[i])


@pytest.mark.parametrize("missing", [3, 5, 6, 7])
def test_absence_proofs_equal_jax(missing):
    leaves = _ns_leaves(2, 4, 4, 8, 9)
    root = nmt_root(leaves)
    got = proof.nmt_prove_absence(leaves, _ns(missing))
    assert got.to_json() == jax_proof.nmt_prove_absence(leaves, _ns(missing)).to_json()
    proof.verify_namespace_absent(root, _ns(missing), got)
    back = proof.NmtAbsenceProof.from_json(got.to_json())
    assert back == got
    for outside in (1, 200):
        proof.verify_namespace_absent(root, _ns(outside), None)


def _blob_tx(rng, sizes) -> bytes:
    blobs = [jax_blob.new_blob(jax_ns.new_v0(rng.integers(0, 256, 5, dtype=np.uint8).tobytes()),
                               rng.integers(0, 256, s, dtype=np.uint8).tobytes(), 0)
             for s in sizes]
    return jax_blob.marshal_blob_tx(rng.integers(0, 256, 64, dtype=np.uint8).tobytes(), blobs)


def _share_proof_doc(p) -> tuple:
    return (p.data, [nodes_of(sp) for sp in p.share_proofs], p.namespace.bytes,
            p.row_proof.row_roots, p.row_proof.start_row, p.row_proof.end_row,
            [(m.total, m.index, m.leaf_hash, m.aunts) for m in p.row_proof.proofs])


def _txs(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
            rng.integers(0, 256, 500, dtype=np.uint8).tobytes(),
            _blob_tx(rng, [2000]), _blob_tx(rng, [30_000, 10])]


@functools.lru_cache(maxsize=None)
def _constructed(seed: int):
    txs = _txs(seed)
    sq = square_pkg.construct(txs, 1, 64)
    dah = da.new_data_availability_header(da.extend_shares(to_bytes(sq), "cpu"))
    return txs, sq, dah


@pytest.mark.parametrize("tx_index", range(4))
def test_tx_inclusion_proofs_equal_jax(tx_index):
    txs, _sq, dah = _constructed(21)
    got = proof.new_tx_inclusion_proof(txs, tx_index, 1, device="cpu")
    assert _share_proof_doc(got) == _share_proof_doc(
        jax_proof.new_tx_inclusion_proof(txs, tx_index, 1))
    got.validate(dah.hash())
    with pytest.raises(ValueError):
        got.validate(b"\x00" * 32)
    got.data[0] = b"\x00" * 512
    with pytest.raises(ValueError):
        got.validate(dah.hash())


def test_multirow_share_proof_equal_jax():
    txs, sq, dah = _constructed(21)
    r = square_pkg.blob_share_range(txs, 3, 0, 1)
    namespace = ns_pkg.from_bytes(sq[r.start].data[:29])
    eds = da.extend_shares(to_bytes(sq), "cpu")
    got = proof.new_share_inclusion_proof(sq, namespace, r, device="cpu")
    given = proof.new_share_inclusion_proof(sq, namespace, Range(r.start, r.end), eds=eds,
                                            dah=dah)
    j_sq = jax_square.construct(txs, 1, 64)
    want = jax_proof.new_share_inclusion_proof(
        j_sq, jax_ns.from_bytes(namespace.bytes), jax_square.blob_share_range(txs, 3, 0, 1))
    assert _share_proof_doc(got) == _share_proof_doc(given) == _share_proof_doc(want)
    assert got.row_proof.end_row > got.row_proof.start_row
    got.validate(dah.hash())
    assert dah.hash() == jax_da.new_data_availability_header(
        jax_da.extend_shares(jax_to_bytes(j_sq))).hash()
