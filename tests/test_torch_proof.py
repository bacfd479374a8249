"""The port's DAS proofs (celestia_tpu_torch/proof) against the JAX
package's proof module.

For each k from 1 to 16, one square (sorted v0 namespaces over random bytes,
made with numpy from a seed) is extended by the port on the CPU. The port's
row levels (``extend.eds_row_levels_device(device="cpu")``) equal the JAX
package's; the port's provers, host-built and seeded from those levels,
give the JAX provers' roots and proofs byte for byte; ``das_sample_docs``
gives the JAX documents; every proof verifies against the port's DAH row
roots and fails for a changed share; and every ValueError the JAX module
raises, the port raises.
"""

import functools

import numpy as np
import pytest

from celestia_tpu import da as jax_da
from celestia_tpu import proof as jax_proof
from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch import da, proof
from celestia_tpu_torch.ops import extend
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
}


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
