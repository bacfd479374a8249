"""Bad Encoding Fraud Proofs in the port (``celestia_tpu_torch/da/fraud.py``)
against the JAX package's, on corrupted squares: ``find_befp``,
``generate_befp`` and ``verify_befp`` give the same proofs, bytes for bytes,
and the same verdicts and refusals. The squares are extended by the JAX
package's native runtime; each package's DAH is computed on its own host
path."""

import numpy as np
import pytest

from celestia_tpu import da as jda
from celestia_tpu import namespace as jns
from celestia_tpu import native as jnative
from celestia_tpu.da import fraud as jfraud
from celestia_tpu_torch import da as pda
from celestia_tpu_torch.da import fraud as pfraud


def _eds(k: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 256, size=(k * k, 512), dtype=np.uint8)
    subs = sorted(rng.integers(0, 200, size=(k * k, 10), dtype=np.uint8).tolist())
    for i, sub in enumerate(subs):
        flat[i, :29] = np.frombuffer(jns.new_v0(bytes(sub)).bytes, dtype=np.uint8)
    return jnative.eds_extend(flat.reshape(k, k, 512))


def _dahs(eds: np.ndarray):
    """The (JAX, port) DAHs committing to ``eds`` as it is."""
    k = eds.shape[0] // 2
    jdah = jda.new_data_availability_header(jda.ExtendedDataSquare(eds, k))
    pdah = pda.new_data_availability_header(pda.ExtendedDataSquare(eds, k, "cpu"))
    assert pdah.row_roots == jdah.row_roots and pdah.column_roots == jdah.column_roots
    return jdah, pdah


# (k, row, col, the xor): a parity cell of Q1, Q2 and Q3, and a data cell
CORRUPTIONS = [(2, 1, 3, 0x5A), (4, 6, 1, 0x01), (4, 7, 7, 0xFF), (8, 3, 2, 0x80)]


@pytest.mark.parametrize("k, row, col, flip", CORRUPTIONS)
def test_find_generate_and_verify_are_the_jax_packages(k, row, col, flip):
    eds = _eds(k)
    eds[row, col, 100] ^= flip
    jdah, pdah = _dahs(eds)
    mine, theirs = pfraud.find_befp(eds), jfraud.find_befp(eds)
    assert mine is not None and mine.marshal() == theirs.marshal()
    assert (mine.axis, mine.index) == ("row", row)
    assert pfraud.verify_befp(mine, pdah) is True
    assert jfraud.verify_befp(jfraud.BadEncodingFraudProof.unmarshal(mine.marshal()), jdah)
    # the column proof of the same cell, through generate_befp
    col_mine = pfraud.generate_befp(eds, pfraud.AXIS_COL, col)
    assert col_mine.marshal() == jfraud.generate_befp(eds, jfraud.AXIS_COL, col).marshal()
    assert pfraud.verify_befp(pfraud.BadEncodingFraudProof.unmarshal(col_mine.marshal()), pdah)


def test_an_honest_square_has_no_proof_and_a_good_axis_is_refused_alike():
    eds = _eds(4)
    assert pfraud.find_befp(eds) is None and jfraud.find_befp(eds) is None
    eds[1, 6, 0] ^= 1
    logs = []
    for fraud in (pfraud, jfraud):
        with pytest.raises(fraud.NotFraudulentError) as exc:
            fraud.generate_befp(eds, fraud.AXIS_ROW, 0)
        logs.append(str(exc.value))
    assert logs[0] == logs[1]


def test_a_proof_against_an_honest_dah_is_refused_alike():
    """The proof of a corrupted square does not verify against the honest
    square's DAH: the inclusion proofs fail on both sides alike."""
    honest = _eds(4)
    bad = honest.copy()
    bad[2, 5, 7] ^= 0x33
    proof = pfraud.find_befp(bad)
    jdah, pdah = _dahs(honest)
    errors = []
    for fraud, dah in ((pfraud, pdah), (jfraud, jdah)):
        with pytest.raises(ValueError) as exc:
            fraud.verify_befp(fraud.BadEncodingFraudProof.unmarshal(proof.marshal()), dah)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_forged_and_malformed_proofs_are_refused_alike():
    eds = _eds(4)
    jdah, pdah = _dahs(eds)
    w, k = 8, 4
    garbage = [bytes([j]) * 512 for j in range(w)]
    cases = {
        "tree size": lambda f, dah: f.BadEncodingFraudProof(
            f.AXIS_ROW, 1, k, garbage,
            [f.NmtRangeProof(1, 2, [dah.column_roots[j]], tree_size=0) for j in range(w)]),
        "all 2k shares": lambda f, dah: f.BadEncodingFraudProof(
            f.AXIS_ROW, 1, k, garbage[:3], []),
        "unknown axis": lambda f, dah: f.BadEncodingFraudProof("diag", 1, k, garbage, []),
        "out of range": lambda f, dah: f.BadEncodingFraudProof(f.AXIS_COL, w, k, garbage, []),
    }
    for what, make in cases.items():
        errors = []
        for fraud, dah in ((pfraud, pdah), (jfraud, jdah)):
            with pytest.raises(ValueError) as exc:
                fraud.verify_befp(make(fraud, dah), dah)
            errors.append(str(exc.value))
        assert errors[0] == errors[1], what
