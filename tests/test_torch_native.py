"""The port's native runtime (``celestia_tpu_torch/native.py`` over its own
copy of the C++ sources, ``celestia_tpu_torch/csrc/host/``) against the JAX
package's, byte for byte, at k = 1 to 64: the Leopard encode and decode,
the EDS extend, the NMT roots, the DAH merkle, the repair and the full
native ExtendBlock. Its build reads only the port's sources and writes only
under ``celestia_tpu_torch/_build/``."""

import pathlib

import numpy as np
import pytest

from celestia_tpu import native as jnative
from celestia_tpu.da.repair import UnrepairableError as JUnrepairable
from celestia_tpu_torch import native as pnative
from celestia_tpu_torch.da.repair import UnrepairableError as PUnrepairable

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "celestia_tpu_torch"
KS = (1, 2, 4, 8, 16, 32, 64)


def _square(k: int) -> np.ndarray:
    return np.random.default_rng(k).integers(0, 256, (k, k, 512), dtype=np.uint8)


def test_both_runtimes_build():
    assert pnative.available(), pnative._load_error
    assert jnative.available(), jnative._load_error


def test_the_build_reads_the_ports_sources_and_writes_under_its_build_dir():
    path = pnative.lib_path()
    assert path.exists()
    assert PACKAGE / "_build" in path.parents
    assert pnative._SRC_DIR == PACKAGE / "csrc" / "host"
    # the copies are the JAX package's code below their header comments
    for name in pnative._SOURCES:
        mine = (pnative._SRC_DIR / name).read_text()
        theirs = (REPO / "native" / name).read_text()
        body = mine[mine.index("#include"):]
        assert body == theirs[theirs.index("#include"):]
        assert "celestia_tpu/" not in mine


@pytest.mark.parametrize("k", KS)
def test_extend_and_root_native_is_the_jax_packages(k):
    q0 = _square(k)
    mine, theirs = pnative.extend_and_root_native(q0), jnative.extend_and_root_native(q0)
    assert np.array_equal(mine[0], theirs[0])
    assert mine[1:] == theirs[1:]


@pytest.mark.parametrize("k", KS)
def test_leopard_encode_and_decode_are_the_jax_packages(k):
    data = _square(k).reshape(k, -1)[:, :1024]
    parity = pnative.leo_encode(data)
    assert np.array_equal(parity, jnative.leo_encode(data))
    cells = np.concatenate([data, parity])
    present = np.ones(2 * k, bool)
    present[np.random.default_rng(k).choice(2 * k, k, replace=False)] = False
    damaged = np.where(present[:, None], cells, 0).astype(np.uint8)
    mine, theirs = pnative.leo_decode(damaged, present), jnative.leo_decode(damaged, present)
    assert np.array_equal(mine, theirs) and np.array_equal(mine, cells)


@pytest.mark.parametrize("k", (1, 4, 16))
def test_repair_is_the_jax_packages_and_refuses_alike(k):
    eds = pnative.eds_extend(_square(k))
    present = np.random.default_rng(k).random((2 * k, 2 * k)) > 0.25
    present[0, :] = True  # keep the pattern decodable at k = 1
    damaged = np.where(present[..., None], eds, 0).astype(np.uint8)
    mine, theirs = pnative.eds_repair(damaged, present), jnative.eds_repair(damaged, present)
    assert np.array_equal(mine, theirs) and np.array_equal(mine, eds)
    nothing = np.zeros((2 * k, 2 * k), bool)
    with pytest.raises(PUnrepairable):
        pnative.eds_repair(damaged, nothing)
    with pytest.raises(JUnrepairable):
        jnative.eds_repair(damaged, nothing)


def test_merkle_root_is_the_jax_packages():
    for n in (0, 1, 3, 8, 13):
        items = [bytes([i]) * 90 for i in range(n)]
        assert pnative.merkle_root(items) == jnative.merkle_root(items)
    with pytest.raises(ValueError, match="equal-size"):
        pnative.merkle_root([b"a", b"bc"])
