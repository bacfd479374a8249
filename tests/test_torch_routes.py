"""The port's four extend routes (fused/unfused × dense/XOR) and kernel K4's
plain version, byte for byte against the JAX package.

The JAX side runs as its own tests run it on the CPU: the unfused routes as
``jax.jit`` of ``extend_tpu._roots_of`` on XLA:CPU, the fused routes through
``extend_tpu.fused_roots_reference`` (the Pallas kernels' eager tile math),
K4 and ``rs_pallas.extend_square`` in interpret mode, and the DAH through the
host oracle (``celestia_tpu.da``). The port runs with device="cpu", where
the kernel wrappers take their plain PyTorch versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu.ops import extend_tpu, rs_pallas, rs_tpu
from celestia_tpu_torch import da
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import extend, rs, rs_cuda, xor_cuda
from celestia_tpu_torch.ops.nmt_host import merkle_root
from tests.test_torch_extend import MIN_DAH, TYPICAL_DAH, oracle_shares, square

SMALL_K = [1, 2, 4, 8, 16]
ROUTES = [(True, False), (True, True), (False, False), (False, True)]
ROUTE_IDS = ["fused-dense", "fused-xor", "unfused-dense", "unfused-xor"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("k", [4, 16])
def test_encode2d_plain_matches_pallas_kernel(k):
    x2 = _bytes((k, k * 512), seed=600 + k)
    m2 = rs_tpu.encode_bit_matrix(k)
    ours = rs_cuda.encode2d(torch.from_numpy(x2), rs.encode_matrix_from_numpy(m2, CPU))
    theirs = rs_pallas.encode2d(jnp.asarray(x2), jnp.asarray(m2), interpret=True)
    assert ours.dtype == torch.uint8
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("k", [4, 16])
def test_extend_square_matches_pallas_extend_square(k):
    q0 = _bytes((k, k, SHARE_SIZE), seed=700 + k)
    m2 = rs_tpu.encode_bit_matrix(k)
    em = rs.encode_matrix_from_numpy(m2, CPU)
    ours = rs_cuda.extend_square(torch.from_numpy(q0), em).numpy()
    theirs = np.asarray(rs_pallas.extend_square(jnp.asarray(q0), jnp.asarray(m2), interpret=True))
    assert np.array_equal(ours, theirs)
    ops = xor_cuda.schedule_operands(k, CPU)
    assert np.array_equal(xor_cuda.extend_square_xor(torch.from_numpy(q0), ops).numpy(), theirs)


@functools.lru_cache(maxsize=None)
def jax_routes(k: int, xor: bool):
    """The JAX package's unfused route (jitted) and fused reference for one
    contraction, and the host oracle's DAH."""
    sq = square(k)
    m2 = jnp.asarray(rs_tpu.encode_bit_matrix(k))
    unfused = jax.jit(lambda s: extend_tpu._roots_of(s, m2, fused=False, xor=xor))(
        jnp.asarray(sq))
    fused = extend_tpu.fused_roots_reference(sq, tile=k * SHARE_SIZE, xor=xor)
    dah = jax_da.new_data_availability_header(
        jax_da.extend_shares(sq.reshape(k * k, SHARE_SIZE))).hash()
    return [np.asarray(a) for a in unfused], [np.asarray(a) for a in fused], dah


@pytest.mark.parametrize("fused,xor", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("k", SMALL_K)
def test_route_matches_jax(k, fused, xor):
    sq = square(k)
    eds, (rows, cols) = extend._roots(torch.from_numpy(sq), rs.encode_matrix(k, CPU),
                                      fused=fused, xor=xor)
    unfused, fused_ref, dah = jax_routes(k, xor)
    for ours, a, b in zip((eds, rows, cols), unfused, fused_ref):
        assert np.array_equal(ours.numpy(), a)
        assert np.array_equal(ours.numpy(), b)
    ours_dah = merkle_root([r.tobytes() for r in rows.numpy()]
                           + [c.tobytes() for c in cols.numpy()])
    assert ours_dah == dah


@pytest.fixture
def pin(monkeypatch):
    """Pin a route through the env, as a user does."""
    def set_route(fused: bool, xor: bool):
        monkeypatch.setenv(extend._FUSED_ENV, "1" if fused else "0")
        monkeypatch.setenv(extend._XOR_ENV, "1" if xor else "0")
    return set_route


@pytest.fixture
def taken(monkeypatch):
    """Record which route an extend took: the unfused routes build the EDS
    through rs_cuda.extend_square (dense, K4 in place) or
    xor_cuda.extend_square_xor, the XOR routes ask for the schedule."""
    seen = {"unfused": 0, "xor": 0}
    dense, xor_square = rs_cuda.extend_square, xor_cuda.extend_square_xor
    operands = xor_cuda.schedule_operands

    def spy_dense(*a):
        seen["unfused"] += 1
        return dense(*a)

    def spy_xor_square(*a):
        seen["unfused"] += 1
        return xor_square(*a)

    def spy_operands(*a):
        seen["xor"] += 1
        return operands(*a)

    monkeypatch.setattr(rs_cuda, "extend_square", spy_dense)
    monkeypatch.setattr(xor_cuda, "extend_square_xor", spy_xor_square)
    monkeypatch.setattr(xor_cuda, "schedule_operands", spy_operands)
    return seen


@pytest.mark.parametrize("fused,xor", ROUTES, ids=ROUTE_IDS)
def test_oracle_dahs_through_each_route(fused, xor, pin, taken):
    pin(fused, xor)
    assert da.min_data_availability_header(device="cpu").hash().hex() == MIN_DAH
    typical = da.new_data_availability_header(da.extend_shares(oracle_shares(4), device="cpu"))
    assert typical.hash().hex() == TYPICAL_DAH
    assert taken == {"unfused": 2 * (not fused), "xor": 2 * xor}


ENTRIES = {
    "roots_device": lambda sq: extend.roots_device(sq, device="cpu"),
    "extend_roots_device_resident":
        lambda sq: extend.extend_roots_device_resident(sq, device="cpu")[1:],
    "extend_and_root_device": lambda sq: extend.extend_and_root_device(sq, device="cpu")[1:3],
    "extend_shares": lambda sq: (lambda e: (e.row_roots(), e.col_roots()))(
        da.extend_shares(sq.reshape(-1, SHARE_SIZE), device="cpu")),
}


@pytest.mark.parametrize("fused,xor", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_env_pins_reach_every_entry(entry, fused, xor, pin, taken):
    k = 4
    pin(fused, xor)
    rows, cols = ENTRIES[entry](square(k))
    assert taken == {"unfused": int(not fused), "xor": int(xor)}
    _unfused, (_eds, j_rows, j_cols), _dah = jax_routes(k, xor)
    assert [bytes(r) for r in rows] == [r.tobytes() for r in j_rows]
    assert [bytes(c) for c in cols] == [c.tobytes() for c in j_cols]
