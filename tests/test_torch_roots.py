"""The port's roots-only entry and fused route against the JAX package's
``roots_device`` (XLA:CPU) and ``fused_roots_reference`` (the Pallas
kernels' eager tile math), byte for byte."""

import numpy as np
import pytest
import torch

from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.ops import extend
from tests.test_torch_extend import CASES, square


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("k,pad_tail", CASES)
def test_roots_device_matches_jax(k, pad_tail):
    sq = square(k, pad_tail=pad_tail)
    rows, cols = extend.roots_device(sq, device="cpu")
    j_rows, j_cols = extend_tpu.roots_device(sq)
    assert np.array_equal(rows, j_rows)
    assert np.array_equal(cols, j_cols)


@pytest.mark.parametrize("k,pad_tail", CASES)
def test_fused_route_matches_pallas_reference(k, pad_tail):
    sq = square(k, pad_tail=pad_tail)
    eds, rows, cols = extend.extend_roots_device(sq, device="cpu")
    r_eds, r_rows, r_cols = extend_tpu.fused_roots_reference(sq, tile=k * SHARE_SIZE)
    assert np.array_equal(eds, r_eds)
    assert np.array_equal(rows, r_rows)
    assert np.array_equal(cols, r_cols)


def test_plain_kernel_set_equals_wrappers_on_cpu():
    """PLAIN (the plain versions called directly) and KERNELS (the
    wrappers, which take the plain versions for CPU tensors) agree."""
    sq = square(4, seed=9)
    a = extend.extend_and_root_device(sq, device="cpu", kernels=extend.PLAIN)
    b = extend.extend_and_root_device(sq, device="cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_tail_padding_stays_below_parity_in_roots():
    """Q0 rows that end in TAIL_PADDING keep max = TAIL_PADDING (parity
    leaves are ignored); pure parity rows report parity as min and max."""
    k = 4
    rows, _cols = extend.roots_device(square(k, pad_tail=k), device="cpu")
    tail = bytes(np.frombuffer(square(k, pad_tail=k)[k - 1, 0, :NAMESPACE_SIZE].tobytes(),
                               np.uint8))
    assert rows[k - 1, NAMESPACE_SIZE:2 * NAMESPACE_SIZE].tobytes() == tail
    assert rows[k, :NAMESPACE_SIZE].tobytes() == b"\xff" * NAMESPACE_SIZE
