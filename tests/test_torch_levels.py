"""Every row-tree level of an existing EDS: the port's
``eds_row_levels_device`` against the JAX package's, byte for byte."""

import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import extend
from tests.test_torch_extend import CASES, square


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("k,pad_tail", CASES)
def test_eds_row_levels_device_matches_jax(k, pad_tail):
    j_eds = jax_da.extend_shares(square(k, pad_tail=pad_tail).reshape(-1, SHARE_SIZE))
    j_rows = np.stack([np.frombuffer(r, np.uint8) for r in j_eds.row_roots()])
    levels = extend.eds_row_levels_device(j_eds.data, device="cpu")
    j_levels = extend_tpu.eds_row_levels_device(j_eds.data)
    assert len(levels) == len(j_levels) == int(np.log2(2 * k)) + 1
    for ours, theirs in zip(levels, j_levels):
        assert np.array_equal(ours, np.asarray(theirs))
    assert np.array_equal(levels[-1][:, 0], j_rows)


def test_eds_row_levels_reject_non_square():
    with pytest.raises(ValueError):
        extend.eds_row_levels_device(np.zeros((4, 2, 512), np.uint8), device="cpu")
