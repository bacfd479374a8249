"""The ragged cross-height row gather: the CUDA kernel and its plain version.

Counterpart of the JAX package's ``ragged._jitted_gather``
(celestia_tpu/ops/ragged.py:51), an XLA graph, not a Pallas kernel: it
stacks the bucket's unique pages into one array and takes a vmapped
dynamic slice per descriptor. Source: ``csrc/ragged_gather.cu``.

Contract of ``ragged_gather(pages, slots, rows)``:

- ``pages``: the bucket's unique pages, uint8 tensors of one shape
  (rows_per_page, w, 512) on one device, each contiguous;
- ``slots[t]``, ``rows[t]``: descriptor t's page (an index into ``pages``)
  and its row within that page;
- returns the (n, w, 512) rows in descriptor order.

A CPU tensor runs ``gather_rows_reference``, the JAX package's spelling
(``torch.stack(pages)[slot, row]``); a CUDA tensor launches the kernel or
raises. The kernel reads each row in place through a page table that goes
by value in its parameters, so no page is stacked and no descriptor is
copied to the device; a group larger than one table launches once a table
(``plan_launches``).

What bounds it: bytes, each row read once and written once,
2·n·w·512 / 3.35 TB/s. No single PyTorch call gathers rows from separate
buffers, so it has no library counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from celestia_tpu_torch.ops import _cuda

MAX_PAGES = 512  # unique pages one launch's table holds (kMaxPages in the source)
MAX_DESCS = 6144  # descriptors one launch holds (kMaxDescs)
_FIELD = 1 << 16  # a page slot and a row each fit 16 bits of a descriptor


def _check(pages, slots, rows) -> tuple[int, ...]:
    """The page shape of a valid bucket."""
    if not pages:
        raise ValueError("a ragged gather needs at least one page")
    shape = tuple(pages[0].shape)
    if len(shape) < 2 or pages[0].dtype != torch.uint8:
        raise ValueError(f"pages must be uint8 (rows, ...), got {pages[0].dtype} {shape}")
    for p in pages:
        if tuple(p.shape) != shape or p.dtype != torch.uint8 or p.device != pages[0].device:
            raise ValueError(f"every page of a bucket must be uint8 {shape} on "
                             f"{pages[0].device}, got {p.dtype} {tuple(p.shape)} on {p.device}")
    if len(slots) != len(rows) or not len(slots):
        raise ValueError(f"need one slot and one row a descriptor, got {len(slots)} slots "
                         f"and {len(rows)} rows")
    if min(slots) < 0 or max(slots) >= len(pages) or min(rows) < 0 or max(rows) >= shape[0]:
        raise IndexError(f"a descriptor is outside the {len(pages)} pages of {shape[0]} rows")
    return shape


def gather_rows_reference(pages, slots, rows) -> torch.Tensor:
    """Plain PyTorch version of the gather: the JAX package's spelling,
    every unique page stacked, then one index per descriptor."""
    _check(pages, slots, rows)
    dev = pages[0].device
    slot = torch.as_tensor(np.asarray(slots, dtype=np.int64), device=dev)
    row = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=dev)
    return torch.stack(pages)[slot, row]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of a group: descriptors [lo, hi), the group's page slots
    its table holds (``table[s]`` is the group slot of table slot s), and
    its packed descriptors (table slot << 16 | row)."""

    lo: int
    hi: int
    table: list[int]
    descs: np.ndarray


def plan_launches(slots, rows, max_pages: int = MAX_PAGES,
                  max_descs: int = MAX_DESCS) -> list[Launch]:
    """Split a group into launches, in descriptor order: a launch ends when
    it holds ``max_descs`` descriptors or its next descriptor would bring a
    page past ``max_pages``."""
    if max(rows) >= _FIELD:
        raise ValueError(f"a page of {max(rows) + 1} rows does not fit a descriptor")
    out: list[Launch] = []
    lo = 0
    while lo < len(slots):
        local: dict[int, int] = {}
        packed: list[int] = []
        hi = lo
        while hi < len(slots) and hi - lo < max_descs:
            s = int(slots[hi])
            if s not in local:
                if len(local) == max_pages:
                    break
                local[s] = len(local)
            packed.append(local[s] << 16 | int(rows[hi]))
            hi += 1
        out.append(Launch(lo, hi, list(local), np.asarray(packed, dtype=np.uint32)))
        lo = hi
    return out


def ragged_gather(pages, slots, rows) -> torch.Tensor:
    """Descriptor t's row ``rows[t]`` of page ``pages[slots[t]]``, for every
    t, as one (n, w, 512) tensor; see the module docstring. A CPU tensor
    runs the plain version; a CUDA tensor launches the gather kernel once a
    launch of ``plan_launches``."""
    shape = _check(pages, slots, rows)
    dev = pages[0].device
    if dev.type == "cpu":
        return gather_rows_reference(pages, slots, rows)
    if dev.type != "cuda":
        raise ValueError(f"the ragged gather runs on cuda or cpu tensors, not {dev}")
    for i, p in enumerate(pages):
        _cuda.require(p, f"pages[{i}]", torch.uint8, shape, dev)
    row_bytes = int(np.prod(shape[1:]))
    if row_bytes % 16:
        raise ValueError(f"a row of {row_bytes} bytes is not a whole number of 16-byte vectors")
    out = torch.empty((len(slots), *shape[1:]), dtype=torch.uint8, device=dev)
    lib = _cuda.library()
    stream = _cuda.stream_of(out)
    for launch in plan_launches(slots, rows):
        ptrs = np.asarray([pages[s].data_ptr() for s in launch.table], dtype=np.uint64)
        rc = lib.celestia_ragged_gather(ptrs.ctypes.data, len(ptrs), launch.descs.ctypes.data,
                                        launch.hi - launch.lo, row_bytes,
                                        out[launch.lo].data_ptr(), dev.index or 0, stream)
        _cuda.check(rc, "ragged_gather")
        _cuda.LAUNCHES["ragged_gather"] += 1
    return out
