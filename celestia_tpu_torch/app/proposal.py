"""The proposer's square on the card from the blob arena (port of the JAX
App's ``_assembled_proposal_dah`` / ``_assembled_proposal_dah_locked``,
celestia_tpu/app/app.py:563-647).

``assembled_proposal_dah`` turns a built square (``square.build_ex``: the
shares and the Builder's blob layout) into its DAH without uploading the
square: resident blobs are read from the ``DeviceBlobArena`` on the card,
every other cell is a row of a deduplicated host-share table, and
``extend.assembled_roots`` assembles the square and runs the roots-only
core. The port's App (ROADMAP Queue 1, item 8b) calls it on its proposal
path.
"""

from __future__ import annotations

import numpy as np

from celestia_tpu_torch import appconsts, da
from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch.ops import extend
from celestia_tpu_torch.ops.blob_pool import DeviceBlobArena, blob_key
from celestia_tpu_torch.shares.splitters import sparse_shares_needed


def assembled_proposal_dah(arena: DeviceBlobArena, data_square, builder, k: int,
                           device=None) -> da.DataAvailabilityHeader | None:
    """The DAH of ``data_square`` (k² shares, laid out by ``builder``) with
    its resident blobs read from ``arena``; None when resident bytes are
    under half of all blob bytes (the JAX App's rule: the caller uploads
    the square instead).

    Runs entirely under the arena lock: the offset lookups, the launches and
    the root fetch must see one arena, since an insert or a half flip would
    rewrite bytes at offsets already taken. ``device``: where the square is
    assembled (None means CUDA); it must be the arena's device."""
    dev = device_mod.resolve(device)
    if arena.device.type != dev.type:
        raise ValueError(f"the arena lives on {arena.device}, not on {dev}")
    with arena.lock:
        inputs = proposal_inputs(arena, data_square, builder, k)
        if inputs is None:
            return None
        rows, cols = extend.assembled_roots(arena, **inputs, k=k)
    return da.DataAvailabilityHeader([r.tobytes() for r in rows], [c.tobytes() for c in cols])


def proposal_inputs(arena: DeviceBlobArena, data_square, builder, k: int) -> dict | None:
    """The host arrays of ``extend.assembled_roots`` for this square
    (``host_shares``, ``host_pos``, ``host_row``, ``blob_start``,
    ``blob_nshares``, ``blob_off``, ``blob_len``, ``ns_table``), or None
    when resident bytes are under half of all blob bytes. Blobs in a compact
    namespace, blobs not resident and blobs whose resident length differs
    stay host cells. The caller holds the arena lock until the roots are
    fetched."""
    s = k * k
    cell_is_arena = np.zeros(s, bool)
    ns_rows: list = []
    blob_starts: list[int] = []
    blob_ns: list[int] = []
    blob_offs: list[int] = []
    blob_lens: list[int] = []
    resident = total = 0
    # blob_layout is export order: the cursor only advances, so starts are
    # ascending, as the kernel's blob lookup needs
    for start, blob in builder.blob_layout():
        total += len(blob.data)
        ns_obj = blob.namespace()
        if ns_obj.is_tx() or ns_obj.is_pay_for_blob():
            continue  # compact-ns blob: reserved-byte layout, host cells
        loc = arena.offset_of(blob_key(blob.data))
        if loc is None:
            continue  # not resident: its cells stay host cells
        off, ln = loc
        if ln != len(blob.data):
            continue
        n = sparse_shares_needed(len(blob.data))
        ns_rows.append(np.frombuffer(ns_obj.bytes, np.uint8))
        blob_starts.append(start)
        blob_ns.append(n)
        blob_offs.append(off)
        blob_lens.append(len(blob.data))
        cell_is_arena[start: start + n] = True
        resident += len(blob.data)
    if total == 0 or resident * 2 < total:
        return None  # mostly host bytes anyway: the upload path wins
    # deduplicated host-share table: a blob-heavy square's host cells are
    # mostly identical padding shares, so the table holds ~#unique rows
    # (PFB shares and a handful of padding patterns); host cells travel as
    # sparse (pos, row) pairs
    host_pos = np.flatnonzero(~cell_is_arena).astype(np.int32)
    host_row = np.zeros(len(host_pos), np.int32)
    unique_rows: dict[bytes, int] = {}
    for idx, i in enumerate(host_pos):
        b = data_square[int(i)].data
        row = unique_rows.get(b)
        if row is None:
            row = len(unique_rows)
            unique_rows[b] = row
        host_row[idx] = row
    if unique_rows:
        host_shares = np.frombuffer(b"".join(unique_rows.keys()), np.uint8).reshape(
            len(unique_rows), appconsts.SHARE_SIZE)
    else:
        host_shares = np.zeros((0, appconsts.SHARE_SIZE), np.uint8)
    return {
        "host_shares": host_shares, "host_pos": host_pos, "host_row": host_row,
        "blob_start": np.array(blob_starts, np.int32),
        "blob_nshares": np.array(blob_ns, np.int32),
        "blob_off": np.array(blob_offs, np.int32),
        "blob_len": np.array(blob_lens, np.int32),
        "ns_table": (np.stack(ns_rows) if ns_rows
                     else np.zeros((0, appconsts.NAMESPACE_SIZE), np.uint8)),
    }
