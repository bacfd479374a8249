"""Blob type + BlobTx / IndexWrapper envelopes.

Wire-compatible with the reference protobuf messages
(proto/celestia/core/v1/blob/blob.proto; envelope logic pkg/blob/blob.go:
TypeId markers "BLOB" / "INDX" distinguish the envelopes from ordinary
sdk txs). A minimal hand-rolled proto3 codec keeps the package
dependency-light; the messages involved use only bytes / uint32 fields.
"""

from __future__ import annotations

import dataclasses
import functools

from celestia_tpu_torch import appconsts
from celestia_tpu_torch import namespace as ns_pkg
from celestia_tpu_torch.namespace import Namespace

PROTO_BLOB_TX_TYPE_ID = "BLOB"
PROTO_INDEX_WRAPPER_TYPE_ID = "INDX"

SUPPORTED_SHARE_VERSIONS = (appconsts.SHARE_VERSION_ZERO,)


# --- minimal proto3 wire codec (varint + length-delimited only) ---


def _uvarint_slow(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# covers every length delimiter and share index the builder emits (the
# worst-case share index is 128·128 = 16384, so the table must extend
# past it); table lookup beats the loop
_UVARINT_TABLE = tuple(_uvarint_slow(i) for i in range(1 << 16))


def uvarint(n: int) -> bytes:
    if 0 <= n < (1 << 16):
        return _UVARINT_TABLE[n]
    return _uvarint_slow(n)


def uvarint_len(n: int) -> int:
    """Byte length of uvarint(n) without building it (7 bits per byte)."""
    length = 1
    while n >= 0x80:
        n >>= 7
        length += 1
    return length


def read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _field_bytes(tag: int, payload: bytes) -> bytes:
    if not payload:
        return b""
    return uvarint(tag << 3 | 2) + uvarint(len(payload)) + payload


def _field_uint(tag: int, value: int) -> bytes:
    if value == 0:
        return b""
    return uvarint(tag << 3 | 0) + uvarint(value)


def _parse_fields(data: bytes):
    """(tag, wire_type, value) triples; value is int or bytes.

    Varint decoding is inlined with a single-byte fast path (field keys
    are one byte for tags < 16, and most lengths/values fit 7 bits) —
    this parser sits on the block-building hot path for every tx."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        b = data[pos]
        pos += 1
        if b < 0x80:
            key = b
        else:
            key = b & 0x7F
            shift = 7
            while True:
                if pos >= n:
                    raise ValueError("truncated varint")
                b = data[pos]
                pos += 1
                key |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
                if shift > 63:
                    raise ValueError("varint too long")
        wt = key & 7
        tag = key >> 3
        if wt == 0:
            b = data[pos] if pos < n else None
            if b is None:
                raise ValueError("truncated varint")
            pos += 1
            if b < 0x80:
                val = b
            else:
                val = b & 0x7F
                shift = 7
                while True:
                    if pos >= n:
                        raise ValueError("truncated varint")
                    b = data[pos]
                    pos += 1
                    val |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                    if shift > 63:
                        raise ValueError("varint too long")
        elif wt == 2:
            b = data[pos] if pos < n else None
            if b is None:
                raise ValueError("truncated varint")
            pos += 1
            if b < 0x80:
                ln = b
            else:
                ln = b & 0x7F
                shift = 7
                while True:
                    if pos >= n:
                        raise ValueError("truncated varint")
                    b = data[pos]
                    pos += 1
                    ln |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                    if shift > 63:
                        raise ValueError("varint too long")
            end = pos + ln
            if end > n:
                raise ValueError("truncated field")
            val = data[pos:end]
            pos = end
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.append((tag, wt, val))
    return out


# --- Blob ---


@dataclasses.dataclass
class Blob:
    namespace_id: bytes  # 28 bytes
    data: bytes
    share_version: int
    namespace_version: int

    def namespace(self) -> Namespace:
        return ns_pkg.Namespace(self.namespace_version, self.namespace_id)

    def validate(self) -> None:
        """ref: pkg/blob/blob.go Blob.Validate"""
        if len(self.namespace_id) != ns_pkg.NAMESPACE_ID_SIZE:
            raise ValueError(
                f"namespace id must be {ns_pkg.NAMESPACE_ID_SIZE} bytes"
            )
        if self.share_version > appconsts.MAX_SHARE_VERSION:
            raise ValueError("share version can not be greater than MaxShareVersion")
        if self.namespace_version > ns_pkg.NAMESPACE_VERSION_MAX:
            raise ValueError("namespace version can not be greater than MaxNamespaceVersion")
        if len(self.data) == 0:
            raise ValueError("blob data can not be empty")
        # namespace must be valid for its version (e.g. v0 zero-prefix)
        ns_pkg.new_namespace(self.namespace_version, self.namespace_id)

    def marshal(self) -> bytes:
        return (
            _field_bytes(1, self.namespace_id)
            + _field_bytes(2, self.data)
            + _field_uint(3, self.share_version)
            + _field_uint(4, self.namespace_version)
        )


def new_blob(namespace: Namespace, data: bytes, share_version: int = 0) -> Blob:
    b = Blob(
        namespace_id=namespace.id,
        data=bytes(data),
        share_version=share_version,
        namespace_version=namespace.version,
    )
    b.validate()
    return b


def _require_wt(wt: int, expected: int, tag: int) -> None:
    # gogoproto rejects wire-type-confused fields; silently coercing them
    # would be consensus-divergent (and bytes(int) is an allocation DoS).
    if wt != expected:
        raise ValueError(f"wrong wire type {wt} for field {tag}")


def unmarshal_blob(raw: bytes) -> Blob:
    b = Blob(b"", b"", 0, 0)
    for tag, wt, val in _parse_fields(raw):
        if tag == 1:
            _require_wt(wt, 2, tag)
            b.namespace_id = val
        elif tag == 2:
            _require_wt(wt, 2, tag)
            b.data = val
        elif tag == 3:
            _require_wt(wt, 0, tag)
            b.share_version = int(val)
        elif tag == 4:
            _require_wt(wt, 0, tag)
            b.namespace_version = int(val)
    return b


def sort_blobs(blobs: list[Blob]) -> None:
    """Stable in-place sort by full namespace bytes. ref: pkg/blob/blob.go:92"""
    blobs.sort(key=lambda b: b.namespace().bytes)


# --- BlobTx envelope ---


@dataclasses.dataclass
class BlobTx:
    tx: bytes
    blobs: list[Blob]


def marshal_blob_tx(tx: bytes, blobs: list[Blob]) -> bytes:
    """ref: pkg/blob/blob.go:83 MarshalBlobTx"""
    out = _field_bytes(1, tx)
    for b in blobs:
        out += _field_bytes(2, b.marshal())
    out += _field_bytes(3, PROTO_BLOB_TX_TYPE_ID.encode())
    return out


def unmarshal_blob_tx(raw: bytes) -> tuple[BlobTx | None, bool]:
    """Returns (blob_tx, is_blob_tx). ref: pkg/blob/blob.go:58

    Parse results are memoized (bytes-keyed LRU): the node parses the
    same tx at CheckTx, PrepareProposal, ProcessProposal, and DeliverTx
    — the reference's mempool keeps parsed txs around the same way.
    The returned BlobTx/Blob objects are SHARED between callers and
    must be treated as immutable (all fields are bytes/int values;
    nothing in-tree mutates them)."""
    # Sound fast-reject: the type_id field value "BLOB" must appear
    # literally in the wire bytes, so its absence proves not-a-BlobTx
    # without a varint-by-varint parse (the common case for ordinary sdk
    # txs flowing through the builder/mempool). Rejects skip the cache:
    # the scan is cheaper than LRU bookkeeping for plain sdk txs.
    if b"BLOB" not in raw:
        return None, False
    cached = _PARSE_CACHE.get(raw)
    if cached is not None:
        return cached
    out = _unmarshal_blob_tx_uncached(raw)
    # charge what the entry can actually PIN, not just the raw bytes:
    # each blob's memoized sparse split holds full 512-byte shares, so a
    # many-tiny-blob tx pins far more than its wire size (one 1-byte
    # blob pins a whole share + object overhead)
    btx = out[0]
    pinned = len(raw)
    if btx is not None:
        first = appconsts.FIRST_SPARSE_SHARE_CONTENT_SIZE
        cont = appconsts.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
        for b in btx.blobs:
            n = len(b.data)
            shares = 1 if n < first else 1 + (n - first + cont - 1) // cont
            pinned += shares * appconsts.SHARE_SIZE + 256 + n
    _PARSE_CACHE.put(raw, out, pinned)
    return out


class _ByteBudgetLRU:
    """FIFO cache bounded by BYTES, not entries: each cached parse pins
    ~3x the raw tx size (raw key + parsed blob bytes + the sparse-share
    memo the splitter attaches), so an entry-count bound alone would let
    large blob txs grow the cache to gigabytes. FIFO (not true LRU)
    keeps reads lock-free; the workload is a few blocks' worth of hot
    txs, where the distinction is immaterial."""

    def __init__(self, budget_bytes: int, overhead_factor: int = 3):
        import collections
        import threading

        self._data: collections.OrderedDict = collections.OrderedDict()
        self._cost: dict = {}
        self.budget = budget_bytes
        self.factor = overhead_factor
        self.used = 0
        self._lock = threading.Lock()

    def get(self, key):
        # lock-free read: dict.get is GIL-atomic, and eviction is FIFO
        # (no move_to_end) precisely so hits never mutate shared state —
        # the parse cache sits on the per-tx hot path
        # lint: allow(C005) reason=dict.get is GIL-atomic and values are immutable parses; a racing eviction yields a miss, never a torn value
        return self._data.get(key)

    def put(self, key, val, raw_len: int) -> None:
        cost = raw_len * self.factor
        if cost > self.budget:
            return  # a single giant tx must not own the whole cache
        with self._lock:
            if key in self._data:
                return
            self._data[key] = val
            self._cost[key] = cost
            self.used += cost
            while self.used > self.budget and self._data:
                k, _ = self._data.popitem(last=False)
                self.used -= self._cost.pop(k)


# factor 1: the caller passes a real pinned-bytes estimate per entry
# (raw + per-blob share memo), not just the wire length
_PARSE_CACHE = _ByteBudgetLRU(budget_bytes=192 * 1024 * 1024,
                              overhead_factor=1)


def _unmarshal_blob_tx_uncached(raw: bytes) -> tuple[BlobTx | None, bool]:
    try:
        tx = b""
        blobs: list[Blob] = []
        type_id = ""
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                tx = val
            elif tag == 2:
                _require_wt(wt, 2, tag)
                blobs.append(unmarshal_blob(val))
            elif tag == 3:
                _require_wt(wt, 2, tag)
                type_id = val.decode()
        if type_id != PROTO_BLOB_TX_TYPE_ID:
            return None, False
        return BlobTx(tx=tx, blobs=blobs), True
    except (ValueError, UnicodeDecodeError):
        return None, False


# --- IndexWrapper (celestia-core's wrapped PFB tx carrying share indexes) ---


@dataclasses.dataclass(slots=True)
class IndexWrapper:
    tx: bytes
    share_indexes: list[int]
    # pre-encoded protobuf field 1, attached by the square builder so
    # export's per-block re-marshal skips re-encoding the inner tx; a
    # cache, not identity — excluded from __eq__/__repr__
    _txf: bytes | None = dataclasses.field(
        default=None, compare=False, repr=False
    )


def marshal_index_wrapper_size(tx: bytes, share_indexes: list[int]) -> int:
    """len(marshal_index_wrapper(tx, share_indexes)) without building the
    bytes — the builder's capacity accounting calls this per blob tx."""
    return marshal_index_wrapper_size_from_len(len(tx), tuple(share_indexes))


@functools.lru_cache(maxsize=8192)
def marshal_index_wrapper_size_from_len(
    tx_len: int, share_indexes: tuple[int, ...]
) -> int:
    """Size from lengths alone (pure, cached): the builder accounts with
    WORST-CASE indexes, so (tx_len, n_blobs, version) repeats heavily."""
    packed_len = sum(uvarint_len(i) for i in share_indexes)
    size = 1 + uvarint_len(tx_len) + tx_len if tx_len else 0
    if packed_len:
        size += 1 + uvarint_len(packed_len) + packed_len
    return size + 1 + 1 + 4  # field 3: tag, len, "INDX"


_IW_TAIL = _field_bytes(3, PROTO_INDEX_WRAPPER_TYPE_ID.encode())

# byte-budgeted like the parse cache: inner tx bytes are UNTRUSTED
# (ProcessProposal reconstructs peer squares), so an entry-count bound
# would let an adversarial proposer pin gigabytes of multi-MB inner txs
_IW_FIELD_CACHE = _ByteBudgetLRU(budget_bytes=32 * 1024 * 1024,
                                 overhead_factor=2)


def _iw_tx_field(tx: bytes) -> bytes:
    # field 1 depends only on the inner tx — constant across the
    # per-build re-marshals with fresh share indexes
    cached = _IW_FIELD_CACHE.get(tx)
    if cached is not None:
        return cached
    out = _field_bytes(1, tx)
    _IW_FIELD_CACHE.put(tx, out, len(tx))
    return out


def marshal_index_wrapper(tx: bytes, share_indexes: list[int]) -> bytes:
    packed = b"".join(uvarint(i) for i in share_indexes)
    return _iw_tx_field(tx) + _field_bytes(2, packed) + _IW_TAIL


def marshal_index_wrapper_with_head(
    tx_field: bytes, share_indexes: list[int]
) -> bytes:
    """marshal_index_wrapper with field 1 pre-encoded (the builder's
    export marshals every PFB per block; the tx field never changes)."""
    if len(share_indexes) == 1:  # the common single-blob PFB
        packed = uvarint(share_indexes[0])
    elif share_indexes:
        packed = b"".join(map(uvarint, share_indexes))
    else:
        # proto3 omits an empty repeated field — must match
        # marshal_index_wrapper and the size accounting byte-for-byte
        return tx_field + _IW_TAIL
    # b"\x12" == field 2, wire type 2 (what _field_bytes(2, …) emits)
    return tx_field + b"\x12" + uvarint(len(packed)) + packed + _IW_TAIL


def unmarshal_index_wrapper(raw: bytes) -> tuple[IndexWrapper | None, bool]:
    # Same sound fast-reject as unmarshal_blob_tx: no literal "INDX"
    # bytes -> cannot carry the type_id field -> not an IndexWrapper.
    # The builder runs this on every blob tx's inner sdk tx (the
    # double-wrap validity check), where rejection is the hot path.
    if b"INDX" not in raw:
        return None, False
    try:
        tx = b""
        indexes: list[int] = []
        type_id = ""
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 2, tag)
                tx = val
            elif tag == 2 and wt == 2:
                pos = 0
                while pos < len(val):
                    idx, pos = read_uvarint(val, pos)
                    indexes.append(idx)
            elif tag == 2 and wt == 0:
                indexes.append(int(val))
            elif tag == 3:
                _require_wt(wt, 2, tag)
                type_id = val.decode()
        if type_id != PROTO_INDEX_WRAPPER_TYPE_ID:
            return None, False
        return IndexWrapper(tx=tx, share_indexes=indexes), True
    except (ValueError, UnicodeDecodeError):
        return None, False
