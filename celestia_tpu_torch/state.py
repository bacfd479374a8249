"""Versioned key-value state store with branch/commit semantics.

The reference commits an IAVL multistore per block (SURVEY §5
checkpoint/resume: baseapp + store keys, app/app.go:268-279). This module
provides the same capabilities in a self-contained form:

- `StateStore`: committed map, merkleized by an incremental sparse Merkle
  tree (celestia_tpu_torch.smt): app hash = SMT root, commit cost O(dirty keys ·
  log) independent of total state size, and per-key inclusion/absence
  proofs for queries.
- `CacheStore.branch()`: writable overlay used for proposal handling /
  CheckTx so speculative execution never touches committed state; `write()`
  flushes to the parent (DeliverTx -> Commit flow).
- snapshot/restore for checkpoint-resume (state-sync analogue).
"""

from __future__ import annotations

import bisect
import json
import threading

from celestia_tpu_torch import smt as smt_mod


class CacheStore:
    """Write-ahead overlay over a parent store."""

    def __init__(self, parent):
        self.parent = parent
        self._writes: dict[bytes, bytes | None] = {}

    def get(self, key: bytes) -> bytes | None:
        if key in self._writes:
            return self._writes[key]
        return self.parent.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if not isinstance(key, bytes) or not isinstance(value, bytes):
            raise TypeError("store keys/values must be bytes")
        self._writes[key] = value

    def delete(self, key: bytes) -> None:
        self._writes[key] = None

    def branch(self) -> "CacheStore":
        return CacheStore(self)

    def write(self) -> None:
        """Flush this overlay into the parent. When the parent is the
        committed StateStore the whole batch lands atomically (one lock
        hold) so concurrent proof queries can never observe a
        half-applied block."""
        write_batch = getattr(self.parent, "write_batch", None)
        if write_batch is not None:
            write_batch(self._writes)
        else:
            for k, v in self._writes.items():
                if v is None:
                    self.parent.delete(k)
                else:
                    self.parent.set(k, v)
        self._writes.clear()

    def iter_prefix(self, prefix: bytes):
        """Sorted merged (key, value) list so branch and committed
        iteration agree — order-sensitive consumers must not diverge
        across commit, and both stores return a mutation-safe snapshot."""
        merged: dict[bytes, bytes] = dict(self.parent.iter_prefix(prefix))
        for k, v in self._writes.items():
            if k.startswith(prefix):
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
        return [(k, merged[k]) for k in sorted(merged)]


class StateStore:
    """Committed state with per-height app hashes (SMT root)."""

    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        # sorted key index so prefix iteration is O(log n + match) instead
        # of sorting the whole key set per call (EndBlock scans validators
        # and proposals every block; full-state sorts grow with the chain)
        self._keys: list[bytes] = []
        self.version = 0
        self.app_hashes: dict[int, bytes] = {}
        self._smt = smt_mod.SparseMerkleTree()
        self._dirty: set[bytes] = set()
        # Guards SMT mutation: the node RPC serves proofs from handler
        # threads (ThreadingHTTPServer) while the node thread commits.
        self._smt_lock = threading.Lock()

    def get(self, key: bytes) -> bytes | None:
        # lint: allow(C005) reason=handler-thread reads are lock-free by design; dict.get is GIL-atomic and values are immutable bytes, _smt_lock guards SMT mutation only
        return self._data.get(key)

    def _set_locked(self, key: bytes, value: bytes) -> None:
        if key not in self._data:
            bisect.insort(self._keys, key)
        self._data[key] = value
        self._dirty.add(key)

    def _delete_locked(self, key: bytes) -> None:
        if key in self._data:
            del self._data[key]
            idx = bisect.bisect_left(self._keys, key)
            del self._keys[idx]
        self._dirty.add(key)

    def set(self, key: bytes, value: bytes) -> None:
        if not isinstance(key, bytes) or not isinstance(value, bytes):
            raise TypeError("store keys/values must be bytes")
        # Writes take the SMT lock so a concurrent query_with_proof can
        # never observe a value newer than the root it pairs with (and so
        # _fold_dirty never iterates a mutating set).
        with self._smt_lock:
            self._set_locked(key, value)

    def delete(self, key: bytes) -> None:
        with self._smt_lock:
            self._delete_locked(key)

    def write_batch(self, writes: dict[bytes, bytes | None]) -> None:
        """Apply a block's worth of writes atomically: one lock hold, so
        query_with_proof sees either none or all of them (never a bank
        send with only the debit applied). Values of None delete.

        The key index updates by a single sorted merge (O(n + b log b))
        rather than per-key insort — a bulk import of b new keys must not
        pay b list memmoves."""
        import heapq

        for k, v in writes.items():
            if not isinstance(k, bytes) or not (v is None or isinstance(v, bytes)):
                raise TypeError("store keys/values must be bytes")
        with self._smt_lock:
            added: set[bytes] = set()
            removed: set[bytes] = set()
            for k, v in writes.items():
                if v is None:
                    if k in self._data:
                        del self._data[k]
                        removed.add(k)
                else:
                    if k not in self._data:
                        added.add(k)
                    self._data[k] = v
                self._dirty.add(k)
            # delete-then-set (or set-then-delete) within one batch nets
            # out: the index entry is unchanged (or never existed)
            both = added & removed
            added -= both
            removed -= both
            if removed or added:
                survivors = (k for k in self._keys if k not in removed)
                self._keys = list(heapq.merge(survivors, sorted(added)))

    def branch(self) -> CacheStore:
        return CacheStore(self)

    def iter_prefix(self, prefix: bytes):
        """Sorted (key, value) pairs under prefix — a consistent snapshot
        taken under the lock (callers may mutate while consuming)."""
        with self._smt_lock:
            lo = bisect.bisect_left(self._keys, prefix)
            out = []
            for i in range(lo, len(self._keys)):
                k = self._keys[i]
                if not k.startswith(prefix):
                    break
                out.append((k, self._data[k]))
        return out

    def commit(self) -> bytes:
        """Advance one version and return the deterministic app hash."""
        self.version += 1
        self.commit_hash_refresh()
        # lint: allow(C005) reason=commit runs only on the single block-production thread; handler threads read app_hashes for finalized versions that never change
        return self.app_hashes[self.version]

    # --- checkpoint / resume ---

    def snapshot(self) -> bytes:
        payload = {
            "version": self.version,
            "data": {k.hex(): v.hex() for k, v in self._data.items()},
        }
        return json.dumps(payload, sort_keys=True).encode()

    @classmethod
    def restore(cls, snapshot: bytes) -> "StateStore":
        payload = json.loads(snapshot)
        store = cls()
        store.version = payload["version"]
        store._data = {
            bytes.fromhex(k): bytes.fromhex(v) for k, v in payload["data"].items()
        }
        store._keys = sorted(store._data)
        store._dirty = set(store._data)  # rebuild the SMT from scratch
        store.commit_hash_refresh()
        return store

    def _fold_dirty(self) -> None:
        for key in self._dirty:
            value = self._data.get(key)
            self._smt.update(smt_mod.key_hash(key), value)
        self._dirty.clear()

    def commit_hash_refresh(self) -> None:
        """Fold dirty keys into the SMT; app hash = the new root.

        Incremental: cost is O(|dirty| · log), independent of |state|."""
        with self._smt_lock:
            self._fold_dirty()
            self.app_hashes[self.version] = self._smt.root

    # --- state proofs (IAVL store-proof analogue) ---

    def prove(self, key: bytes) -> smt_mod.Proof:
        """Inclusion/absence proof for key against the committed app hash."""
        return self.prove_with_root(key)[1]

    def prove_with_root(self, key: bytes) -> tuple[bytes, smt_mod.Proof]:
        """Atomically return (root, proof) so the advertised root always
        matches the proof even if a commit races on another thread."""
        return self.query_with_proof(key)[1:]

    def query_with_proof(
        self, key: bytes
    ) -> tuple[bytes | None, bytes, smt_mod.Proof]:
        """Atomic (value, root, proof): the returned value is exactly the
        one the proof proves against the returned root — the triple a
        verifying RPC client needs (IAVL "store" query with prove=true).
        Writers also hold the SMT lock, so no interleaved set() can skew
        value vs root."""
        with self._smt_lock:
            self._fold_dirty()
            return (
                self._data.get(key),
                self._smt.root,
                self._smt.prove(smt_mod.key_hash(key)),
            )

    @staticmethod
    def verify_proof(
        app_hash: bytes, key: bytes, value: bytes | None, proof: smt_mod.Proof
    ) -> bool:
        return smt_mod.verify_proof(app_hash, key, value, proof)
