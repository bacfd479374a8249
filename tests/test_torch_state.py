"""The port's sparse Merkle tree and state store against the JAX package's:
roots, proofs, verification and marshalled proofs over seeded sequences of
updates and deletes; commit roots, branches and their writes, write
batches, and snapshot and restore bytes."""

import json

import numpy as np
import pytest

from celestia_tpu import smt as jsmt
from celestia_tpu import state as jstate
from celestia_tpu_torch import smt as psmt
from celestia_tpu_torch import state as pstate


def _ops(seed: int, n: int, keys: int):
    """n seeded (key, value | None) operations over a pool of keys, so
    keys are set, overwritten and deleted (a quarter are deletes)."""
    r = np.random.default_rng(seed)
    pool = [r.integers(0, 256, int(r.integers(1, 40)), dtype=np.uint8).tobytes()
            for _ in range(keys)]
    for _ in range(n):
        key = pool[int(r.integers(keys))]
        if r.random() < 0.25:
            yield key, None
        else:
            yield key, r.integers(0, 256, int(r.integers(0, 64)), dtype=np.uint8).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smt_roots_proofs_and_verification_equal_jax(seed):
    mine, theirs = psmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    values: dict[bytes, bytes] = {}
    assert mine.root == theirs.root == psmt.DEFAULT[0]
    for key, value in _ops(seed, 60, 12):
        kh = psmt.key_hash(key)
        assert kh == jsmt.key_hash(key)
        mine.update(kh, value)
        theirs.update(kh, value)
        assert mine.root == theirs.root
        if value is None:
            values.pop(key, None)
        else:
            values[key] = value
    assert mine.hash_count == theirs.hash_count
    absent = b"never-set"
    for key in sorted(values) + [absent]:
        value = values.get(key)
        pm, pj = mine.prove(psmt.key_hash(key)), theirs.prove(jsmt.key_hash(key))
        doc = pm.marshal()
        assert doc == pj.marshal()
        assert json.loads(json.dumps(doc)) == doc
        assert psmt.Proof.unmarshal(doc) == pm
        # each side verifies the other's proof, and refuses a wrong value
        assert psmt.verify_proof(mine.root, key, value, psmt.Proof.unmarshal(pj.marshal()))
        assert jsmt.verify_proof(theirs.root, key, value, jsmt.Proof.unmarshal(doc))
        wrong = b"x" if value is None else None
        assert not psmt.verify_proof(mine.root, key, wrong, pm)
        assert not jsmt.verify_proof(theirs.root, key, wrong, pj)


def test_smt_refuses_a_proof_of_another_key_or_depth():
    tree = psmt.SparseMerkleTree()
    tree.update(psmt.key_hash(b"a"), b"1")
    proof = tree.prove(psmt.key_hash(b"a"))
    assert psmt.verify_proof(tree.root, b"a", b"1", proof)
    assert not psmt.verify_proof(tree.root, b"b", b"1", proof)
    short = psmt.Proof(proof.keyhash, proof.siblings[:-1])
    assert not psmt.verify_proof(tree.root, b"a", b"1", short)
    assert not jsmt.verify_proof(tree.root, b"a", b"1", jsmt.Proof(short.keyhash, short.siblings))


def _dump(store) -> list:
    return store.iter_prefix(b"")


@pytest.mark.parametrize("seed", [3, 4])
def test_state_store_commits_branches_and_writes_equal_jax(seed):
    """Direct sets and deletes, a branch of a branch written into its
    parent and then into the store, a write batch: after each block the
    commit root, the app hashes and every key and value agree."""
    mine, theirs = pstate.StateStore(), jstate.StateStore()
    ops = list(_ops(seed, 120, 20))
    for block in range(4):
        chunk = ops[block * 30:(block + 1) * 30]
        direct, branched, batch = chunk[:10], chunk[10:20], chunk[20:]
        for key, value in direct:
            for s in (mine, theirs):
                s.set(key, value) if value is not None else s.delete(key)
        outer = (mine.branch(), theirs.branch())
        inner = tuple(b.branch() for b in outer)
        for key, value in branched:
            for b in inner:
                b.set(key, value) if value is not None else b.delete(key)
            assert _dump(inner[0]) == _dump(inner[1])
            assert inner[0].get(key) == inner[1].get(key) == value
        for b in inner:
            b.write()
        assert _dump(outer[0]) == _dump(outer[1])
        assert _dump(mine) == _dump(theirs)  # nothing reached the store yet
        for b in outer:
            b.write()
        writes = dict(batch)
        mine.write_batch(writes)
        theirs.write_batch(writes)
        assert _dump(mine) == _dump(theirs)
        assert mine.commit() == theirs.commit()
        assert mine.version == theirs.version == block + 1
    assert mine.app_hashes == theirs.app_hashes
    for key in [k for k, _ in _dump(mine)][:5] + [b"absent"]:
        vm, rm, pm = mine.query_with_proof(key)
        vj, rj, pj = theirs.query_with_proof(key)
        assert (vm, rm, pm.marshal()) == (vj, rj, pj.marshal())
        assert pstate.StateStore.verify_proof(rm, key, vm, pm)
        assert jstate.StateStore.verify_proof(rj, key, vm, jsmt.Proof.unmarshal(pm.marshal()))
        assert mine.prove(key).marshal() == pj.marshal()


def test_state_store_snapshot_and_restore_bytes_equal_jax():
    """A snapshot is the same bytes on both sides, and each package
    restores the other's to the same version, app hash and contents."""
    mine, theirs = pstate.StateStore(), jstate.StateStore()
    for key, value in _ops(7, 50, 15):
        for s in (mine, theirs):
            s.set(key, value) if value is not None else s.delete(key)
    mine.commit()
    theirs.commit()
    snap = mine.snapshot()
    assert snap == theirs.snapshot()
    back_mine = pstate.StateStore.restore(theirs.snapshot())
    back_theirs = jstate.StateStore.restore(snap)
    assert back_mine.version == back_theirs.version == 1
    assert back_mine.app_hashes[1] == back_theirs.app_hashes[1] == mine.app_hashes[1]
    assert _dump(back_mine) == _dump(back_theirs) == _dump(mine)
    assert back_mine.snapshot() == snap


def test_store_values_must_be_bytes_on_both_sides():
    for mod in (pstate, jstate):
        store = mod.StateStore()
        with pytest.raises(TypeError):
            store.set(b"k", "text")
        with pytest.raises(TypeError):
            store.branch().set("k", b"v")
        with pytest.raises(TypeError):
            store.write_batch({b"k": 1})
