"""The port's txsim (``celestia_tpu_torch/txsim.py``) against the JAX
package's, on the CPU.

Profile sampling is a pure function of the caller's numpy Generator, so the
two packages draw the same sizes, namespaces and PFBs from one seed (equal
values, tolerance none). The sequences build equal blobs and messages through
a recording signer. ``run`` drives a JAX Node and a port Node (each App on the
native backend) with the same master key and seed: every tx either side
broadcast has equal body and auth-info bytes, and every signature verifies
under the other package's verifier. The signatures themselves differ: the
port signs with an RFC 6979 nonce, the JAX package with OpenSSL's random one
(ROADMAP Queue 3).
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

from celestia_tpu import txsim as jtx
from celestia_tpu_torch import txsim as ptx

NAMES = sorted(jtx.PROFILES)


def test_the_profiles_are_the_jax_profiles():
    assert sorted(ptx.PROFILES) == NAMES
    for name in NAMES:
        assert dataclasses.asdict(ptx.PROFILES[name]) == dataclasses.asdict(jtx.PROFILES[name])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 11, 424242])
def test_one_seed_draws_the_jax_trace(name, seed):
    def trace(mod):
        rng = np.random.default_rng(seed)
        p = mod.profile(name)
        return (p.sample_sizes(rng, 64), p.sample_namespaces(rng, 64),
                [p.sample_pfb(rng) for _ in range(16)])

    assert trace(ptx) == trace(jtx)


@pytest.mark.parametrize("name", NAMES)
def test_namespace_pool_and_weights_equal(name):
    p, j = ptx.profile(name), jtx.profile(name)
    assert p.namespace_pool() == j.namespace_pool()
    assert np.array_equal(p._ns_weights(), j._ns_weights())


def test_bounds_respected_like_jax():
    kw = dict(name="t", size_median=100, tail_prob=1.0, tail_scale=10_000_000,
              size_cap=2_048, size_min=64)
    got = ptx.TrafficProfile(**kw).sample_sizes(np.random.default_rng(5), 500)
    assert got == jtx.TrafficProfile(**kw).sample_sizes(np.random.default_rng(5), 500)
    assert min(got) >= 64 and max(got) <= 2_048


def test_unknown_profile_names_options():
    with pytest.raises(KeyError, match="small-saturation"):
        ptx.profile("nope")


def test_the_module_imports_without_the_signing_stack():
    code = ("import sys; import celestia_tpu_torch.txsim as t; "
            "assert 'celestia_tpu_torch.crypto' not in sys.modules; "
            "assert 'celestia_tpu_torch.user' not in sys.modules; print(len(t.PROFILES))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3"


class _Recorder:
    """A signer that records what a sequence submits."""

    def __init__(self, address: str = "celestia1recorder"):
        self.addr = address
        self.calls: list = []

    def address(self) -> str:
        return self.addr

    def submit_pay_for_blob(self, blobs):
        self.calls.append(("pfb", [(b.namespace_id, b.namespace_version, b.data, b.share_version)
                                   for b in blobs]))

    def submit_tx(self, msgs, fee):
        self.calls.append(("tx", [vars(m) for m in msgs], (fee.amount, fee.gas_limit)))


@pytest.mark.parametrize("kind", ["random", "small-saturation", "mixed-namespaces",
                                  "huge-rollup"])
def test_the_blob_sequence_builds_the_jax_blobs(kind):
    profile = None if kind == "random" else kind

    def calls(mod):
        seq = mod.BlobSequence(size_min=10, size_max=400, blobs_per_pfb=2, profile=profile)
        rec = _Recorder()
        seq.init(rec, np.random.default_rng(7))
        for _ in range(4):
            seq.next_tx()
        return rec.calls

    assert calls(ptx) == calls(jtx)


def test_the_send_sequence_builds_the_jax_messages():
    def calls(mod):
        seq = mod.SendSequence(to_address="celestia1other", amount=77)
        rec = _Recorder()
        seq.init(rec, np.random.default_rng(1))
        seq.next_tx()
        mod.SendSequence(amount=5).init(rec, None)
        return rec.calls

    assert calls(ptx) == calls(jtx)


@pytest.mark.parametrize("delegated", [0, 3_000_000])
def test_the_stake_sequence_builds_the_jax_messages(delegated):
    class Staking:
        def get_delegation(self, _delegator, _validator):
            return delegated

    def calls(mod):
        rec = _Recorder()
        rec.transport = type("T", (), {"app": type("A", (), {"staking": Staking()})()})()
        seq = mod.StakeSequence(validator="celestiavaloper1v", initial_stake=1_000)
        seq.init(rec, np.random.default_rng(3))
        for _ in range(6):
            seq.next_tx()
        return rec.calls

    assert calls(ptx) == calls(jtx)


CHAIN = "txsim-test"
MASTER = b"txsim-master"


def _run(pkg: str, monkeypatch):
    """txsim.run on one package's Node; returns (stats, raw txs broadcast)."""
    if pkg == "jax":
        from celestia_tpu.app.app import App
        from celestia_tpu.crypto import PrivateKey
        from celestia_tpu.node.node import Node
        app = App(chain_id=CHAIN, extend_backend="native")
        mod = jtx
    else:
        from celestia_tpu_torch.app.app import App
        from celestia_tpu_torch.crypto import PrivateKey
        from celestia_tpu_torch.node.node import Node
        app = App(chain_id=CHAIN, extend_backend="native", device="cpu")
        mod = ptx
    key = PrivateKey.from_secret(MASTER)
    app.init_chain({key.bech32_address(): 10**13}, genesis_time=0.0)
    node = Node(app)
    node.produce_block(15.0)
    sent: list[bytes] = []
    real = node.broadcast_tx

    def broadcast(raw: bytes):
        sent.append(raw)
        return real(raw)

    monkeypatch.setattr(node, "broadcast_tx", broadcast)
    seqs = [mod.BlobSequence(size_min=100, size_max=3_000, blobs_per_pfb=2),
            mod.SendSequence(amount=1_000)]
    stats = mod.run(node, key, seqs, rounds=2, seed=5, funding_per_sequence=10**9)
    return stats, sent


def _split(raw: bytes, pkg: str):
    """(inner tx, blobs) of a broadcast tx."""
    if pkg == "jax":
        from celestia_tpu import blob as blob_mod
        from celestia_tpu.tx import Tx
    else:
        from celestia_tpu_torch import blob as blob_mod
        from celestia_tpu_torch.tx import Tx
    btx, is_blob = blob_mod.unmarshal_blob_tx(raw)
    if not is_blob:
        return Tx.unmarshal(raw), []
    return Tx.unmarshal(btx.tx), [b.marshal() for b in btx.blobs]


def test_run_broadcasts_the_jax_txs_signed_so_each_side_verifies_the_other(monkeypatch):
    from celestia_tpu import crypto as jcrypto
    from celestia_tpu.tx import sign_doc_bytes
    from celestia_tpu_torch import crypto as pcrypto

    jstats, jsent = _run("jax", monkeypatch)
    pstats, psent = _run("port", monkeypatch)
    assert pstats == jstats and pstats["accepted"] == pstats["submitted"] == 4
    assert len(psent) == len(jsent) == 2 + 4  # two fundings, then 2 rounds of 2
    numbers = {}
    for jraw, praw in zip(jsent, psent):
        (jt, jblobs), (pt, pblobs) = _split(jraw, "jax"), _split(praw, "port")
        assert pt.body_bytes() == jt.body_bytes()
        assert pt.auth_info_bytes() == jt.auth_info_bytes()
        assert pblobs == jblobs
        pub = pt.signer_infos[0].public_key
        assert pub == jt.signer_infos[0].public_key
        # account numbers follow genesis, then the fundings, on both chains
        number = numbers.setdefault(pub, len(numbers))
        doc = sign_doc_bytes(pt.body_bytes(), pt.auth_info_bytes(), CHAIN, number)
        assert jcrypto.verify_signature(pub, doc, pt.signatures[0])
        assert pcrypto.verify_signature(pub, doc, jt.signatures[0])
        assert not pcrypto.verify_signature(pub, doc + b"x", jt.signatures[0])
