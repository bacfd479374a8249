"""txsim — composable transaction load generator (port of the JAX
package's txsim.py; the port's signer uses RFC 6979 nonces).

Reference semantics: test/txsim (run.go:31, blob.go, send.go): an account
manager plus pluggable Sequences that emit txs each round against a live
chain. Drives a local Node (or any transport with broadcast_tx).

Traffic profiles: real PFB traffic is not one narrow uniform — it is a
lognormal body of small app blobs with a Pareto tail of huge rollup
batch posts, spread over namespaces whose popularity is itself heavily
skewed (a few rollups dominate). ``TrafficProfile`` models exactly
that — lognormal body + Pareto tail mixture for sizes, Zipf popularity
over a fixed namespace pool — and the shipped ``PROFILES`` cover the
scenario-engine load shapes (specs/scenarios.md): ``small-saturation``
(many tiny blobs, wide namespace spread — the mempool-saturation
shape), ``huge-rollup`` (few giant blobs, a handful of namespaces),
and ``mixed-namespaces`` (the production blend). Profile sampling is a
pure function of the caller's ``numpy`` Generator, so one seed
reproduces one byte-identical traffic trace (tests/test_txsim_profiles
pins this), and the module stays importable without the signing stack:
crypto imports are deferred into the code paths that sign.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    """One named traffic shape: blob-size mixture + namespace mix.

    Sizes draw from ``lognormal(mean=ln(size_median), sigma)`` with
    probability ``1 - tail_prob`` and from a Pareto tail
    (``tail_scale * (1 + pareto(tail_alpha))``) otherwise, clamped to
    ``[size_min, size_cap]``. Namespaces draw Zipf-weighted
    (``rank^-ns_skew``) from a pool of ``namespaces`` deterministic
    ids, so a few namespaces dominate exactly as a few rollups do."""

    name: str
    blobs_min: int = 1
    blobs_max: int = 1
    size_median: int = 1_000
    size_sigma: float = 0.8
    tail_prob: float = 0.0
    tail_alpha: float = 1.2
    tail_scale: int = 50_000
    size_min: int = 32
    size_cap: int = 1_000_000
    namespaces: int = 8
    ns_skew: float = 1.2

    def namespace_pool(self) -> list[bytes]:
        """The profile's deterministic 10-byte sub-id pool (index-
        derived, not rng-drawn: the pool is identity, the DRAW is
        random)."""
        return [i.to_bytes(10, "big") for i in range(1, self.namespaces + 1)]

    def _ns_weights(self) -> np.ndarray:
        w = np.arange(1, self.namespaces + 1, dtype=np.float64) ** -self.ns_skew
        return w / w.sum()

    def sample_sizes(self, rng: np.random.Generator, n: int) -> list[int]:
        """n blob sizes from the body+tail mixture (seed-deterministic)."""
        body = rng.lognormal(mean=float(np.log(self.size_median)),
                             sigma=self.size_sigma, size=n)
        tail = self.tail_scale * (1.0 + rng.pareto(self.tail_alpha, size=n))
        pick_tail = rng.random(n) < self.tail_prob
        sizes = np.where(pick_tail, tail, body)
        return [int(v) for v in np.clip(sizes, self.size_min, self.size_cap)]

    def sample_namespaces(self, rng: np.random.Generator,
                          n: int) -> list[bytes]:
        """n Zipf-weighted sub-ids from the pool (seed-deterministic)."""
        pool = self.namespace_pool()
        idx = rng.choice(self.namespaces, size=n, p=self._ns_weights())
        return [pool[int(i)] for i in idx]

    def sample_pfb(self, rng: np.random.Generator) -> list[tuple[bytes, int]]:
        """One PFB as [(sub_id, size), ...] — the transport-agnostic
        unit both BlobSequence (signed path) and the scenario engine's
        crypto-free broadcast driver consume."""
        n = int(rng.integers(self.blobs_min, self.blobs_max + 1))
        return list(zip(self.sample_namespaces(rng, n),
                        self.sample_sizes(rng, n)))


PROFILES: dict[str, TrafficProfile] = {p.name: p for p in (
    # mempool saturation: floods of tiny app blobs across many
    # namespaces — count pressure, not byte pressure
    TrafficProfile(name="small-saturation", blobs_min=2, blobs_max=8,
                   size_median=300, size_sigma=0.6, tail_prob=0.0,
                   size_cap=4_096, namespaces=32, ns_skew=0.4),
    # rollup batch posts: one huge blob per PFB, nearly all bytes in
    # the Pareto tail, a handful of namespaces — byte pressure
    TrafficProfile(name="huge-rollup", blobs_min=1, blobs_max=1,
                   size_median=60_000, size_sigma=0.5, tail_prob=0.5,
                   tail_alpha=1.1, tail_scale=120_000,
                   size_cap=1_900_000, namespaces=4, ns_skew=1.5),
    # the production blend: lognormal body of small blobs with a 5%
    # heavy tail of rollup posts, Zipf-skewed namespace popularity
    TrafficProfile(name="mixed-namespaces", blobs_min=1, blobs_max=4,
                   size_median=1_200, size_sigma=1.0, tail_prob=0.05,
                   tail_alpha=1.3, tail_scale=80_000,
                   size_cap=1_900_000, namespaces=16, ns_skew=1.2),
)}


def profile(name: str) -> TrafficProfile:
    """Look up a shipped profile by name (KeyError names the options)."""
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown traffic profile {name!r}; one of {sorted(PROFILES)}"
        ) from None


class Sequence:
    """One stream of related transactions."""

    def init(self, signer, rng: np.random.Generator) -> None:
        self.signer = signer
        self.rng = rng

    def next_tx(self):  # -> TxResult | None
        raise NotImplementedError


@dataclasses.dataclass
class BlobSequence(Sequence):
    """PFB storm: random blobs in a size/count range, or — when
    ``profile`` names a TrafficProfile — the profile's heavy-tail
    size/namespace mixture. ref: test/txsim/blob.go"""

    size_min: int = 100
    size_max: int = 10_000
    blobs_per_pfb: int = 1
    profile: str | None = None

    def next_tx(self):
        from celestia_tpu_torch import blob as blob_pkg
        from celestia_tpu_torch import namespace as ns

        blobs = []
        if self.profile is not None:
            for sub_id, size in profile(self.profile).sample_pfb(self.rng):
                data = self.rng.integers(0, 256, size=size,
                                         dtype=np.uint8).tobytes()
                blobs.append(blob_pkg.new_blob(ns.new_v0(sub_id), data, 0))
            return self.signer.submit_pay_for_blob(blobs)
        for _ in range(self.blobs_per_pfb):
            size = int(self.rng.integers(self.size_min, self.size_max + 1))
            sub_id = self.rng.integers(0, 256, size=10, dtype=np.uint8).tobytes()
            data = self.rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            blobs.append(blob_pkg.new_blob(ns.new_v0(sub_id), data, 0))
        return self.signer.submit_pay_for_blob(blobs)


@dataclasses.dataclass
class SendSequence(Sequence):
    """Bank transfer stream. ref: test/txsim/send.go"""

    to_address: str = ""
    amount: int = 100

    def next_tx(self):
        from celestia_tpu_torch.tx import Fee
        from celestia_tpu_torch.x.bank import MsgSend

        to = self.to_address or self.signer.address()
        return self.signer.submit_tx(
            [MsgSend(self.signer.address(), to, self.amount)],
            Fee(amount=200_000, gas_limit=200_000),
        )


@dataclasses.dataclass
class StakeSequence(Sequence):
    """Staking op stream: delegate, then randomly undelegate portions —
    exercising valset/blobstream churn. ref: test/txsim/stake.go

    The undelegatable amount is read from COMMITTED chain state rather
    than tracked from CheckTx results: a tx can pass CheckTx and still
    be dropped from a full square or fail at DeliverTx, so client-side
    counters drift."""

    validator: str = ""
    initial_stake: int = 5_000_000

    def next_tx(self):
        from celestia_tpu_torch.tx import Fee
        from celestia_tpu_torch.x.staking import MsgDelegate, MsgUndelegate

        fee = Fee(amount=200_000, gas_limit=200_000)
        delegated = self.signer.transport.app.staking.get_delegation(
            self.signer.address(), self.validator
        )
        if delegated == 0 or self.rng.random() < 0.7:
            return self.signer.submit_tx(
                [MsgDelegate(self.signer.address(), self.validator,
                             self.initial_stake)],
                fee,
            )
        amount = int(self.rng.integers(1, delegated + 1))
        return self.signer.submit_tx(
            [MsgUndelegate(self.signer.address(), self.validator, amount)],
            fee,
        )


def run(
    node,
    master_key,
    sequences: list[Sequence],
    rounds: int,
    seed: int = 0,
    blocks_per_round: int = 1,
    funding_per_sequence: int = 10_000_000_000,
) -> dict:
    """Run the sequences for N rounds, producing blocks in between.

    Each sequence gets its own funded account (ref: test/txsim/run.go's
    AccountManager) — the square orders blob txs after normal txs, so one
    account cannot mix both kinds in a single block.
    """
    from celestia_tpu_torch.crypto import PrivateKey
    from celestia_tpu_torch.tx import Fee
    from celestia_tpu_torch.user import Signer
    from celestia_tpu_torch.x.bank import MsgSend

    rng = np.random.default_rng(seed)
    master = Signer.setup_single(master_key, node)
    seq_keys = [
        PrivateKey.from_secret(f"txsim-seq-{seed}-{i}".encode())
        for i in range(len(sequences))
    ]
    for key in seq_keys:
        res = master.submit_tx(
            [MsgSend(master.address(), key.bech32_address(), funding_per_sequence)],
            Fee(amount=200_000, gas_limit=200_000),
        )
        if res.code != 0:
            raise RuntimeError(f"funding failed: {res.log}")
    node.produce_block()

    for seq, key in zip(sequences, seq_keys):
        seq.init(Signer.setup_single(key, node), rng)

    stats = {"submitted": 0, "accepted": 0, "rejected": 0, "blocks": 0}
    for _ in range(rounds):
        for seq in sequences:
            res = seq.next_tx()
            stats["submitted"] += 1
            if res is not None and res.code == 0:
                stats["accepted"] += 1
            else:
                stats["rejected"] += 1
        for _ in range(blocks_per_round):
            node.produce_block()
            stats["blocks"] += 1
    return stats
