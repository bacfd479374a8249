"""02-client / 07-tendermint light-client analogue.

The reference verifies counterparty chains via ibc-go's 02-client core
wired at app/app.go:370-385 with the 07-tendermint client: a ClientState
tracks a trusted validator set; MsgUpdateClient carries a signed header
whose commit must be signed by >2/3 of the trusted voting power; packet
messages then prove commitment (non-)membership against the verified
app hash instead of being trusted on the relayer's word.

This module is the tpu-framework equivalent over the SMT state
commitment (celestia_tpu_torch.smt) and secp256k1 validator keys
(celestia_tpu_torch.crypto):

- `ClientState`: counterparty chain id, latest verified height, the
  trusted validator set (pubkey, power) used to check the next update,
  and a frozen flag set on proven misbehaviour.
- `ConsensusState` (per verified height): the counterparty app hash and
  header time — exactly what packet proof verification and timeout
  elapse checks consume (ibc-go ConsensusState{Timestamp, Root}).
- `update_client`: sequential verification — signatures over the
  header's deterministic sign bytes from validators in the *trusted*
  set carrying > 2/3 of trusted power (stricter than tendermint's 1/3
  skipping trust level; documented divergence: no connection layer, the
  channel binds a client directly).
- `submit_misbehaviour`: two validly-signed conflicting headers at one
  height freeze the client (02-client CheckMisbehaviourAndUpdateState).
- `verify_membership` / `verify_non_membership`: SMT proof verification
  against the stored consensus app hash (ibc-go 23-commitment role).
  Both chains run this framework, so store key schemes agree; the
  channel keeper's commitment/receipt/ack keys are the proof paths.

Trust-window semantics (ibc-go parity):
- each ClientState carries a `trusting_period`; `update_client` rejects
  headers once the latest verified consensus state is older than it
  (status Expired) — the long-range-attack guard;
- `submit_misbehaviour` verifies each conflicting header against the
  valset trusted at ITS height (stored epoch history), so equivocation
  inside an earlier trusted epoch still freezes the client after later
  valset rotations.

Divergences from ibc-go (documented, deliberate):
- the header carries the full next validator set instead of a
  NextValidatorsHash + later reveal — same trust result, one fewer
  indirection;
- update rule is >2/3 of *trusted* power (adjacent-style), so there is
  no skipping trust-level parameter;
- no per-client max-clock-drift parameter: header time must be strictly
  newer than the latest consensus state, but future-dated headers are
  not bounded (both chains here run this framework's consensus with
  shared wall clocks).
"""

from __future__ import annotations

import dataclasses
import json

from celestia_tpu_torch import smt as smt_mod

CLIENT_STATE_PREFIX = b"ibc/client/state/"
CONSENSUS_STATE_PREFIX = b"ibc/client/consensus/"
VALSET_PREFIX = b"ibc/client/valset/"
CLIENT_COUNTER_KEY = b"ibc/client/nextSequence"
CLIENT_TYPE = "07-tendermint"

TRUST_NUMERATOR = 2
TRUST_DENOMINATOR = 3

# ibc-go 07-tendermint TrustingPeriod: updates are rejected once the
# latest verified consensus state is older than this — validators who
# unbonded on the counterparty but kept their keys can otherwise advance
# a stale client to a forged state (the long-range attack). 14 days,
# matching the common production choice of 2/3 of a 21-day unbonding.
DEFAULT_TRUSTING_PERIOD = 14 * 24 * 3600.0

# the app's consensus block-time key (celestia_tpu_torch.x.bank.BLOCK_TIME_KEY;
# duplicated literal to keep this module import-cycle-free)
_BLOCK_TIME_KEY = b"ctx/blockTime"


@dataclasses.dataclass
class ValidatorInfo:
    """One trusted validator: compressed secp256k1 pubkey + voting power."""

    pubkey: str  # hex, 33-byte compressed SEC1
    power: int

    def to_json(self) -> dict:
        return {"pubkey": self.pubkey, "power": self.power}

    @classmethod
    def from_json(cls, d: dict) -> "ValidatorInfo":
        return cls(pubkey=d["pubkey"], power=int(d["power"]))


@dataclasses.dataclass
class Header:
    """Light-client header: what the counterparty's validators sign.

    tendermint's Header + the full next valset (see module docstring)."""

    chain_id: str
    height: int
    time: float
    app_hash: bytes
    validators: list[ValidatorInfo]  # valset trusted for the NEXT update

    def sign_bytes(self) -> bytes:
        """Deterministic canonical encoding every signer commits to."""
        return json.dumps(
            self.to_json(), sort_keys=True, separators=(",", ":")
        ).encode()

    def to_json(self) -> dict:
        return {
            "chain_id": self.chain_id,
            "height": self.height,
            "time": self.time,
            "app_hash": self.app_hash.hex(),
            "validators": [v.to_json() for v in self.validators],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Header":
        return cls(
            chain_id=d["chain_id"],
            height=int(d["height"]),
            time=float(d["time"]),
            app_hash=bytes.fromhex(d["app_hash"]),
            validators=[ValidatorInfo.from_json(v) for v in d["validators"]],
        )


@dataclasses.dataclass
class SignedHeader:
    """Header + commit: (pubkey, signature) pairs over header.sign_bytes().

    tendermint SignedHeader{Header, Commit}; signatures are the
    framework's 64-byte low-S (r ‖ s) secp256k1 form."""

    header: Header
    signatures: list[tuple[str, str]]  # (pubkey hex, signature hex)

    def to_json(self) -> dict:
        return {
            "header": self.header.to_json(),
            "signatures": [[p, s] for p, s in self.signatures],
        }

    @classmethod
    def from_json(cls, d: dict) -> "SignedHeader":
        return cls(
            header=Header.from_json(d["header"]),
            signatures=[(p, s) for p, s in d["signatures"]],
        )


@dataclasses.dataclass
class ClientState:
    """02-client ClientState analogue (07-tendermint subset)."""

    client_id: str
    chain_id: str
    latest_height: int
    validators: list[ValidatorInfo]  # trusted set for the next update
    frozen: bool = False
    trusting_period: float = DEFAULT_TRUSTING_PERIOD

    def marshal(self) -> bytes:
        return json.dumps(
            {
                "client_id": self.client_id,
                "chain_id": self.chain_id,
                "latest_height": self.latest_height,
                "validators": [v.to_json() for v in self.validators],
                "frozen": self.frozen,
                "trusting_period": self.trusting_period,
            },
            sort_keys=True,
        ).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "ClientState":
        d = json.loads(raw)
        return cls(
            client_id=d["client_id"],
            chain_id=d["chain_id"],
            latest_height=int(d["latest_height"]),
            validators=[ValidatorInfo.from_json(v) for v in d["validators"]],
            frozen=bool(d["frozen"]),
            trusting_period=float(
                d.get("trusting_period", DEFAULT_TRUSTING_PERIOD)
            ),
        )


@dataclasses.dataclass
class ConsensusState:
    """Per-height verified snapshot: app hash (proof root) + header time
    (timeout elapse clock). ibc-go ConsensusState{Timestamp, Root}."""

    app_hash: bytes
    timestamp: float

    def marshal(self) -> bytes:
        return json.dumps(
            {"app_hash": self.app_hash.hex(), "timestamp": self.timestamp},
            sort_keys=True,
        ).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "ConsensusState":
        d = json.loads(raw)
        return cls(
            app_hash=bytes.fromhex(d["app_hash"]),
            timestamp=float(d["timestamp"]),
        )


def _consensus_key(client_id: str, height: int) -> bytes:
    return (
        CONSENSUS_STATE_PREFIX
        + client_id.encode()
        + b"/"
        + height.to_bytes(8, "big")
    )


def _valset_key(client_id: str, height: int) -> bytes:
    return VALSET_PREFIX + client_id.encode() + b"/" + height.to_bytes(8, "big")


def verify_commit(
    trusted: list[ValidatorInfo], header: Header,
    signatures: list[tuple[str, str]],
) -> None:
    """Raise unless > 2/3 of the trusted power validly signed the header.

    Each pubkey counts at most once; signatures from keys outside the
    trusted set contribute nothing (they may appear — a relayer can
    forward a commit with future-valset signatures mixed in)."""
    sign_bytes = header.sign_bytes()
    power_of = {v.pubkey: v.power for v in trusted}
    total = sum(power_of.values())
    if total <= 0:
        raise ValueError("trusted validator set has no power")
    signed = 0
    seen: set[str] = set()
    # lazy: header verification needs the cryptography wheel, but the
    # module (and the App importing it) must load without it
    from celestia_tpu_torch.crypto import verify_signature

    for pubkey_hex, sig_hex in signatures:
        if pubkey_hex in seen or pubkey_hex not in power_of:
            continue
        # an invalid signature contributes nothing but does not poison
        # the commit (tendermint counts only valid precommits — evidence
        # forwarded verbatim may carry garbage entries)
        if not verify_signature(
            bytes.fromhex(pubkey_hex), sign_bytes, bytes.fromhex(sig_hex)
        ):
            continue
        seen.add(pubkey_hex)
        signed += power_of[pubkey_hex]
    if signed * TRUST_DENOMINATOR <= total * TRUST_NUMERATOR:
        raise ValueError(
            f"insufficient voting power signed the header: {signed}/{total} "
            f"(need > {TRUST_NUMERATOR}/{TRUST_DENOMINATOR})"
        )


URL_MSG_CREATE_CLIENT = "/ibc.core.client.v1.MsgCreateClient"
URL_MSG_UPDATE_CLIENT = "/ibc.core.client.v1.MsgUpdateClient"
URL_MSG_SUBMIT_MISBEHAVIOUR = "/ibc.core.client.v1.MsgSubmitMisbehaviour"


def _register_client_msgs():
    from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt
    from celestia_tpu_torch.tx import register_msg

    def _json_field(tag: int, obj: dict) -> bytes:
        return _field_bytes(
            tag, json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
        )

    @register_msg(URL_MSG_CREATE_CLIENT)
    @dataclasses.dataclass
    class MsgCreateClient:
        """Create a light client from an initial trusted header
        (ibc-go MsgCreateClient: ClientState + initial ConsensusState).
        The client id is assigned server-side; the tracked chain id is
        the initial header's."""

        initial_header: Header
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return _json_field(1, self.initial_header.to_json()) + _field_bytes(
                2, self.signer.encode()
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgCreateClient":
            signer = ""
            header = None
            for tag, wt, val in _parse_fields(raw):
                _require_wt(wt, 2, tag)
                if tag == 1:
                    header = Header.from_json(json.loads(bytes(val)))
                elif tag == 2:
                    signer = bytes(val).decode()
            if header is None:
                raise ValueError("MsgCreateClient without initial header")
            return cls(header, signer)

        def validate_basic(self) -> None:
            if not self.signer:
                raise ValueError("missing signer")
            if not self.initial_header.chain_id:
                raise ValueError("initial header carries no chain id")
            if not self.initial_header.validators:
                raise ValueError("initial header carries no validator set")

    @register_msg(URL_MSG_UPDATE_CLIENT)
    @dataclasses.dataclass
    class MsgUpdateClient:
        """Advance a client with a new signed header (ibc-go
        MsgUpdateClient)."""

        client_id: str
        signed_header: SignedHeader
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.client_id.encode())
                + _json_field(2, self.signed_header.to_json())
                + _field_bytes(3, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgUpdateClient":
            client_id = signer = ""
            signed = None
            for tag, wt, val in _parse_fields(raw):
                _require_wt(wt, 2, tag)
                if tag == 1:
                    client_id = bytes(val).decode()
                elif tag == 2:
                    signed = SignedHeader.from_json(json.loads(bytes(val)))
                elif tag == 3:
                    signer = bytes(val).decode()
            if signed is None:
                raise ValueError("MsgUpdateClient without header")
            return cls(client_id, signed, signer)

        def validate_basic(self) -> None:
            if not self.client_id:
                raise ValueError("missing client id")
            if not self.signer:
                raise ValueError("missing signer")
            if not self.signed_header.signatures:
                raise ValueError("signed header carries no signatures")

    @register_msg(URL_MSG_SUBMIT_MISBEHAVIOUR)
    @dataclasses.dataclass
    class MsgSubmitMisbehaviour:
        """Freeze a client on proof of equivocation (ibc-go
        MsgSubmitMisbehaviour: two conflicting signed headers)."""

        client_id: str
        header_a: SignedHeader
        header_b: SignedHeader
        signer: str

        def get_signers(self) -> list[str]:
            return [self.signer]

        def marshal(self) -> bytes:
            return (
                _field_bytes(1, self.client_id.encode())
                + _json_field(2, self.header_a.to_json())
                + _json_field(3, self.header_b.to_json())
                + _field_bytes(4, self.signer.encode())
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgSubmitMisbehaviour":
            client_id = signer = ""
            a = b = None
            for tag, wt, val in _parse_fields(raw):
                _require_wt(wt, 2, tag)
                if tag == 1:
                    client_id = bytes(val).decode()
                elif tag == 2:
                    a = SignedHeader.from_json(json.loads(bytes(val)))
                elif tag == 3:
                    b = SignedHeader.from_json(json.loads(bytes(val)))
                elif tag == 4:
                    signer = bytes(val).decode()
            if a is None or b is None:
                raise ValueError("MsgSubmitMisbehaviour missing headers")
            return cls(client_id, a, b, signer)

        def validate_basic(self) -> None:
            if not self.client_id:
                raise ValueError("missing client id")
            if not self.signer:
                raise ValueError("missing signer")

    return MsgCreateClient, MsgUpdateClient, MsgSubmitMisbehaviour


MsgCreateClient, MsgUpdateClient, MsgSubmitMisbehaviour = _register_client_msgs()


class ClientKeeper:
    """02-client keeper over the framework store."""

    def __init__(self, store):
        self.store = store

    # --- client lifecycle ---

    def create_client(
        self,
        initial: Header,
        trusting_period: float = DEFAULT_TRUSTING_PERIOD,
    ) -> ClientState:
        """Create a client from an initial trusted header (the social
        genesis trust assumption every light client starts from —
        ibc-go MsgCreateClient with an initial consensus state).

        The client id is generated server-side (`07-tendermint-<n>`,
        ibc-go's scheme) — caller-chosen ids would let an attacker squat
        a well-known id with a validator set they control before the
        honest client is created. The tracked chain id comes from the
        initial header itself, so the genesis consensus state can never
        belong to a different chain than the client claims to track."""
        if not initial.validators:
            raise ValueError("initial header carries no validator set")
        if not initial.chain_id:
            raise ValueError("initial header carries no chain id")
        seq_raw = self.store.get(CLIENT_COUNTER_KEY)
        seq = int.from_bytes(seq_raw, "big") if seq_raw else 0
        client_id = f"{CLIENT_TYPE}-{seq}"
        self.store.set(CLIENT_COUNTER_KEY, (seq + 1).to_bytes(8, "big"))
        if trusting_period <= 0:
            raise ValueError("trusting period must be positive")
        cs = ClientState(
            client_id=client_id,
            chain_id=initial.chain_id,
            latest_height=initial.height,
            validators=list(initial.validators),
            trusting_period=trusting_period,
        )
        self._set_client(cs)
        self.store.set(
            _consensus_key(client_id, initial.height),
            ConsensusState(initial.app_hash, initial.time).marshal(),
        )
        self._store_valset(client_id, initial.height, initial.validators)
        return cs

    def next_client_id(self) -> str:
        """The id create_client will assign next (for callers that need
        to know it before submitting — ibc-go emits it as an event)."""
        seq_raw = self.store.get(CLIENT_COUNTER_KEY)
        return f"{CLIENT_TYPE}-{int.from_bytes(seq_raw, 'big') if seq_raw else 0}"

    def get_client(self, client_id: str) -> ClientState | None:
        raw = self.store.get(CLIENT_STATE_PREFIX + client_id.encode())
        return ClientState.unmarshal(raw) if raw else None

    def _set_client(self, cs: ClientState) -> None:
        self.store.set(CLIENT_STATE_PREFIX + cs.client_id.encode(), cs.marshal())

    def get_consensus_state(
        self, client_id: str, height: int
    ) -> ConsensusState | None:
        raw = self.store.get(_consensus_key(client_id, height))
        return ConsensusState.unmarshal(raw) if raw else None

    def _require_active(self, client_id: str) -> ClientState:
        cs = self.get_client(client_id)
        if cs is None:
            raise ValueError(f"unknown client {client_id}")
        if cs.frozen:
            raise ValueError(f"client {client_id} is frozen for misbehaviour")
        return cs

    def _store_valset(
        self, client_id: str, height: int, validators: list[ValidatorInfo]
    ) -> None:
        """Record the valset ADOPTED at a verified height — the epoch
        history misbehaviour verification consults (ibc-go keeps the
        analogous data as per-height consensus states with
        NextValidatorsHash)."""
        self.store.set(
            _valset_key(client_id, height),
            json.dumps([v.to_json() for v in validators], sort_keys=True).encode(),
        )

    def _valset_for_height(
        self, cs: ClientState, height: int
    ) -> list[ValidatorInfo]:
        """The trusted set that verifies a header AT `height`: the valset
        adopted at the greatest verified height strictly below it (an
        update to height h is checked against exactly that set), falling
        back to the current set for heights beyond the latest epoch.
        Only the winning epoch is decoded (iter_prefix is key-sorted)."""
        best_raw: bytes | None = None
        prefix = VALSET_PREFIX + cs.client_id.encode() + b"/"
        for key, raw in self.store.iter_prefix(prefix):
            h = int.from_bytes(key[len(prefix):], "big")
            if h < height:
                best_raw = raw
            else:
                break
        if best_raw is None:
            return list(cs.validators)
        return [ValidatorInfo.from_json(v) for v in json.loads(best_raw)]

    def _prune_expired_epochs(self, cs: ClientState, now: float) -> None:
        """Drop consensus states (and their valset epochs) that have
        aged past the trusting period — they can no longer anchor any
        proof or misbehaviour check the client would accept, so keeping
        them is unbounded state growth (ibc-go prunes expired consensus
        states the same way). The LATEST state is always kept."""
        cons_prefix = CONSENSUS_STATE_PREFIX + cs.client_id.encode() + b"/"
        for key, raw in self.store.iter_prefix(cons_prefix):
            h = int.from_bytes(key[len(cons_prefix):], "big")
            if h >= cs.latest_height:
                break
            cons = ConsensusState.unmarshal(raw)
            if now - cons.timestamp > cs.trusting_period:
                self.store.delete(key)
                self.store.delete(_valset_key(cs.client_id, h))

    def _block_now(self, now: float | None) -> float | None:
        """Current consensus time for expiry checks: the caller's value,
        else the app's committed block time, else None (direct keeper use
        outside a block context — no clock to expire against)."""
        if now is not None:
            return now
        raw = self.store.get(_BLOCK_TIME_KEY)
        if raw:
            try:
                return float(raw.decode())
            except ValueError:
                return None
        return None

    # --- update path ---

    def update_client(
        self, client_id: str, signed: SignedHeader, now: float | None = None
    ) -> ClientState:
        """Sequential header verification (07-tendermint CheckHeaderAnd
        UpdateState): client not expired, chain id match, height advance,
        monotonic header time, > 2/3 trusted power signed; then adopt the
        header's valset and consensus state.

        Expiry (ibc-go TrustingPeriod / status-Expired): when the latest
        verified consensus state is older than the client's
        trusting_period at `now` (consensus block time), the update is
        rejected — otherwise validators who have since unbonded on the
        counterparty but kept their keys could advance the stale client
        to a forged state (the long-range attack). An expired client can
        only be replaced by creating a new one from a fresh social-trust
        header (ibc-go requires a governance client substitution)."""
        cs = self._require_active(client_id)
        header = signed.header
        latest_cons = self.get_consensus_state(client_id, cs.latest_height)
        t = self._block_now(now)
        if (
            t is not None
            and latest_cons is not None
            and t - latest_cons.timestamp > cs.trusting_period
        ):
            raise ValueError(
                f"client {client_id} is expired: latest consensus state is "
                f"{t - latest_cons.timestamp:.0f}s old, trusting period "
                f"{cs.trusting_period:.0f}s"
            )
        if header.chain_id != cs.chain_id:
            raise ValueError(
                f"header chain id {header.chain_id!r} does not match "
                f"client chain id {cs.chain_id!r}"
            )
        if header.height <= cs.latest_height:
            raise ValueError(
                f"header height {header.height} is not newer than the "
                f"client's latest {cs.latest_height}"
            )
        if latest_cons is not None and header.time <= latest_cons.timestamp:
            raise ValueError(
                "header time is not newer than the latest consensus state"
            )
        if not header.validators:
            raise ValueError("header carries no validator set")
        verify_commit(cs.validators, header, signed.signatures)
        cs.latest_height = header.height
        cs.validators = list(header.validators)
        self._set_client(cs)
        self.store.set(
            _consensus_key(client_id, header.height),
            ConsensusState(header.app_hash, header.time).marshal(),
        )
        self._store_valset(client_id, header.height, header.validators)
        self._prune_expired_epochs(cs, t if t is not None else header.time)
        return cs

    def submit_misbehaviour(
        self, client_id: str, a: SignedHeader, b: SignedHeader
    ) -> ClientState:
        """Freeze on two validly-signed conflicting headers at one height
        (equivocation — 02-client misbehaviour).

        Each header is verified against the valset trusted AT ITS OWN
        height (the stored epoch history, ibc-go's per-trusted-height
        check) — evidence of equivocation inside an earlier trusted epoch
        freezes the client even after later updates rotated the set."""
        cs = self._require_active(client_id)
        if a.header.height != b.header.height:
            raise ValueError("misbehaviour headers are at different heights")
        if a.header.chain_id != cs.chain_id or b.header.chain_id != cs.chain_id:
            raise ValueError("misbehaviour header chain id mismatch")
        if a.header.sign_bytes() == b.header.sign_bytes():
            raise ValueError("headers are identical — no conflict")
        trusted = self._valset_for_height(cs, a.header.height)
        verify_commit(trusted, a.header, a.signatures)
        verify_commit(trusted, b.header, b.signatures)
        cs.frozen = True
        self._set_client(cs)
        return cs

    def _is_expired(self, cs: ClientState, now: float | None) -> bool:
        t = self._block_now(now)
        latest = self.get_consensus_state(cs.client_id, cs.latest_height)
        return (
            t is not None
            and latest is not None
            and t - latest.timestamp > cs.trusting_period
        )

    def recover_client(
        self, subject_id: str, substitute_id: str, now: float | None = None
    ) -> ClientState:
        """Governance client recovery (the reference routes ibc-go's
        ClientUpdateProposal through a dedicated gov handler,
        app/ibc_proposal_handler.go:17-28): a frozen or expired SUBJECT
        client adopts the latest verified state of an ACTIVE SUBSTITUTE
        client tracking the same chain, and is unfrozen.

        Safety rests on the substitute having verified its own headers
        the normal way AND on the gov quorum: an attacker cannot use
        recovery to skip verification — the substitute's state was
        signature-verified, and the social layer approved the
        substitution (ibc-go 02-client CheckSubstituteAndUpdateState)."""
        subject = self.get_client(subject_id)
        if subject is None:
            raise ValueError(f"unknown subject client {subject_id}")
        if not subject.frozen and not self._is_expired(subject, now):
            raise ValueError(
                f"subject client {subject_id} is active — nothing to recover"
            )
        substitute = self._require_active(substitute_id)
        if self._is_expired(substitute, now):
            raise ValueError(f"substitute client {substitute_id} is expired")
        if substitute.chain_id != subject.chain_id:
            raise ValueError(
                "substitute tracks a different chain "
                f"({substitute.chain_id!r} != {subject.chain_id!r})"
            )
        if substitute.latest_height <= subject.latest_height:
            raise ValueError(
                "substitute client is not ahead of the subject "
                f"({substitute.latest_height} <= {subject.latest_height})"
            )
        cons = self.get_consensus_state(
            substitute_id, substitute.latest_height
        )
        if cons is None:
            raise ValueError("substitute has no latest consensus state")
        subject.latest_height = substitute.latest_height
        subject.validators = list(substitute.validators)
        subject.trusting_period = substitute.trusting_period
        subject.frozen = False
        self._set_client(subject)
        self.store.set(
            _consensus_key(subject_id, subject.latest_height), cons.marshal()
        )
        self._store_valset(
            subject_id, subject.latest_height, subject.validators
        )
        return subject

    # --- proof verification (23-commitment role) ---

    def verify_membership(
        self,
        client_id: str,
        height: int,
        key: bytes,
        value: bytes,
        proof: smt_mod.Proof,
    ) -> None:
        """Raise unless `key → value` is committed in the counterparty
        state at the verified `height`."""
        cons = self._proof_consensus(client_id, height)
        if not smt_mod.verify_proof(cons.app_hash, key, value, proof):
            raise ValueError(
                f"membership proof failed for {key!r} at height {height}"
            )

    def verify_non_membership(
        self, client_id: str, height: int, key: bytes, proof: smt_mod.Proof
    ) -> None:
        """Raise unless `key` is provably ABSENT from the counterparty
        state at the verified `height` (SMT absence proof)."""
        cons = self._proof_consensus(client_id, height)
        if not smt_mod.verify_proof(cons.app_hash, key, None, proof):
            raise ValueError(
                f"non-membership proof failed for {key!r} at height {height}"
            )

    def _proof_consensus(self, client_id: str, height: int) -> ConsensusState:
        self._require_active(client_id)
        cons = self.get_consensus_state(client_id, height)
        if cons is None:
            raise ValueError(
                f"client {client_id} has no consensus state at height {height}"
            )
        return cons
