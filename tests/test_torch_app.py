"""The port's App (``celestia_tpu_torch/app/app.py``) against the JAX
package's, on the CPU.

A block script at k <= 32 goes through the JAX App (native backend) and the
port's App on each of its backends (``gpu`` with ``device="cpu"``, which
runs the device entries' plain versions, ``native`` and ``numpy``): every
CheckTx, PrepareProposal, ProcessProposal, DeliverTx, Commit and
ExtendBlock agrees. Then ProcessProposal's refusals, the degrade drill
(strikes, sticky disable, counters, spans and the log line) and the
quarantine against the JAX App's device path on its CPU backend, the
device contract, and the renames from ``tpu`` to ``gpu``.

Txs are signed by the JAX package's keys."""

import logging

import numpy as np
import pytest
import torch

import celestia_tpu.app.app as japp_mod
from celestia_tpu import blob as jblob
from celestia_tpu import faults as jfaults
from celestia_tpu import integrity as jintegrity
from celestia_tpu import namespace as jns
from celestia_tpu import tracing as jtracing
from celestia_tpu.crypto import PrivateKey
from celestia_tpu.telemetry import metrics as jmetrics
from celestia_tpu.tx import Fee, sign_tx
from celestia_tpu.x.bank import MsgSend
from celestia_tpu.x.blob.types import estimate_gas, new_msg_pay_for_blobs
from celestia_tpu.x.staking import MsgDelegate, MsgUndelegate
from celestia_tpu.x.upgrade import MsgVersionChange
import celestia_tpu_torch.app.app as papp_mod
from celestia_tpu_torch import faults as pfaults
from celestia_tpu_torch import integrity as pintegrity
from celestia_tpu_torch import tracing as ptracing
from celestia_tpu_torch.telemetry import metrics as pmetrics

CHAIN = "app-test"
KEYS = {name: PrivateKey.from_secret(b"app-" + name.encode()) for name in ("alice", "bob", "val")}
ADDR = {name: key.bech32_address() for name, key in KEYS.items()}
ACCOUNT = {"alice": 0, "bob": 1, "val": 2}  # genesis order
BOND = 10**8


def _genesis(app) -> None:
    app.init_chain({ADDR["alice"]: 10**12, ADDR["bob"]: 10**9, ADDR["val"]: 10**9},
                   genesis_time=0.0, genesis_validators={ADDR["val"]: BOND})


def _pfb(name: str, seq: int, sizes, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    blobs = [jblob.new_blob(jns.new_v0(b"app" + bytes([seed, i])),
                            rng.integers(0, 256, n, dtype=np.uint8).tobytes(), 0)
             for i, n in enumerate(sizes)]
    gas = estimate_gas(sizes)
    tx = sign_tx(KEYS[name], [new_msg_pay_for_blobs(ADDR[name], *blobs)], CHAIN, ACCOUNT[name],
                 seq, Fee(amount=gas, gas_limit=gas))
    return jblob.marshal_blob_tx(tx.marshal(), blobs)


def _tx(name: str, seq: int, *msgs) -> bytes:
    return sign_tx(KEYS[name], list(msgs), CHAIN, ACCOUNT[name], seq,
                   Fee(amount=4_000, gas_limit=400_000)).marshal()


# the script: an empty height 1; a small block with PFBs, a send, a
# delegation and an undelegation that fails at DeliverTx; a k = 32 block.
# Each list is in a block's order (normal txs before blob txs), which is
# the order its sequences count in.
SCRIPT = [
    [],
    [_tx("bob", 0, MsgSend(ADDR["bob"], ADDR["alice"], 12_345)),
     _tx("alice", 0, MsgDelegate(ADDR["alice"], ADDR["val"], 5_000_000)),
     _tx("bob", 1, MsgUndelegate(ADDR["bob"], ADDR["val"], 1)),
     _pfb("alice", 1, [3_000, 700], 1)],
    [_pfb("alice", 2, [200_000, 90_000], 2), _pfb("bob", 2, [40_000], 3)],
]


def _result(r) -> tuple:
    return (r.code, r.log, r.gas_wanted, r.gas_used, r.priority)


def _eds_view(eds) -> tuple:
    return eds.data.tobytes(), eds.row_roots(), eds.col_roots()


@pytest.mark.parametrize("backend", ["gpu", "native", "numpy"])
def test_the_block_script_matches_the_jax_app(backend):
    japp = japp_mod.App(chain_id=CHAIN, extend_backend="native")
    papp = papp_mod.App(chain_id=CHAIN, extend_backend=backend, device="cpu")
    for app in (japp, papp):
        _genesis(app)
    assert japp.store.app_hashes == papp.store.app_hashes
    sizes = []
    for height, txs in enumerate(SCRIPT, start=1):
        checked = [[_result(app.check_tx(t)) for t in txs] for app in (japp, papp)]
        assert checked[0] == checked[1], height
        jprop, pprop = japp.prepare_proposal(txs), papp.prepare_proposal(txs)
        assert vars(jprop) == vars(pprop), height
        block = pprop.txs
        assert block == txs
        # each App accepts the other's proposal
        assert papp.process_proposal(jprop) and japp.process_proposal(pprop)
        results, hashes = [], []
        for app in (japp, papp):
            app.begin_block(15.0 * height)
            results.append([_result(app.deliver_tx(t)) for t in block])
            assert app.end_block() == {}
            hashes.append(app.commit())
        assert results[0] == results[1] and hashes[0] == hashes[1], height
        jeds, peds = japp.extend_block(block), papp.extend_block(block)
        assert _eds_view(jeds) == _eds_view(peds), height
        assert papp.deconstruct_square(
            papp_mod.square_pkg.construct(block, 1, 128)) == block
        sizes.append(pprop.square_size)
    assert sizes == [1, 4, 32]
    assert [r[0] for r in results[1]] == [0, 0]
    assert papp.resolve_extend_backend(32) == backend
    assert papp._gpu_strikes == 0 and not papp._gpu_disabled


def test_a_failing_deliver_keeps_its_ante_effects_alike():
    """Height 2's undelegation fails at DeliverTx on both sides with the
    same log, its fee and sequence kept (the ante's branch is written)."""
    apps = [japp_mod.App(chain_id=CHAIN, extend_backend="native"),
            papp_mod.App(chain_id=CHAIN, extend_backend="native", device="cpu")]
    out = []
    for app in apps:
        _genesis(app)
        for height, txs in enumerate(SCRIPT[:2], start=1):
            app.begin_block(15.0 * height)
            results = [app.deliver_tx(t) for t in txs]
            app.end_block()
            app.commit()
        out.append((_result(results[2]), app.accounts.get_account(ADDR["bob"]).sequence,
                    app.bank.get_balance(ADDR["bob"])))
    assert out[0] == out[1]
    assert out[1][0][0] == 1 and out[1][1] == 2


def _refusal_cases(app):
    """(name, ProposalBlockData) for ProcessProposal on an App at height 1."""
    cls = type(app.prepare_proposal([]))
    valid = app.prepare_proposal(SCRIPT[1])
    pfb = SCRIPT[1][3]
    bare = jblob.unmarshal_blob_tx(pfb)[0].tx  # the PFB without its blobs
    upgrade = MsgVersionChange.as_tx_bytes(2)
    send = SCRIPT[1][0]
    return valid, {
        "bare_pfb": cls([bare], valid.square_size, valid.hash),
        "upgrade_not_first": cls([send, upgrade], valid.square_size, valid.hash),
        "unsupported_upgrade": cls([MsgVersionChange.as_tx_bytes(3)], 1, valid.hash),
        "no_upgrade_to_the_same_version": cls([MsgVersionChange.as_tx_bytes(1)], 1, valid.hash),
        "wrong_square_size": cls(valid.txs, valid.square_size * 2, valid.hash),
        "wrong_hash": cls(valid.txs, valid.square_size, bytes(32)),
        "tampered_blob": cls(valid.txs[:3] + [pfb[:-200] + bytes([pfb[-200] ^ 1]) + pfb[-199:]],
                             valid.square_size, valid.hash),
    }


def test_process_proposal_refuses_alike():
    verdicts = []
    for mod in (japp_mod, papp_mod):
        kw = {"device": "cpu"} if mod is papp_mod else {}
        app = mod.App(chain_id=CHAIN, extend_backend="native", **kw)
        _genesis(app)
        app.begin_block(15.0)
        app.end_block()
        app.commit()
        valid, cases = _refusal_cases(app)
        panics = (jmetrics if mod is japp_mod else pmetrics).get_counter("process_proposal_panics")
        verdicts.append((app.process_proposal(valid),
                         {name: app.process_proposal(p) for name, p in cases.items()},
                         (jmetrics if mod is japp_mod else pmetrics).get_counter(
                             "process_proposal_panics") - panics))
    assert verdicts[0] == verdicts[1]
    accepted, refused, panics = verdicts[1]
    assert accepted is True and not any(refused.values())
    assert panics == 1  # the tampered blob raises inside; it votes no


class _Catch(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append((record.getMessage(), dict(record.kv)))


def _counters(metrics, names) -> dict:
    return {n: sum(v for key, v in metrics.counters.items() if key.split("{")[0] == n)
            for n in names}


JAX_COUNTERS = ("extend_tpu_fallback_total", "extend_tpu_disabled_total", "sdc_quarantine_total")
PORT_COUNTERS = ("extend_gpu_fallback_total", "extend_gpu_disabled_total", "sdc_quarantine_total")


def _drill(mod, faults, tracing, metrics, counter_names, app):
    """One fault, a clean call, three faults, one more call: per call the
    verdict, the strikes, the disabled flag, the counter deltas and the
    extend.block span's attributes."""
    p = app.prepare_proposal([])
    strikes = "_tpu_strikes" if mod is japp_mod else "_gpu_strikes"
    disabled = "_tpu_disabled" if mod is japp_mod else "_gpu_disabled"
    base = _counters(metrics, counter_names)
    steps = []

    def call():
        with tracing.record() as rec:
            ok = app.process_proposal(p)
        span = [s for s in rec.spans if s.name == "extend.block"][0]
        now = _counters(metrics, counter_names)
        steps.append((ok, getattr(app, strikes), getattr(app, disabled),
                      [now[n] - base[n] for n in counter_names], dict(span.attrs)))

    with faults.inject(faults.rule("device.extend", "unavailable", times=1)):
        call()
    call()
    with faults.inject(faults.rule("device.extend", "unavailable", times=3)):
        call(), call(), call()
    call()
    return steps


def _to_port(value):
    """A JAX drill record with the port's names."""
    if isinstance(value, str):
        return value.replace("tpu", "gpu")
    if isinstance(value, dict):
        return {k: _to_port(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_port(v) for v in value)
    return value


def test_the_degrade_drill_matches_the_jax_apps_device_path():
    """The JAX App's device path (use_tpu, on its CPU backend) and the
    port's (extend_backend="gpu", device="cpu") through the same faults: the same
    strikes, sticky disable, counters (renamed), span attributes and
    warning lines (renamed); every verdict accepts."""
    records = {}
    for mod, faults, tracing, metrics, names, logger in (
            (japp_mod, jfaults, jtracing, jmetrics, JAX_COUNTERS, "celestia_tpu.app"),
            (papp_mod, pfaults, ptracing, pmetrics, PORT_COUNTERS, "celestia_tpu_torch.app")):
        if mod is japp_mod:
            app = mod.App(chain_id=CHAIN, use_tpu=True)
        else:
            app = mod.App(chain_id=CHAIN, extend_backend="gpu", device="cpu")
        _genesis(app)
        catch = _Catch()
        log = logging.getLogger(logger)
        log.addHandler(catch)
        try:
            steps = _drill(mod, faults, tracing, metrics, names, app)
        finally:
            log.removeHandler(catch)
        warned = [(msg, {k: kv[k] for k in ("reason", "op", "strike", "fallback", "disabled")})
                  for msg, kv in catch.records if msg.startswith("extend degraded")]
        records[mod] = (steps, warned)
    assert _to_port(records[japp_mod]) == records[papp_mod]
    steps, warned = records[papp_mod]
    assert [s[1:3] for s in steps] == [(1, False), (0, False), (1, False), (2, False),
                                       (3, True), (3, True)]
    assert all(s[0] for s in steps)
    assert steps[-1][3] == [4, 1, 0] and steps[-1][4]["backend"] == "native"
    assert steps[0][4]["degraded"] is True and steps[0][4]["cause"] == "DeviceUnavailable"
    assert [w[0] for w in warned] == ["extend degraded gpu->host"] * 4


def test_the_quarantine_matches_the_jax_apps():
    """Under a full audit a bit flipped in the device's EDS is caught; the
    App quarantines (sticky, no strike grace), the BEFP oracle proves the
    corrupted square, and the DAH still comes out right from the host."""
    out = {}
    for mod, faults, integrity, metrics, names in (
            (japp_mod, jfaults, jintegrity, jmetrics, JAX_COUNTERS),
            (papp_mod, pfaults, pintegrity, pmetrics, PORT_COUNTERS)):
        kw = ({"use_tpu": True} if mod is japp_mod
              else {"extend_backend": "gpu", "device": "cpu"})
        try:
            app = mod.App(chain_id=CHAIN, audit_level="full", **kw)
            _genesis(app)
            p = app.prepare_proposal([])
            base = _counters(metrics, names)
            with faults.inject(faults.rule("device.extend.output", "bitflip", times=1), seed=9):
                ok = app.process_proposal(p)
            now = _counters(metrics, names)
        finally:
            integrity.configure("off")
        out[mod] = (ok, app.sdc_quarantined, app.sdc_events, app.last_sdc,
                    [now[n] - base[n] for n in names])
    assert out[japp_mod] == out[papp_mod]
    ok, quarantined, events, last_sdc, deltas = out[papp_mod]
    assert ok and quarantined and events == 1 and last_sdc["befp_provable"] is True
    assert deltas == [1, 1, 1]


def test_an_exception_from_the_device_path_propagates(monkeypatch):
    """A difference of record: the JAX App degrades to the host on any
    exception from its device path; the port's only where the device is
    unavailable or its result corrupt. A kernel that fails to build or
    launch raises through PrepareProposal and ExtendBlock, makes
    ProcessProposal vote no (its panic counter, as the reference counts
    every exception there), and never strikes or falls back."""
    from celestia_tpu_torch.ops import extend

    def broken(*_args, **_kw):
        raise RuntimeError("CUDA error: the kernel failed to launch")

    app = papp_mod.App(chain_id=CHAIN, extend_backend="gpu", device="cpu")
    _genesis(app)
    p = app.prepare_proposal([])
    names = PORT_COUNTERS + ("process_proposal_panics",)
    base = _counters(pmetrics, names)
    monkeypatch.setattr(extend, "roots_device", broken)
    monkeypatch.setattr(extend, "extend_roots_device_resident", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        app.prepare_proposal([])
    with pytest.raises(RuntimeError, match="failed to launch"):
        app.extend_block([])
    assert app.process_proposal(p) is False
    now = _counters(pmetrics, names)
    assert [now[n] - base[n] for n in names] == [0, 0, 0, 1]
    assert app._gpu_strikes == 0 and not app._gpu_disabled and not app.sdc_quarantined
    # the JAX App, given the same fault, degrades and accepts
    japp = japp_mod.App(chain_id=CHAIN, use_tpu=True)
    _genesis(japp)
    jp = japp.prepare_proposal([])
    import celestia_tpu.ops.extend_tpu as jextend

    monkeypatch.setattr(jextend, "roots_device", broken)
    assert japp.process_proposal(jp) is True and japp._tpu_strikes == 1


def test_the_app_needs_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        papp_mod.App()
    app = papp_mod.App(device="cpu")
    assert app.device == torch.device("cpu") and not app.accelerator_available()
    # auto never routes to the card it does not have; explicit gpu runs the
    # plain versions on the App's device
    assert app.resolve_extend_backend(128) == "native"
    assert papp_mod.App(device="cpu", extend_backend="gpu").resolve_extend_backend(1) == "gpu"
    with pytest.raises(ValueError, match="auto|gpu|native|numpy"):
        papp_mod.App(device="cpu", extend_backend="tpu")
    arena = papp_mod.App(device="cpu").enable_blob_pool(8192)
    assert arena.device == torch.device("cpu")


# the JAX App's names (left) and the port's (right) where the device is named
RENAMES = {
    "TPU_STRIKE_LIMIT": "GPU_STRIKE_LIMIT",
    "_tpu_strikes": "_gpu_strikes",
    "_tpu_disabled": "_gpu_disabled",
    "_degrade_tpu": "_degrade_gpu",
    "_quarantine_tpu": "_quarantine_gpu",
}
MODULE_RENAMES = {"TPU_MIN_SQUARE": "GPU_MIN_SQUARE"}
# what the port has instead: the JAX App's accelerator probe asks jax, the
# port's App asks its own device; the arena path's inner half is
# app/proposal.py's; the JAX App's use_tpu=True is extend_backend="gpu"
JAX_ONLY = {"_assembled_proposal_dah", "_assembled_proposal_dah_locked", "use_tpu"}
PORT_ONLY = {"accelerator_available", "device"}


def test_the_renames_map_the_jax_apps_names_onto_the_ports():
    jax_app = japp_mod.App(chain_id=CHAIN)
    port_app = papp_mod.App(chain_id=CHAIN, device="cpu")
    jax_names = {n for n in set(dir(jax_app)) if not n.startswith("__")}
    port_names = {n for n in set(dir(port_app)) if not n.startswith("__")}
    mapped = {RENAMES.get(n, n) for n in jax_names - JAX_ONLY}
    assert mapped | PORT_ONLY == port_names
    assert not hasattr(port_app, "use_gpu") and port_app.extend_backend == "auto"
    for jname, pname in RENAMES.items():
        assert not hasattr(port_app, jname) and not hasattr(jax_app, pname)
        assert type(getattr(jax_app, jname)) is type(getattr(port_app, pname))
    assert jax_app.TPU_STRIKE_LIMIT == port_app.GPU_STRIKE_LIMIT == 3
    for jname, pname in MODULE_RENAMES.items():
        assert getattr(japp_mod, jname) == getattr(papp_mod, pname) == 16
        assert not hasattr(papp_mod, jname)
    assert papp_mod.BACKENDS == tuple(_to_port(b) for b in ("auto", "tpu", "native", "numpy"))
    assert papp_mod.GENESIS_CHAIN_ID == japp_mod.GENESIS_CHAIN_ID


def test_the_crossover_table_is_the_ports_own_and_auto_rechecks_it(tmp_path):
    """The App starts from the port's committed table (H100 times, gpu
    against native), never the repo's config/crossover.json (TPU times);
    a winner the App cannot run is dropped for the static gate; a measured
    table saves and loads back."""
    import pathlib

    from celestia_tpu_torch.app import calibration

    package = pathlib.Path(papp_mod.__file__).resolve().parents[1]
    assert calibration.CROSSOVER_TABLE_PATH == package / "config" / "crossover.json"
    table = calibration.load_default_table()
    assert table.card.startswith("NVIDIA H100") and table.power_limit
    assert sorted(table.entries) == list(calibration.DEFAULT_KS)
    assert all(set(t) == {"gpu", "native"} for t in table.entries.values())
    app = papp_mod.App(device="cpu")
    assert app.crossover.to_json() == table.to_json()
    assert table.winner(128) == "gpu"  # measured on the card
    assert app.resolve_extend_backend(128) == "native"  # this App has no card
    measured = calibration.measure_crossover((1, 2), repeats=1, device="cpu")
    assert sorted(measured.entries) == [1, 2]
    assert all(set(t) == {"native"} for t in measured.entries.values())
    app.crossover = measured
    assert app.resolve_extend_backend(2) == "native"
    path = tmp_path / "crossover.json"
    measured.save(path)
    assert calibration.CrossoverTable.load(path).to_json() == measured.to_json()
    app.crossover = calibration.CrossoverTable({16: {"tpu": 1.0, "native": 2.0}})
    assert app.resolve_extend_backend(16) == "native"  # no tpu backend in the port
