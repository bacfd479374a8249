"""The port's RPC server (``celestia_tpu_torch/node/rpc.py``) against the JAX
package's, on the CPU.

Twin nodes (``test_torch_node_blocks.Twins``: a JAX Node and a port Node fed
the same signed bytes) take one block script: sends, PFBs, an EVM address
registration, an IBC transfer over an open channel, and enough heights to
cross a Blobstream data-commitment window. A JAX ``RpcServer`` and a port
``RpcServer`` on port 0 serve them, and every GET and POST route of the JAX
server gets the same request on both: the status codes and the parsed
bodies are equal. The allowed differences are listed in ``norm`` and
ROADMAP Queue 3: the uptime, the home's path, ``gpu_*`` for ``tpu_*`` in
``/status`` and the SLO objective, the device ledger's document and the
metrics' contents (each package has its own registry).

The square's routes also run on twins whose port App runs the ``gpu``
backend (the device entries' plain versions on the CPU): the ``/sample``,
``/proof/share``, ``/dah``, ``/eds`` and ``/namespace_data`` bodies are
equal bytes. Then, on both servers: the overload contract (a full queue's
``503`` with ``Retry-After``, ``X-Deadline-Ms`` only tightening to ``504``,
an unparseable deadline ignored, ``/readyz`` flipping on drain, a graceful
stop mid-hammer with no orphan), the ``("sample",)`` coalescing of
concurrent samples into one ragged exec, ``X-Trace-Context`` across the two
packages, a malformed header counted, the ``rpc.post`` body flip answered
``400``, and a device error answered with the JAX server's error status.
"""

import base64
import contextlib
import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from celestia_tpu import faults as jfaults
from celestia_tpu import namespace as jns
from celestia_tpu import tracing as jtracing
from celestia_tpu.node.rpc import RpcServer as JServer
from celestia_tpu.telemetry import metrics as jmetrics
from celestia_tpu.tx import Fee, sign_tx
from celestia_tpu.x.bank import MsgSend
from celestia_tpu.x.blobstream import MsgRegisterEVMAddress
from celestia_tpu.x.transfer import MsgTransfer
from celestia_tpu_torch import faults as pfaults
from celestia_tpu_torch import tracing as ptracing
from celestia_tpu_torch.node.rpc import RpcServer as PServer
from celestia_tpu_torch.telemetry import metrics as pmetrics

from test_torch_node_blocks import ACCOUNT, ADDR, CHAIN, KEYS, Twins, pfb, send

WINDOW = 4  # the Blobstream data-commitment window of the script
EVM = "0x" + "ab" * 20
# the first blob's namespace of pfb(..., seed=5), and one no blob has
NS = jns.new_v0(b"node" + bytes([5, 0])).bytes.hex()
ABSENT_NS = jns.new_v0(b"absent-ns!").bytes.hex()
FAULT_SEED = 19


def signed(name: str, seq: int, msgs, gas: int = 400_000) -> bytes:
    return sign_tx(KEYS[name], msgs, CHAIN, ACCOUNT[name], seq,
                   Fee(amount=gas // 100, gas_limit=gas)).marshal()


def fetch(base: str, path: str, method: str = "GET", body: bytes | None = None,
          headers: dict | None = None, timeout: float = 60.0):
    """(status, raw body, headers) of one request; an HTTP error status is an
    answer, not a failure."""
    req = urllib.request.Request(base + path, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _script(tw: Twins, blocks_after: int) -> dict:
    """The block script on the twins (and their source node): returns the
    hashes, addresses and keys the routes are asked about."""
    from celestia_tpu.node.node import tx_hash

    for node in (tw.jax, tw.port, tw.src):
        node.app.blobstream.data_commitment_window = WINDOW
        node.app.ibc.open_channel("transfer", "channel-0", "transfer", "channel-0")
        node.app.store.commit_hash_refresh()
    tw.produce(15.0)
    txs = [send("alice", 0, 1_000), pfb("bob", 0, [700, 1500], 5),
           signed("val", 0, [MsgRegisterEVMAddress(ADDR["val"], EVM)]),
           signed("carol", 0, [MsgTransfer("transfer", "channel-0", "utia", 2_500,
                                           ADDR["carol"], "cosmos1receiver")])]
    for raw in txs:
        assert tw.broadcast(raw).code == 0
    tw.produce(30.0)
    for h in range(blocks_after):
        tw.produce(45.0 + 15.0 * h)
    assert tw.jax.app.blobstream.data_commitment_range_for_height(2) is not None
    return {"txs": [tx_hash(raw).hex() for raw in txs], "height": 2}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Native twins after the script, each behind its package's server, and
    the state the routes are asked about."""
    tmp = tmp_path_factory.mktemp("rpc")
    tw = Twins(tmp, backend="native")
    state = _script(tw, blocks_after=WINDOW)
    genesis = json.dumps({"chain_id": CHAIN, "genesis_time": 0.0}, indent=2)
    for name in ("jax", "port"):
        (tmp / name / "genesis.json").write_text(genesis)
    wire = {"height": 3, "dah": tw.jax.block_dah(3).to_json(), "proof": {"axis": "row"}}
    for node in (tw.jax, tw.port):
        assert node.add_fraud_proof(3, b"\x11" * 32, wire)
    state["store_key"] = sorted(tw.port.app.store._data)[0].hex()
    state["tip"] = tw.port.latest_height()
    servers = {"jax": JServer(tw.jax, port=0), "port": PServer(tw.port, port=0)}
    for srv in servers.values():
        srv.start()
    try:
        yield tw, servers, state
    finally:
        for srv in servers.values():
            srv.stop()


def _base(srv) -> str:
    return f"http://127.0.0.1:{srv.port}"


def norm(path: str, doc):
    """A document with the allowed differences taken out (ROADMAP Queue 3):
    the clock, the home's path, ``gpu`` for ``tpu``."""
    if not isinstance(doc, dict):
        return doc
    doc = json.loads(json.dumps(doc).replace("tpu_not_sticky_disabled", "gpu_not_sticky_disabled")
                     .replace("extend_tpu_disabled_total", "extend_gpu_disabled_total"))
    doc.pop("uptime_s", None)
    for key in ("strikes", "disabled"):
        if f"tpu_{key}" in doc:
            doc[f"gpu_{key}"] = doc.pop(f"tpu_{key}")
    store = doc.get("store")
    if isinstance(store, dict) and "root" in store:
        store["root"] = pathlib.Path(store["root"]).name
    return doc


# every GET route of the JAX server, by name, spelled from the script's state
GET_ROUTES = {
    "status": lambda s: "/status",
    "healthz": lambda s: "/healthz",
    "readyz": lambda s: "/readyz",
    "debug_slo": lambda s: "/debug/slo",
    "genesis": lambda s: "/genesis",
    "block": lambda s: "/block/2",
    "block_missing": lambda s: "/block/999",
    "header": lambda s: "/header/2",
    "header_missing": lambda s: "/header/999",
    "dah": lambda s: "/dah/2",
    "dah_missing": lambda s: "/dah/999",
    "eds": lambda s: "/eds/2",
    "eds_missing": lambda s: "/eds/999",
    "sample": lambda s: "/sample/2/1/3",
    "sample_parity": lambda s: "/sample/2/5/6",
    "sample_out_of_range": lambda s: "/sample/2/99/0",
    "sample_missing": lambda s: "/sample/999/0/0",
    "befp": lambda s: "/fraud/befp/3",
    "befp_missing": lambda s: "/fraud/befp/2",
    "tx": lambda s: f"/tx/{s['txs'][1]}",
    "tx_missing": lambda s: "/tx/" + "00" * 32,
    "account": lambda s: f"/account/{ADDR['alice']}",
    "account_missing": lambda s: "/account/cosmos1nobody",
    "balance": lambda s: f"/balance/{ADDR['bob']}/utia",
    "ibc_header": lambda s: "/ibc/header",
    "ibc_packets": lambda s: "/ibc/packets/transfer/channel-0",
    "ibc_ack_missing": lambda s: "/ibc/ack/transfer/channel-0/1",
    "proof_state": lambda s: f"/proof/state/{s['store_key']}",
    "proof_state_absent": lambda s: "/proof/state/" + b"no-such-key".hex(),
    "proof_tx": lambda s: "/proof/tx/2:1",
    "proof_tx_missing": lambda s: "/proof/tx/999:0",
    "proof_share": lambda s: "/proof/share/2:0:1",
    "proof_share_range": lambda s: "/proof/share/2:1:4",
    "proof_share_missing": lambda s: "/proof/share/999:0:1",
    "params_blob": lambda s: "/params/blob",
    "params_blobstream": lambda s: "/params/blobstream",
    "params_staking": lambda s: "/params/staking",
    "params_gov": lambda s: "/params/gov",
    "params_unknown": lambda s: "/params/nope",
    "snapshot": lambda s: "/snapshot",
    "namespace_data": lambda s: f"/namespace_data/2/{NS}",
    "namespace_data_absent": lambda s: f"/namespace_data/2/{ABSENT_NS}",
    "namespace_data_parity": lambda s: "/namespace_data/2/" + ("ff" * 29),
    "namespace_data_missing": lambda s: "/namespace_data/999/" + ("00" * 29),
    "blobstream_nonces": lambda s: "/blobstream/nonces",
    "blobstream_attestation": lambda s: "/blobstream/attestation/1",
    "blobstream_attestation_missing": lambda s: "/blobstream/attestation/999",
    "blobstream_valset": lambda s: "/blobstream/valset/latest",
    "blobstream_data_commitment": lambda s: "/blobstream/data_commitment/2",
    "blobstream_data_commitment_missing": lambda s: "/blobstream/data_commitment/999",
    "blobstream_inclusion": lambda s: "/blobstream/data_root_inclusion/2",
    "blobstream_inclusion_missing": lambda s: "/blobstream/data_root_inclusion/999",
    "cosmos_account": lambda s: f"/cosmos/auth/v1beta1/accounts/{ADDR['alice']}",
    "cosmos_account_missing": lambda s: "/cosmos/auth/v1beta1/accounts/cosmos1nobody",
    "cosmos_balances": lambda s: f"/cosmos/bank/v1beta1/balances/{ADDR['carol']}",
    "cosmos_block_latest": lambda s: "/cosmos/base/tendermint/v1beta1/blocks/latest",
    "cosmos_block": lambda s: "/cosmos/base/tendermint/v1beta1/blocks/2",
    "cosmos_block_bad": lambda s: "/cosmos/base/tendermint/v1beta1/blocks/two",
    "cosmos_block_missing": lambda s: "/cosmos/base/tendermint/v1beta1/blocks/999",
    "cosmos_node_info": lambda s: "/cosmos/base/tendermint/v1beta1/node_info",
    "cosmos_tx": lambda s: f"/cosmos/tx/v1beta1/txs/{s['txs'][0]}",
    "cosmos_tx_bad": lambda s: "/cosmos/tx/v1beta1/txs/zz",
    "cosmos_tx_missing": lambda s: "/cosmos/tx/v1beta1/txs/" + "00" * 32,
    "cosmos_unknown": lambda s: "/cosmos/unknown/route",
    "root": lambda s: "/",
    "unknown": lambda s: "/no/such/route",
}

# the square's documents: proofs and shares, equal bytes
BYTE_ROUTES = ("dah", "eds", "sample", "sample_parity", "proof_share", "proof_share_range",
               "proof_tx", "namespace_data", "namespace_data_absent")


@pytest.mark.parametrize("route", sorted(GET_ROUTES))
def test_every_get_route_answers_like_jax(served, route):
    _tw, servers, state = served
    path = GET_ROUTES[route](state)
    if route == "debug_slo":
        # the engines read their package's process-wide registry, which the
        # twins' third (JAX) node also writes: both start from nothing
        jmetrics.reset()
        pmetrics.reset()
    (js, jb, jh), (ps, pb, ph) = (fetch(_base(servers[n]), path) for n in ("jax", "port"))
    assert ps == js, (path, jb[:300], pb[:300])
    assert ph["Content-Type"] == jh["Content-Type"] == "application/json"
    assert norm(path, json.loads(pb)) == norm(path, json.loads(jb)), path
    if route in BYTE_ROUTES:
        assert ps == 200 and pb == jb, path


def test_status_differs_only_by_the_devices_name(served):
    """The one renamed pair of ``/status``: ``gpu_strikes`` and
    ``gpu_disabled`` (the port's App) where JAX says ``tpu_*``."""
    _tw, servers, _state = served
    jdoc, pdoc = (json.loads(fetch(_base(servers[n]), "/status")[1]) for n in ("jax", "port"))
    assert {k for k in pdoc if "pu_" in k} == {"gpu_strikes", "gpu_disabled"}
    assert {k for k in jdoc if "pu_" in k} == {"tpu_strikes", "tpu_disabled"}
    assert (pdoc["gpu_strikes"], pdoc["gpu_disabled"]) == (0, False)
    assert pdoc["height"] == jdoc["height"] > 2 and pdoc["extend_backend"] == "native"


def test_metrics_flight_and_device_routes(served):
    """``/metrics`` is Prometheus text with the port's own registry (its
    names ``rpc_stage_ms``-style histograms, ``_total`` counters);
    ``/debug/flight`` and ``/debug/device`` keep the JAX documents' shape,
    the ledger's series renamed (a difference of record)."""
    from test_torch_prober_slo import parse_prometheus

    _tw, servers, _state = served
    status, body, headers = fetch(_base(servers["port"]), "/metrics")
    jstatus, _jbody, jheaders = fetch(_base(servers["jax"]), "/metrics")
    assert status == jstatus == 200
    assert headers["Content-Type"] == jheaders["Content-Type"] == "text/plain; version=0.0.4"
    series = parse_prometheus(body.decode())
    assert {"process_rss_bytes", "process_threads", "process_open_fds"} <= set(series)
    assert series["process_rss_bytes"][0][1] > 0
    flight = [json.loads(fetch(_base(servers[n]), "/debug/flight")[1]) for n in ("jax", "port")]
    assert [set(d) for d in flight] == [{"enabled", "capacity", "spans"}] * 2
    assert flight[0]["capacity"] == flight[1]["capacity"]
    device = [fetch(_base(servers[n]), "/debug/device") for n in ("jax", "port")]
    assert device[0][0] == device[1][0] == 200
    jdev, pdev = (json.loads(d[1]) for d in device)
    assert set(pdev) == set(jdev) and "ledger" in pdev


def _posts(state):
    """Every POST route of the JAX server: (name, path, raw body)."""
    fresh = send("alice", 1, 700)
    other = send("alice", 2, 900)
    return {
        "broadcast_tx": ("/broadcast_tx", json.dumps({"tx": fresh.hex()}).encode()),
        "broadcast_tx_again": ("/broadcast_tx", json.dumps({"tx": fresh.hex()}).encode()),
        "broadcast_tx_bad_hex": ("/broadcast_tx", b'{"tx": "zz-not-hex"}'),
        "broadcast_tx_missing_key": ("/broadcast_tx", b"{}"),
        "broadcast_tx_not_object": ("/broadcast_tx", b"[1, 2, 3]"),
        "broadcast_tx_malformed": ("/broadcast_tx", b"{not json"),
        "cosmos_txs": ("/cosmos/tx/v1beta1/txs",
                       json.dumps({"tx_bytes": base64.b64encode(other).decode()}).encode()),
        "cosmos_txs_missing_key": ("/cosmos/tx/v1beta1/txs", b"{}"),
        "gossip_have": ("/gossip/have",
                        json.dumps({"keys": [state["txs"][0], "ab" * 32]}).encode()),
        "consensus_proposal": ("/consensus/proposal", b"{}"),
        "consensus_commit": ("/consensus/commit", b"{}"),
        "consensus_evidence": ("/consensus/evidence", b"{}"),
        "fraud_befp": ("/fraud/befp", b"{}"),
        "unknown": ("/no/such/route", b"{}"),
    }


POST_ROUTES = tuple(_posts({"txs": ["00"]}))


@pytest.mark.parametrize("route", POST_ROUTES)
def test_every_post_route_answers_like_jax(served, route):
    _tw, servers, state = served
    path, body = _posts(state)[route]
    (js, jb, _jh), (ps, pb, _ph) = (
        fetch(_base(servers[n]), path, "POST", body, {"Content-Type": "application/json"})
        for n in ("jax", "port"))
    assert (ps, json.loads(pb)) == (js, json.loads(jb)), (path, jb, pb)


def test_produce_block_over_the_rpc_answers_like_jax(served, monkeypatch):
    """``POST /produce_block`` rides each server's dispatcher: the two
    nodes commit the same block (the clock fixed for both) and serve it."""
    tw, servers, state = served
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    (js, jb, _), (ps, pb, _) = (fetch(_base(servers[n]), "/produce_block", "POST", b"{}")
                                for n in ("jax", "port"))
    assert ps == js == 200 and json.loads(pb) == json.loads(jb)
    h = json.loads(pb)["height"]
    assert h == state["tip"] + 1 and tw.port.app.store.app_hashes[h] == tw.jax.app.store.app_hashes[h]
    assert fetch(_base(servers["port"]), f"/block/{h}")[1] == fetch(_base(servers["jax"]),
                                                                      f"/block/{h}")[1]


def test_a_device_error_reaches_the_client_as_the_jax_error_status(served, monkeypatch):
    """An error of device work is answered 500 with its text, as the JAX
    server answers an error; nothing recomputes it on the host."""
    tw, servers, _state = served

    def boom(*_a, **_k):
        raise RuntimeError("device levels failed")

    for node in (tw.jax, tw.port):
        monkeypatch.setattr(node, "block_dah", boom)
    (js, jb, _), (ps, pb, _) = (fetch(_base(servers[n]), "/dah/2") for n in ("jax", "port"))
    assert ps == js == 500 and json.loads(pb) == json.loads(jb)
    assert json.loads(pb)["error"].startswith("device levels failed")
    monkeypatch.setattr(tw.port, "_row_provers", boom)
    tw.port._prover_cache.clear()
    status, body, _ = fetch(_base(servers["port"]), "/sample/3/1/1")
    assert status == 500 and json.loads(body)["error"].startswith("device levels failed")


# ---- the square's routes on the gpu backend (the kernels' plain versions)


@pytest.fixture(scope="module")
def served_gpu(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rpc_gpu")
    tw = Twins(tmp, backend="gpu")
    tw.produce(15.0)
    for raw in (send("alice", 0, 1_000), pfb("bob", 0, [700, 1500], 5),
                pfb("carol", 0, [3000], 6)):
        assert tw.broadcast(raw).code == 0
    tw.produce(30.0)
    assert tw.broadcast(pfb("alice", 1, [2000], 7)).code == 0
    tw.produce(45.0)
    servers = {"jax": JServer(tw.jax, port=0), "port": PServer(tw.port, port=0)}
    for srv in servers.values():
        srv.start()
    try:
        yield tw, servers
    finally:
        for srv in servers.values():
            srv.stop()


@pytest.mark.parametrize("path", [
    "/dah/2", "/eds/2", "/sample/2/0/0", "/sample/2/3/7", "/sample/2/7/2", "/sample/3/1/1",
    "/proof/share/2:0:1", "/proof/share/2:2:9", "/proof/tx/2:2",
    f"/namespace_data/2/{NS}", f"/namespace_data/2/{ABSENT_NS}",
])
def test_the_squares_documents_are_equal_bytes_on_the_gpu_backend(served_gpu, path):
    _tw, servers = served_gpu
    (js, jb, _), (ps, pb, _) = (fetch(_base(servers[n]), path) for n in ("jax", "port"))
    assert ps == js == 200 and pb == jb, path


def test_concurrent_samples_coalesce_into_one_ragged_exec(served_gpu):
    """With the dispatcher held by a gated job, concurrent ``/sample``s queue
    under ``("sample",)`` and reach the node's ragged exec as one group,
    on both servers; every document is the per-height one."""
    tw, servers = served_gpu
    coords = [(2, 0, 1), (3, 2, 5), (2, 6, 6), (3, 7, 0), (2, 1, 1), (3, 4, 3)]
    docs = {}
    for name, node in (("jax", tw.jax), ("port", tw.port)):
        srv = servers[name]
        groups = []
        real = node.sample_batch_ragged

        def counted(payloads, real=real, groups=groups):
            groups.append(list(payloads))
            return real(payloads)

        node.sample_batch_ragged = counted
        gate = threading.Event()
        holder = threading.Thread(target=srv.dispatcher.submit, args=(lambda: gate.wait(30),),
                                  daemon=True)
        try:
            holder.start()
            _wait_for(lambda: srv.dispatcher._busy)
            out = [None] * len(coords)

            def hit(n, h, i, j):
                out[n] = fetch(_base(srv), f"/sample/{h}/{i}/{j}")

            threads = [threading.Thread(target=hit, args=(n, *c), daemon=True)
                       for n, c in enumerate(coords)]
            for t in threads:
                t.start()
            _wait_for(lambda: srv.dispatcher.depth == len(coords))
            gate.set()
            for t in threads:
                t.join(30)
            holder.join(30)
        finally:
            gate.set()
            del node.sample_batch_ragged
        assert len(groups) == 1 and sorted(groups[0]) == sorted(coords), (name, groups)
        assert all(status == 200 for status, _b, _h in out)
        docs[name] = [body for _s, body, _h in out]
        direct = node.sample_batch_ragged(coords)
        assert [json.loads(b) for b in docs[name]] == direct
    assert docs["port"] == docs["jax"]


def _wait_for(cond, timeout: float = 30.0) -> None:
    """Poll a condition of the server's own state (not a wall-clock cadence)."""
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "condition never reached"
        time.sleep(0.002)


# ---- the overload contract, on both servers


PACKAGES = {"jax": (JServer, jfaults), "port": (PServer, pfaults)}


@contextlib.contextmanager
def extra_server(pkg: str, node, **kw):
    """Another server over a twin node; the node's dispatcher is restored."""
    server_cls = PACKAGES[pkg][0]
    before = node.dispatcher
    srv = server_cls(node, port=0, **kw)
    srv.start()
    try:
        yield srv, _base(srv)
    finally:
        with contextlib.suppress(Exception):
            srv.stop()
        node.dispatcher = before


def _twin(served, pkg):
    return served[0].jax if pkg == "jax" else served[0].port


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_full_queue_sheds_503_with_retry_after(served, pkg):
    with extra_server(pkg, _twin(served, pkg), queue_capacity=1) as (srv, base):
        gate = threading.Event()
        holder = threading.Thread(target=srv.dispatcher.submit, args=(lambda: gate.wait(30),),
                                  daemon=True)
        holder.start()
        _wait_for(lambda: srv.dispatcher._busy)
        queued = {}
        waiter = threading.Thread(target=lambda: queued.update(r=fetch(base, "/dah/2")),
                                  daemon=True)
        waiter.start()
        _wait_for(lambda: srv.dispatcher.depth == 1)
        status, body, headers = fetch(base, "/dah/2")
        gate.set()
        waiter.join(30)
        holder.join(30)
    doc = json.loads(body)
    assert status == 503 and set(doc) == {"error", "reason", "retry_after_s", "status"}
    assert (doc["error"], doc["reason"], doc["status"]) == ("overloaded", "queue_full", 503)
    assert headers["Retry-After"] == str(max(1, int(np.ceil(doc["retry_after_s"]))))
    assert "X-Trace-Id" not in headers  # tracing is off
    assert queued["r"][0] == 200


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_the_client_deadline_only_tightens(served, pkg):
    """``X-Deadline-Ms`` under the server default gives 504 for work held
    past it; a longer one cannot extend the server's; an unparseable one is
    ignored."""
    with extra_server(pkg, _twin(served, pkg), default_deadline_s=30.0) as (srv, base):
        gate = threading.Event()
        holder = threading.Thread(target=srv.dispatcher.submit, args=(lambda: gate.wait(30),),
                                  daemon=True)
        holder.start()
        _wait_for(lambda: srv.dispatcher._busy)
        status, body, _ = fetch(base, "/dah/2", headers={"X-Deadline-Ms": "50"})
        gate.set()
        holder.join(30)
        assert status == 504
        doc = json.loads(body)
        assert doc["error"] == "deadline exceeded" and doc["status"] == 504
        assert fetch(base, "/dah/2", headers={"X-Deadline-Ms": "soon"})[0] == 200
        assert fetch(base, "/dah/2", headers={"X-Deadline-Ms": "999999999"})[0] == 200


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_readyz_flips_on_drain(served, pkg):
    with extra_server(pkg, _twin(served, pkg)) as (srv, base):
        status, body, _ = fetch(base, "/readyz")
        assert status == 200
        srv.dispatcher.begin_drain()
        status, body, _ = fetch(base, "/readyz")
        checks = {c["name"]: c for c in json.loads(body)["checks"]}
        assert status == 503 and not checks["not_overloaded"]["ok"]
        assert "draining" in checks["not_overloaded"]["detail"]
        status, body, _ = fetch(base, "/sample/2/0/0")
        assert status == 503 and json.loads(body)["reason"] == "draining"
        assert fetch(base, "/healthz")[0] == 200


@pytest.mark.parametrize("path", ["/proof/tx/2:1", f"/namespace_data/2/{ABSENT_NS}"])
def test_the_proof_routes_ride_the_dispatcher(served, path):
    """The port extends ``/proof/tx``'s and ``/namespace_data``'s squares
    on the dispatcher's thread: with the dispatcher held the request queues
    behind it and is answered once it is free, and a draining server sheds
    it, where the JAX server answers it on the request thread (a difference
    of record)."""
    with extra_server("port", _twin(served, "port")) as (srv, base):
        gate = threading.Event()
        holder = threading.Thread(target=srv.dispatcher.submit, args=(lambda: gate.wait(30),),
                                  daemon=True)
        holder.start()
        _wait_for(lambda: srv.dispatcher._busy)
        queued = {}
        waiter = threading.Thread(target=lambda: queued.update(r=fetch(base, path)), daemon=True)
        waiter.start()
        _wait_for(lambda: srv.dispatcher.depth == 1)
        assert "r" not in queued
        gate.set()
        waiter.join(30)
        holder.join(30)
        want = fetch(_base(served[1]["jax"]), path)
        assert queued["r"][0] == want[0] == 200 and json.loads(queued["r"][1]) == json.loads(want[1])
        srv.dispatcher.begin_drain()
        status, body, _ = fetch(base, path)
        assert status == 503 and json.loads(body)["reason"] == "draining"
    with extra_server("jax", _twin(served, "jax")) as (srv, base):
        srv.dispatcher.begin_drain()
        assert fetch(base, path)[0] == 200


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_graceful_stop_mid_hammer_leaves_no_orphans(served, pkg):
    node = _twin(served, pkg)
    outcomes = []
    lock = threading.Lock()
    stop = threading.Event()
    with extra_server(pkg, node) as (srv, base):

        def hammer(seed: int) -> None:
            i = seed
            while not stop.is_set():
                try:
                    outcome = fetch(base, f"/sample/2/{i % 4}/0", timeout=10.0)[0]
                except Exception:  # noqa: BLE001 — refusals after the close
                    outcome = "conn"
                with lock:
                    outcomes.append(outcome)
                i += 1

        threads = [threading.Thread(target=hammer, args=(s,), daemon=True) for s in range(6)]
        for t in threads:
            t.start()
        _wait_for(lambda: outcomes.count(200) >= 6)
        srv.stop()
        stop.set()
        for t in threads:
            t.join(20)
        thread = srv.dispatcher._thread
    assert set(outcomes) <= {200, 503, 504, "conn"} and 200 in outcomes
    assert not srv.dispatcher.alive and (thread is None or not thread.is_alive())
    registry = pmetrics if pkg == "port" else jmetrics
    assert registry.gauges.get("rpc_inflight_requests", 0.0) == 0.0


def test_start_lets_a_failed_registration_propagate(served, monkeypatch):
    """The port has no ``except ImportError`` around the executor's
    registration: a failure shows."""
    from celestia_tpu_torch.ops import transfers

    def refuse(_executor):
        raise RuntimeError("no executor slot")

    monkeypatch.setattr(transfers, "register_device_executor", refuse)
    node = _twin(served, "port")
    before = node.dispatcher
    srv = PServer(node, port=0)
    try:
        with pytest.raises(RuntimeError, match="no executor slot"):
            srv.start()
    finally:
        srv.dispatcher.drain(timeout=5.0)
        srv.server.server_close()
        node.dispatcher = before


# ---- trace context and the rpc.post fault


def test_trace_context_round_trips_between_the_packages(served):
    """A header minted by either package roots the other server's request
    span under it: the reply carries the trace id, the span the caller's
    wire parent; a malformed header is counted and ignored."""
    _tw, servers, _state = served
    jtracing.enable()
    ptracing.enable()
    try:
        with ptracing.record() as rec:
            ctx = jtracing.mint()
            status, _b, headers = fetch(_base(servers["port"]), "/header/2",
                                        headers={jtracing.TRACE_HEADER: ctx.header_value()})
            # the request span ends after the reply is on the wire
            _wait_for(lambda: any(s.name == "rpc.request" for s in rec.spans))
        assert status == 200 and headers["X-Trace-Id"] == ctx.trace_id
        spans = [s for s in rec.spans if s.name == "rpc.request"]
        assert [(s.trace_id, s.attrs["wire_parent"], s.attrs["status"]) for s in spans] == [
            (ctx.trace_id, ctx.span_id, 200)]
        pctx = ptracing.mint()
        with jtracing.record() as jrec:
            status, _b, headers = fetch(_base(servers["jax"]), "/header/2",
                                        headers={ptracing.TRACE_HEADER: pctx.header_value()})
            _wait_for(lambda: any(s.name == "rpc.request" for s in jrec.spans))
        assert status == 200 and headers["X-Trace-Id"] == pctx.trace_id
        assert [s.attrs["wire_parent"] for s in jrec.spans if s.name == "rpc.request"] == [
            pctx.span_id]
        before = pmetrics.get_counter("trace_context_invalid_total")
        status, _b, headers = fetch(_base(servers["port"]), "/header/2",
                                    headers={"X-Trace-Context": "00-not-a-context"})
        assert status == 200 and len(headers["X-Trace-Id"]) == 32
        assert pmetrics.get_counter("trace_context_invalid_total") == before + 1
        # with a stage sink: Server-Timing, and rpc_stage_ms with its exemplar
        status, _b, headers = fetch(_base(servers["port"]), "/dah/2")
        assert "serialize;dur=" in headers["Server-Timing"]
        assert pmetrics.get_exemplar("rpc_stage_ms", stage="serialize")[0] == headers["X-Trace-Id"]
    finally:
        jtracing.disable()
        ptracing.disable()


def test_the_rpc_post_body_flip_is_a_400_on_both(served):
    """A corrupt rule at ``rpc.post`` mangles the body as received: the
    reply is the malformed-body 400, the same document on both servers."""
    _tw, servers, _state = served
    out = {}
    for name, mod in (("jax", jfaults), ("port", pfaults)):
        with mod.inject(mod.rule("rpc.post", "corrupt", where="broadcast_tx"),
                        seed=FAULT_SEED) as inj:
            status, body, _ = fetch(_base(servers[name]), "/broadcast_tx", "POST",
                                    b'{"tx": "0011"}')
        assert [site for _s, site, _k in inj.schedule] == ["rpc.post"]
        out[name] = (status, json.loads(body))
    assert out["port"] == out["jax"] and out["port"][0] == 400
    assert out["port"][1]["status"] == 400
