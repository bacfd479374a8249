"""The port's chaos harness (``celestia_tpu_torch/testutil/chaosnet.py``)
against the JAX package's, on the CPU.

The chain is a function of (k, height, seed), so twin nodes of the two
packages build the same squares: the shares are equal bytes at every k the
harness runs (1 to 128), and every DAH, sample document and proof is equal
bytes (tolerance: none). Both packages' real RPC servers serve twin
``RpcChaosNode``s and take every route of ``tests/test_chaos.py``: the answers
are equal, ``/status`` up to the uptime and the ``gpu_*`` names the port says
for ``tpu_*`` (ROADMAP Queue 3). The stripped ``ChaosServer`` answers equal
documents too, ``fail_next`` included. Paged mode runs the port's
``PagedEdsCache`` on ``device="cpu"`` (the ragged gather's plain version) and
answers ``sample_batch_ragged`` as JAX's paged node does; with ``device=None``
on this host without a GPU it raises, where the JAX package would quietly serve
host squares. A port node over a store directory the JAX harness wrote
re-indexes it and serves the JAX node's documents.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from celestia_tpu import da as jda
from celestia_tpu.node.rpc import RpcServer as JServer
from celestia_tpu.testutil import chaosnet as jchaos
from celestia_tpu_torch import da as pda
from celestia_tpu_torch.node.rpc import RpcServer as PServer
from celestia_tpu_torch.testutil import chaosnet as pchaos

SEED = 1337


def fetch(base: str, path: str, body: bytes | None = None):
    """(status, parsed body) of one request; HTTP error statuses are answers."""
    req = urllib.request.Request(base + path, data=body,
                                 method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.mark.parametrize("k", [1, 2, 4, 8, 128])
@pytest.mark.parametrize("height,seed", [(1, 7), (5, SEED)])
def test_chain_shares_equal_the_jax_generators(k, height, seed):
    got = pchaos.chain_shares(k, height, seed)
    assert got == jchaos.chain_shares(k, height, seed)
    assert pchaos.chain_array(k, height, seed).tobytes() == b"".join(got)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_the_host_chain_extends_to_the_jax_dah(k):
    eds, dah = pchaos.extend_chain(k, 3, SEED)
    ref = jda.extend_shares(jchaos.chain_shares(k, 3, SEED))
    assert dah.hash() == jda.new_data_availability_header(ref).hash()
    assert np.array_equal(np.asarray(eds.data), np.asarray(ref.data))


def test_without_the_native_runtime_the_chain_extends_on_the_plain_path(monkeypatch):
    native_eds, native_dah = pchaos.extend_chain(4, 2, SEED)
    monkeypatch.setattr(pchaos.native, "available", lambda: False)
    eds, dah = pchaos.extend_chain(4, 2, SEED)
    assert eds.device_data is not None and eds.device_data.device.type == "cpu"
    assert dah.hash() == native_dah.hash()
    assert np.array_equal(np.asarray(eds.data), np.asarray(native_eds.data))


@pytest.fixture(scope="module")
def twins():
    """Twin RpcChaosNodes (k = 2, two heights), each behind its package's
    real RpcServer."""
    jnode = jchaos.RpcChaosNode(heights=2, k=2, seed=SEED)
    pnode = pchaos.RpcChaosNode(heights=2, k=2, seed=SEED)
    servers = {"jax": JServer(jnode, port=0), "port": PServer(pnode, port=0)}
    for srv in servers.values():
        srv.start()
    try:
        yield {name: (node, f"http://127.0.0.1:{srv.port}")
               for (name, srv), node in zip(servers.items(), (jnode, pnode))}
    finally:
        for srv in servers.values():
            srv.stop()


ROUTES = ["/readyz", "/header/1", "/dah/1", "/dah/2", "/dah/9", "/eds/1",
          "/sample/1/0/0", "/sample/2/3/1", "/sample/1/1/3", "/sample/9/0/0",
          "/sample/1/99/0", "/fraud/befp/1", "/balance/alice/utia",
          "/account/alice", "/block/1", "/tx/ab", "/proof/share/1:0:1",
          "/no/such/route"]


@pytest.mark.parametrize("path", ROUTES)
def test_every_route_answers_like_jax(twins, path):
    assert fetch(twins["port"][1], path) == fetch(twins["jax"][1], path)


def _renamed(doc: dict) -> dict:
    out = {}
    for key, value in doc.items():
        if key == "uptime_s":
            continue
        out[key.replace("tpu_", "gpu_")] = value
    return out


def test_status_differs_only_by_the_devices_name(twins):
    js, jdoc = fetch(twins["jax"][1], "/status")
    ps, pdoc = fetch(twins["port"][1], "/status")
    assert js == ps == 200
    assert "gpu_strikes" in pdoc and "tpu_strikes" not in pdoc
    assert _renamed(pdoc) == _renamed(jdoc)


def test_healthz_differs_only_by_uptime(twins):
    (js, jdoc), (ps, pdoc) = (fetch(twins[n][1], "/healthz") for n in ("jax", "port"))
    assert js == ps == 200 and _renamed(jdoc) == _renamed(pdoc)


def test_broadcast_answers_like_jax(twins):
    body = json.dumps({"tx": "00"}).encode()
    assert fetch(twins["port"][1], "/broadcast_tx", body) == fetch(
        twins["jax"][1], "/broadcast_tx", body)


def test_the_stub_app_speaks_the_ports_names():
    app = pchaos._StubApp("c")
    assert app.GPU_STRIKE_LIMIT == jchaos._StubApp.TPU_STRIKE_LIMIT
    assert (app._gpu_strikes, app._gpu_disabled) == (0, False)
    assert not hasattr(app, "_tpu_disabled")
    app.extend_backend = "gpu"
    app._gpu_disabled = True
    assert app.resolve_extend_backend(8) == "numpy"  # the sticky fallback
    app._gpu_disabled = False
    assert app.resolve_extend_backend(8) == "gpu"


@pytest.fixture(scope="module")
def chaos_servers():
    """Twin ChaosNodes behind each package's stripped ChaosServer."""
    jnode = jchaos.ChaosNode(heights=2, k=2, seed=SEED)
    pnode = pchaos.ChaosNode(heights=2, k=2, seed=SEED)
    for node in (jnode, pnode):
        node.balances[("alice", "utia")] = 42
        node.fraud_wires[1] = [{"garbage": 1}]
    servers = {"jax": jchaos.ChaosServer(jnode).start(),
               "port": pchaos.ChaosServer(pnode).start()}
    try:
        yield {name: (srv.node, srv.url) for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.stop()


CHAOS_ROUTES = ["/status", "/header/1", "/header/7", "/dah/2", "/dah/7",
                "/sample/1/0/0", "/sample/2/3/2", "/sample/1/4/0", "/sample/7/0/0",
                "/fraud/befp/1", "/fraud/befp/2", "/balance/alice/utia",
                "/balance/bob/utia", "/account/alice", "/elsewhere"]


@pytest.mark.parametrize("path", CHAOS_ROUTES)
def test_the_chaos_server_answers_like_jax(chaos_servers, path):
    assert fetch(chaos_servers["port"][1], path) == fetch(chaos_servers["jax"][1], path)


def test_the_chaos_servers_broadcast_records_the_tx(chaos_servers):
    body = json.dumps({"tx": "beef"}).encode()
    for name in ("jax", "port"):
        node, url = chaos_servers[name]
        assert fetch(url, "/broadcast_tx", body) == (200, {"code": 0, "log": "",
                                                           "priority": 0})
        assert node.broadcasts[-1] == "beef"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fail_next_answers_500_then_recovers(chaos_servers, pkg):
    node, url = chaos_servers[pkg]
    node.fail_next(2)
    assert fetch(url, "/status")[0] == 500
    assert fetch(url, "/dah/1")[0] == 500
    status, doc = fetch(url, "/status")
    assert status == 200 and doc == {"chain_id": "chaos-net", "height": 2}


def _crowd(seed: int, heights, width: int, n: int):
    rng = np.random.default_rng(seed)
    return [(int(rng.choice(heights)), int(rng.integers(0, width + 1)),
             int(rng.integers(0, width))) for _ in range(n)]


@pytest.mark.parametrize("budget_pages", [2, 64])
def test_paged_sample_batch_ragged_equals_the_jax_paged_node(budget_pages):
    """A mixed-height crowd (a row past the width among it, and an unknown
    height) through both packages' paged nodes: equal documents, and the
    port's pages demote and fault in under a two-page budget."""
    k, rpp = 4, 2
    page = rpp * 2 * k * pda.SHARE_SIZE
    jnode = jchaos.RpcChaosNode(heights=3, k=k, seed=SEED, rows_per_page=rpp,
                                paged_budget_bytes=budget_pages * page)
    pnode = pchaos.RpcChaosNode(heights=3, k=k, seed=SEED, rows_per_page=rpp,
                                paged_budget_bytes=budget_pages * page, device="cpu")
    crowd = _crowd(3, (1, 2, 3, 4), 2 * k, 40)
    assert pnode.sample_batch_ragged(crowd) == jnode.sample_batch_ragged(crowd)
    assert pnode._eds_cache.device.type == "cpu"
    stats = pnode._eds_cache.stats()
    if budget_pages == 2:
        assert stats["page_demotes"] > 0 and stats["page_faultins"] > 0
    assert pnode.sample_batch(2, [(0, 0), (9, 1)]) == jnode.sample_batch(2, [(0, 0), (9, 1)])


def test_paged_grow_pages_the_new_height():
    pnode = pchaos.RpcChaosNode(heights=1, k=2, seed=SEED,
                                paged_budget_bytes=1 << 20, device="cpu")
    jnode = jchaos.RpcChaosNode(heights=1, k=2, seed=SEED, paged_budget_bytes=1 << 20)
    assert pnode.grow() == jnode.grow() == 2
    assert 2 in pnode._eds_cache
    crowd = [(2, i, j) for i in range(4) for j in range(4)]
    assert pnode.sample_batch_ragged(crowd) == jnode.sample_batch_ragged(crowd)


def test_paged_mode_without_a_gpu_raises_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pchaos.RpcChaosNode(heights=1, k=2, paged_budget_bytes=1 << 20)
    node = pchaos.RpcChaosNode(heights=1, k=2)  # non-paged: host squares only
    assert node._eds_cache is None and node.device.type == "cpu"


def test_a_tampering_subclass_keeps_the_per_height_lie():
    """block_row overrides bypass the paged gather, as in the JAX harness."""
    class Liar(pchaos.RpcChaosNode):
        def block_row(self, height, i):
            row = super().block_row(height, i)
            return [bytes(len(c)) for c in row] if row else row

    node = Liar(heights=1, k=2, seed=SEED, paged_budget_bytes=1 << 20, device="cpu")
    honest = pchaos.RpcChaosNode(heights=1, k=2, seed=SEED)
    docs = node.sample_batch_ragged([(1, 0, 0), (1, 1, 2)])
    assert docs == node.sample_batch(1, [(0, 0), (1, 2)])
    assert docs != honest.sample_batch_ragged([(1, 0, 0), (1, 1, 2)])


@pytest.mark.parametrize("paged", [False, True])
def test_a_restart_over_a_jax_written_store_serves_the_jax_documents(tmp_path, paged):
    k = 4
    jnode = jchaos.RpcChaosNode(heights=3, k=k, seed=SEED, store_dir=str(tmp_path))
    kw = {"paged_budget_bytes": 1 << 20, "device": "cpu"} if paged else {}
    restarted = pchaos.RpcChaosNode(heights=0, k=k, seed=SEED, store_dir=str(tmp_path), **kw)
    assert restarted.blocks == {} and restarted.latest_height() == 3
    for h in (1, 2, 3):
        assert restarted.block_dah(h).to_json() == jnode.block_dah(h).to_json()
    crowd = _crowd(11, (1, 2, 3), 2 * k, 30)
    assert restarted.sample_batch_ragged(crowd) == jnode.sample_batch_ragged(crowd)
    assert restarted.store.stats()["page_reads"] > 0
    assert restarted.block_width(2) == 2 * k and restarted.block_row(9, 0) is None
    # the restarted node grows past the stored heights, persisting each
    assert restarted.grow() == 4 and 4 in restarted.store


def test_a_store_written_by_the_port_serves_the_jax_restart(tmp_path):
    pchaos.RpcChaosNode(heights=2, k=2, seed=SEED, store_dir=str(tmp_path))
    jnode = jchaos.RpcChaosNode(heights=0, k=2, seed=SEED, store_dir=str(tmp_path))
    ref = jchaos.RpcChaosNode(heights=2, k=2, seed=SEED)
    crowd = [(h, i, j) for h in (1, 2) for i in range(4) for j in range(0, 4, 3)]
    assert jnode.sample_batch_ragged(crowd) == ref.sample_batch_ragged(crowd)
