"""The port's gateway (``celestia_tpu_torch/node/gateway.py``) against the JAX
package's, on the CPU.

For the same backend set both packages' rings place every key on the same
owner and the same hedge candidates, and ``add_backend``/``remove_backend``
move the same keys (only those of the joining or leaving backend). Both
gateways key routes alike, hedge past a backend answering 503 (opening its
cooldown), pass other statuses through, answer 503 when every candidate is
down and 405 to a POST, and serve a repeated ``/dah/<h>`` from their cache.
Over twin backends (each package's ``RpcChaosNode`` behind its ``RpcServer``)
the ``/status``, ``/readyz`` and routed documents are equal, up to the
backends' URLs, uptimes and the ``gpu_*`` names the port says for ``tpu_*``.
"""

import http.server
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from celestia_tpu.node import gateway as jgw
from celestia_tpu.node.rpc import RpcServer as JServer
from celestia_tpu.telemetry import metrics as jmetrics
from celestia_tpu.testutil.chaosnet import RpcChaosNode as JNode
from celestia_tpu_torch.node import gateway as pgw
from celestia_tpu_torch.node.rpc import RpcServer as PServer
from celestia_tpu_torch.telemetry import metrics as pmetrics
from celestia_tpu_torch.testutil.chaosnet import RpcChaosNode as PNode

PKGS = {"jax": (jgw, JServer, JNode, jmetrics), "port": (pgw, PServer, PNode, pmetrics)}
BACKEND_SETS = [
    ["http://127.0.0.1:9001"],
    ["http://127.0.0.1:9001", "http://127.0.0.1:9002", "http://127.0.0.1:9003"],
    [f"http://10.0.0.{i}:26657" for i in range(1, 8)],
]
KEYS = [f"{h}:{i}" for h in range(1, 9) for i in range(0, 256, 9)] + ["/status", "/x"]


def _get(url: str, timeout: float = 10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


@pytest.mark.parametrize("backends", BACKEND_SETS, ids=["one", "three", "seven"])
@pytest.mark.parametrize("vnodes", [1, 64])
def test_the_ring_places_every_key_like_jax(backends, vnodes):
    jr, pr = jgw.HashRing(backends, vnodes=vnodes), pgw.HashRing(backends, vnodes=vnodes)
    assert pr.backends() == jr.backends() and len(pr) == len(jr)
    for key in KEYS:
        assert pr.owners(key) == jr.owners(key)
        assert pr.owners(key, n=2) == jr.owners(key, n=2)
    assert pr._points == jr._points


@pytest.mark.parametrize("change", ["add", "remove"])
def test_rebalance_moves_the_same_keys_as_jax(change):
    base = BACKEND_SETS[1]
    other = "http://127.0.0.1:9004"
    moved = {}
    for name, mod in (("jax", jgw), ("port", pgw)):
        ring = mod.HashRing(base + ([other] if change == "remove" else []))
        before = {key: ring.owners(key, n=1)[0] for key in KEYS}
        (ring.add if change == "add" else ring.remove)(other)
        after = {key: ring.owners(key, n=1)[0] for key in KEYS}
        moved[name] = {key for key in KEYS if before[key] != after[key]}
        # consistent hashing: only the joining/leaving backend's arcs move
        assert all(other in (before[key], after[key]) for key in moved[name])
    assert moved["port"] == moved["jax"] and moved["port"]


def test_an_empty_ring_has_no_owner_and_a_duplicate_add_is_a_noop():
    ring = pgw.HashRing()
    assert ring.owners("1:0") == [] and len(ring) == 0
    ring.add("http://a")
    ring.add("http://a")
    ring.remove("http://b")
    assert ring.backends() == ["http://a"] and len(ring._points) == pgw.DEFAULT_VNODES


PATHS = ["/sample/3/17/4", "/sample/3/17/9", "/sample/x/1/2", "/dah/5", "/dah/5?x=1",
         "/eds/7", "/proof/share/4:0:8", "/namespace_data/9/00ff", "/status", "/dah/abc",
         "/header/12", "/"]


@pytest.mark.parametrize("path", PATHS)
def test_routes_key_like_jax(path):
    assert pgw.Gateway._route_key(path) == jgw.Gateway._route_key(path)
    assert pgw.Gateway._dah_height(path) == jgw.Gateway._dah_height(path)


@pytest.mark.parametrize("pkg", ["jax", "port"])
class TestShedCooldown:
    def test_note_cooldown_demotes_and_counts(self, pkg):
        mod, _srv, _node, metrics = PKGS[pkg]
        gw = mod.Gateway(["http://a/", "http://b/", "http://c/"])
        before = metrics.get_counter("gateway_backend_cooldown_total")
        gw._note_cooldown("http://b/", "0.5")
        assert metrics.get_counter("gateway_backend_cooldown_total") == before + 1
        assert gw._demote_cooling(["http://a/", "http://b/", "http://c/"]) == [
            "http://a/", "http://c/", "http://b/"]
        gw._note_cooldown("http://b/", "0.6")  # extends the open window
        assert metrics.get_counter("gateway_backend_cooldown_total") == before + 1

    def test_garbled_and_oversized_retry_after(self, pkg):
        mod = PKGS[pkg][0]
        gw = mod.Gateway([], cooldown_s=0.4, cooldown_max_s=2.0)
        t0 = time.monotonic()
        gw._note_cooldown("http://x/", "not-a-number")
        gw._note_cooldown("http://y/", "9999")
        with gw._cooldown_lock:
            assert 0.2 <= gw._cooldown["http://x/"] - t0 <= 0.5
            assert gw._cooldown["http://y/"] - t0 <= 2.1

    def test_cooldown_expires_and_is_pruned(self, pkg):
        mod = PKGS[pkg][0]
        gw = mod.Gateway([])
        gw._note_cooldown("http://b/", "0.05")
        time.sleep(0.1)
        assert gw._demote_cooling(["http://a/", "http://b/"]) == ["http://a/", "http://b/"]
        with gw._cooldown_lock:
            assert "http://b/" not in gw._cooldown


class _Shedder(http.server.BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        body = b'{"error": "shed"}'
        self.send_response(503)
        self.send_header("Retry-After", "1.5")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def fleets():
    """Per package: two twin backends (k = 2, two heights, one seed) behind
    that package's RpcServer, a shedder answering 503 to everything, and a
    gateway over the two backends."""
    shed = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Shedder)
    threading.Thread(target=shed.serve_forever, daemon=True).start()
    out, stops = {}, [shed.shutdown, shed.server_close]
    for name, (mod, server_cls, node_cls, _metrics) in PKGS.items():
        urls = []
        for _ in range(2):
            srv = server_cls(node_cls(heights=2, k=2, seed=9, chain_id="gw-t"), port=0)
            srv.start()
            stops.append(srv.stop)
            urls.append(f"http://127.0.0.1:{srv.port}")
        gw = mod.Gateway(urls, timeout_s=5.0, status_timeout_s=0.5)
        gw.start()
        stops.append(gw.stop)
        out[name] = (gw, urls)
    out["shed"] = f"http://127.0.0.1:{shed.server_address[1]}"
    try:
        yield out
    finally:
        for stop in reversed(stops):
            stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_the_hedge_passes_a_503_and_opens_its_cooldown(fleets, pkg):
    gw, urls = fleets[pkg]
    metrics = PKGS[pkg][3]
    hedges = metrics.get_counter("gateway_hedge_total")
    status, body, backend = gw.fetch_hedged("/dah/1", [fleets["shed"], urls[0]])
    assert (status, backend) == (200, urls[0])
    assert metrics.get_counter("gateway_hedge_total") == hedges + 1
    assert gw._demote_cooling([fleets["shed"], urls[0]]) == [urls[0], fleets["shed"]]
    # every candidate shedding surfaces the 503; a 404 passes through unhedged
    assert gw.fetch_hedged("/dah/1", [fleets["shed"]])[0] == 503
    assert gw.fetch_hedged("/dah/9", urls)[:3:2] == (404, urls[0])


def test_the_hedged_answers_are_the_jax_answers(fleets):
    jbody = fleets["jax"][0].fetch_hedged("/sample/2/1/3", [fleets["shed"], fleets["jax"][1][1]])
    pbody = fleets["port"][0].fetch_hedged("/sample/2/1/3", [fleets["shed"], fleets["port"][1][1]])
    assert pbody[:2] == jbody[:2] and pbody[0] == 200


def _normalized(doc, urls):
    """Backend URLs to their index, uptimes dropped, tpu_* read as gpu_*."""
    if isinstance(doc, dict):
        return {(f"backend{urls.index(k)}" if k in urls else k.replace("tpu_", "gpu_")):
                _normalized(v, urls) for k, v in doc.items() if k != "uptime_s"}
    if isinstance(doc, list):
        return [_normalized(v, urls) for v in doc]
    if isinstance(doc, str) and doc in urls:
        return f"backend{urls.index(doc)}"
    return doc


@pytest.mark.parametrize("path", ["/status", "/readyz", "/healthz", "/dah/2", "/sample/1/2/3",
                                  "/sample/2/3/0", "/eds/1", "/sample/5/0/0"])
def test_the_gateways_answer_like_jax(fleets, path):
    answers = {}
    for pkg in ("jax", "port"):
        gw, urls = fleets[pkg]
        status, body, headers = _get(gw.url + path)
        doc = json.loads(body)
        if path == "/status":
            doc["gateway"].pop("url")
            assert doc["gateway"]["backends"] == sorted(urls)
            doc["gateway"]["backends"] = urls  # sorted by URL, i.e. by port
        # the ring hashes the backends' URLs, whose ports differ between the
        # twins, so each gateway may pick the other twin: both are backends
        assert headers.get("X-Gateway-Backend") in urls + [None]
        answers[pkg] = (status, _normalized(doc, urls))
    assert answers["port"] == answers["jax"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_repeated_dah_is_served_from_the_gateway_cache(fleets, pkg):
    gw, _urls = fleets[pkg]
    metrics = PKGS[pkg][3]
    _get(gw.url + "/dah/1")
    hits = metrics.get_counter("gateway_dah_cache_hits_total")
    status, body, headers = _get(gw.url + "/dah/1")
    assert status == 200 and headers["X-Gateway-Backend"] == "cache"
    assert metrics.get_counter("gateway_dah_cache_hits_total") == hits + 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_post_is_refused_405(fleets, pkg):
    gw, _urls = fleets[pkg]
    req = urllib.request.Request(gw.url + "/broadcast_tx", data=b"{}", method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=5)
    assert err.value.code == 405
    assert json.loads(err.value.read()) == {"error": "gateway is read-only", "status": 405}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_down_member_is_reported_fast_and_a_dead_ring_is_503(pkg):
    mod, server_cls, node_cls, _metrics = PKGS[pkg]
    srv = server_cls(node_cls(heights=1, k=2), port=0)
    srv.start()
    live, dead = f"http://127.0.0.1:{srv.port}", "http://127.0.0.1:9"
    gw = mod.Gateway([live, dead], timeout_s=5.0, status_timeout_s=0.5)
    gw.start()
    try:
        t0 = time.monotonic()
        status, body, _h = _get(gw.url + "/status")
        doc = json.loads(body)
        assert status == 200 and time.monotonic() - t0 < 4.0
        assert doc["backends"][dead]["state"] == "down"
        assert doc["gateway"]["down_backends"] == [dead]
        assert _get(gw.url + "/readyz")[0] == 200
        srv.stop(drain_timeout=0.5)
        status, body, _h = _get(gw.url + "/dah/1")
        assert status == 503 and json.loads(body)["error"] == "gateway_unavailable"
        assert _get(gw.url + "/readyz")[0] == 503
    finally:
        gw.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_the_ring_gauge_tracks_membership(pkg):
    mod, _srv, _node, metrics = PKGS[pkg]
    gw = mod.Gateway(["http://a", "http://b"])
    assert metrics.get_gauge("gateway_ring_backends") == 2.0
    gw.remove_backend("http://a")
    assert metrics.get_gauge("gateway_ring_backends") == 1.0
    gw.add_backend("http://c")
    assert gw.ring.backends() == ["http://b", "http://c"]


def test_a_hedge_storm_during_membership_churn_never_500s():
    """Clients storm the port's gateway (the interpreter switching threads
    every 10 µs) while one backend leaves and rejoins the ring: every
    answer is a real status, never a 500, and every 200 verifies against
    the JAX chain's DAH."""
    import sys

    from celestia_tpu_torch.scenarios.world import _verify_sample

    servers = [PServer(PNode(heights=1, k=4, seed=7), port=0) for _ in range(2)]
    for srv in servers:
        srv.start()
    url_a, url_b = (f"http://127.0.0.1:{srv.port}" for srv in servers)
    gw = pgw.Gateway([url_a, url_b], timeout_s=2.0)
    gw.start()
    dah = JNode(heights=1, k=4, seed=7).block_dah(1)
    statuses, bad = [], []
    lock, stop = threading.Lock(), threading.Event()

    def client(ci: int) -> None:
        while not stop.is_set():
            i, j = ci % 8, (ci * 3) % 8
            status, body, _h = _get(f"{gw.url}/sample/1/{i}/{j}", timeout=5.0)
            ok = status != 200 or _verify_sample(dah, 4, i, j, json.loads(body))
            with lock:
                statuses.append(status)
                if not ok:
                    bad.append(body)

    def churn() -> None:
        while not stop.is_set():
            gw.remove_backend(url_b)
            time.sleep(0.02)
            gw.add_backend(url_b)
            time.sleep(0.02)

    threads = [threading.Thread(target=client, args=(ci,), daemon=True) for ci in range(6)]
    threads.append(threading.Thread(target=churn, daemon=True))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        time.sleep(1.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(interval)
        gw.stop()
        for srv in servers:
            srv.stop(drain_timeout=0.5)
    assert not any(t.is_alive() for t in threads)
    assert statuses and statuses.count(200) > 0
    assert 500 not in statuses and not bad
    assert gw.ring.backends() == sorted([url_a, url_b])
