"""The port's serving node (celestia_tpu_torch/node/node.py) against the JAX
package's: the JAX ``RpcChaosNode`` in paged mode and the JAX ``Node``.

Heights 1, 2 and 3 hold chain_shares squares at k = 2, 8 and 32, extended
by the port on the CPU and put in the node's paged cache as the JAX node's
ExtendBlock retention puts them (``node._eds_cache.put``). DAS samples,
per height and as one ragged group across heights (duplicates, the
"range" and None sentinels, interleaved positions), give the JAX nodes'
documents byte for byte, at a roomy and a one-page budget, and every proof
verifies against the port's ``block_dah``. An armed ``cache.faultin``
bitflip heals the height it names, as the JAX Node does; provers come from
the device row levels where a square has a device buffer, equal to the
host-built ones, and a failure there raises.
"""

import functools
import gc
import json

import jax
import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu import faults as jax_faults
from celestia_tpu.integrity import IntegrityError as JaxIntegrityError
from celestia_tpu.node import eds_cache as jax_eds_cache
from celestia_tpu.node import node as jax_node
from celestia_tpu.testutil.chaosnet import RpcChaosNode, chain_shares
from celestia_tpu_torch import da, faults
from celestia_tpu_torch.node import Node, eds_cache
from celestia_tpu_torch.ops import extend
from celestia_tpu_torch.proof import NmtRangeProof
from celestia_tpu_torch.telemetry import metrics

HEIGHT_KS = ((1, 2), (2, 8), (3, 32))
ROWS_PER_PAGE = 4
ROOMY = 1 << 30
ONE_PAGE = ROWS_PER_PAGE * 64 * 512  # one page of the k = 32 square


@functools.lru_cache(maxsize=None)
def port_eds(k: int, height: int) -> np.ndarray:
    """The port's extension of chain_shares(k, height), on the CPU."""
    return da.extend_shares(chain_shares(k, height), device="cpu").data


def port_node(budget: int, rows_per_page: int = ROWS_PER_PAGE, heights=HEIGHT_KS,
              max_heights: int = 1 << 30) -> Node:
    node = Node(device="cpu")
    node._eds_cache = eds_cache.PagedEdsCache(rows_per_page=rows_per_page,
                                              device_byte_budget=budget,
                                              max_heights=max_heights, device="cpu")
    for h, k in heights:
        node._eds_cache.put(h, da.ExtendedDataSquare.from_device(
            torch.from_numpy(port_eds(k, h).copy()), k))
    return node


@pytest.fixture(autouse=True, scope="module")
def _collect_jax_caches():
    """The JAX package's caches enrol in its device ledger until they are
    collected (they hold reference cycles): collect them before the next
    module, so none of this module's outlives it."""
    yield
    gc.collect()


def chaos_node(budget: int) -> RpcChaosNode:
    node = RpcChaosNode(heights=1, k=2, paged_budget_bytes=budget,
                        rows_per_page=ROWS_PER_PAGE)
    for _h, k in HEIGHT_KS[1:]:
        node.k = k
        node.grow()
    return node


def payloads_for(widths: dict[int, int]) -> list:
    out = []
    for h, w in widths.items():
        out += [(h, 0, 0), (h, w - 1, w // 2), (h, 0, 0), (h, w, 0), (h, 1, w - 1),
                (h, w // 2, 1)]
    out += [(99, 0, 0)]  # an unknown height
    return out[::3] + out[1::3] + out[2::3]  # interleaved


def test_chaos_node_holds_the_ports_squares():
    node = chaos_node(ROOMY)
    for h, k in HEIGHT_KS:
        assert np.array_equal(np.asarray(node.blocks[h][0].data), port_eds(k, h))


@pytest.mark.parametrize("budget", [ROOMY, ONE_PAGE])
def test_sample_batch_ragged_equals_jax(budget):
    theirs_node = chaos_node(budget)
    node = port_node(budget)
    widths = {h: node.block_width(h) for h, _k in HEIGHT_KS}
    assert widths == {h: theirs_node.block_width(h) for h in widths}
    payloads = payloads_for(widths)
    b0 = metrics.get_counter("dispatch_ragged_batch_total")
    j0 = metrics.get_counter("dispatch_ragged_jobs_total")
    ours = node.sample_batch_ragged(payloads)
    assert metrics.get_counter("dispatch_ragged_batch_total") - b0 == 1.0
    assert metrics.get_counter("dispatch_ragged_jobs_total") - j0 == len(payloads)
    assert ours == theirs_node.sample_batch_ragged(payloads)
    assert ours.count(None) == 1 and ours.count("range") == len(widths)
    # the per-height path gives the same documents, in both packages
    for h in list(widths) + [99]:
        coords = [(i, j) for hh, i, j in payloads if hh == h]
        want = [d for (hh, _i, _j), d in zip(payloads, ours) if hh == h]
        assert node.sample_batch(h, coords) == want == theirs_node.sample_batch(h, coords)
    verified = 0
    for (h, i, j), doc in zip(payloads, ours):
        if not isinstance(doc, dict):
            continue
        share = bytes.fromhex(doc["share"])
        p = doc["proof"]
        proof = NmtRangeProof(p["start"], p["end"], [bytes.fromhex(x) for x in p["nodes"]],
                              p["tree_size"])
        ns = da.erasured_leaf_namespace(i, j, share, widths[h] // 2)
        proof.verify_inclusion(node.block_dah(h).row_roots[i], [ns], [share])
        verified += 1
    assert verified == 5 * len(widths)
    if budget == ONE_PAGE:
        st = node._eds_cache.stats()
        assert st["page_demotes"] > 0 and st["page_faultins"] > 0


def test_block_reads_and_dah_equal_jax():
    theirs_node = chaos_node(ROOMY)
    node = port_node(ROOMY)
    for h, k in HEIGHT_KS:
        w = 2 * k
        assert node.block_row(h, w - 1) == theirs_node.block_row(h, w - 1)
        assert node.block_share(h, 1, w - 2) == theirs_node.blocks[h][0].share(1, w - 2)
        ours, theirs = node.block_dah(h), theirs_node.block_dah(h)
        assert ours.row_roots == theirs.row_roots
        assert ours.column_roots == theirs.column_roots
        assert ours.hash() == theirs.hash()
        assert node.block_dah(h) is ours  # memoized
    assert node.block_dah(99) is None and node.block_width(99) is None
    assert node.block_row(99, 0) is None and node.block_share(99, 0, 0) is None


class _App:
    published_eds = None


def jax_twin(budget: int, rows_per_page: int, heights, max_heights: int):
    """The JAX Node over a JAX PagedEdsCache fed the same squares."""
    node = jax_node.Node(_App())
    node._eds_cache = jax_eds_cache.PagedEdsCache(rows_per_page=rows_per_page,
                                                  device_byte_budget=budget,
                                                  max_heights=max_heights)
    for h, k in heights:
        node._eds_cache.put(h, jax_da.ExtendedDataSquare.from_device(
            jax.device_put(port_eds(k, h)), k))
    return node


HEAL_HEIGHTS = ((1, 4), (2, 4), (3, 4))


@pytest.mark.parametrize("times", [1, None])
def test_ragged_heal_invalidates_only_the_named_height(times):
    page = 2 * 8 * 512
    ours_node = port_node(page, 2, HEAL_HEIGHTS, 3)
    theirs_node = jax_twin(page, 2, HEAL_HEIGHTS, 3)
    payloads = [(h, i, (3 * i + h) % 8) for h, _k in HEAL_HEIGHTS for i in range(8)]
    clean = port_node(ROOMY, 2, HEAL_HEIGHTS, 3).sample_batch_ragged(payloads)
    docs = []
    for flt, node in ((jax_faults, theirs_node), (faults, ours_node)):
        with flt.inject(flt.rule("cache.faultin", "bitflip", times=times), seed=5):
            docs.append(node.sample_batch_ragged(payloads))
    theirs, ours = docs
    assert ours == theirs
    healed = {h for (h, _i, _j), d in zip(payloads, ours) if d is None}
    assert healed and all(h not in ours_node._eds_cache for h in healed)
    if times == 1:
        assert len(healed) == 1  # only the named height
    for (h, _i, _j), d, c in zip(payloads, ours, clean):
        assert d == (None if h in healed else c)
    assert ours_node._eds_cache.stats() == theirs_node._eds_cache.stats()


def test_sample_batch_heal_like_jax():
    page = 2 * 8 * 512
    ours_node = port_node(page, 2, HEAL_HEIGHTS[:1], 1)
    theirs_node = jax_twin(page, 2, HEAL_HEIGHTS[:1], 1)
    coords = [(i, 7 - i) for i in range(8)]
    docs = []
    for flt, node in ((jax_faults, theirs_node), (faults, ours_node)):
        with flt.inject(flt.rule("cache.faultin", "bitflip", times=1), seed=5):
            docs.append(node.sample_batch(1, coords))
    assert docs[1] == docs[0] == [None] * 8  # invalidated; no host rebuild here
    assert 1 not in ours_node._eds_cache


def resident_node(k: int, height: int, on_device: bool = True) -> Node:
    node = Node(device="cpu")
    node._eds_cache = eds_cache.ResidentEdsCache()
    if on_device:
        eds = da.extend_shares(chain_shares(k, height), device="cpu")
        assert eds.device_data is not None
    else:
        eds = port_eds(k, height)  # a raw host array
    node._eds_cache.put(height, eds)
    return node


@pytest.mark.parametrize("k", [2, 8])
def test_row_provers_from_device_levels_equal_host_provers(k):
    node = resident_node(k, 5)
    w = 2 * k
    coords = [(i, (i * 5) % w) for i in range(w)] + [(0, 0), (w - 1, 0)]
    ours = node.sample_batch(5, coords)
    levels, provers = node._prover_cache[5]
    assert levels is not None and len(levels) == w.bit_length()
    assert sorted(provers) == list(range(w))
    for a, b in zip(levels, extend.eds_row_levels_device(port_eds(k, 5), device="cpu")):
        assert np.array_equal(a, b)
    host = resident_node(k, 5, on_device=False)  # device "cpu": host provers
    assert host.sample_batch(5, coords) == ours
    assert host._prover_cache[5][0] is None
    # the JAX node on a device-resident square seeds from its own levels
    theirs_node = jax_node.Node(_App())
    theirs_node._eds_cache = jax_eds_cache.ResidentEdsCache()
    theirs_node._eds_cache.put(5, jax_da.ExtendedDataSquare.from_device(
        jax.device_put(port_eds(k, 5)), k))
    assert theirs_node.sample_batch(5, coords) == ours
    assert theirs_node._prover_cache[5][0] is not None
    assert node.block_dah(5).hash() == theirs_node.block_dah(5).hash()


def test_row_prover_memo_is_bounded():
    node = resident_node(2, 1)
    node._eds_cache.capacity = 8
    for h in range(10, 16):
        node._eds_cache.put(h, da.ExtendedDataSquare.from_device(
            torch.from_numpy(port_eds(2, 1).copy()), 2))
        node.sample_batch(h, [(0, 0)])
    assert len(node._prover_cache) == Node._PROVER_CACHE_HEIGHTS


def test_device_level_failure_raises(monkeypatch):
    node = resident_node(2, 1)

    def broken(*_a, **_k):
        raise RuntimeError("the card failed")

    monkeypatch.setattr(extend, "eds_row_levels_device", broken)
    with pytest.raises(RuntimeError, match="the card failed"):
        node.sample_batch(1, [(0, 0)])
    assert 1 not in node._prover_cache


def test_published_squares_take_precedence():
    class App:
        published_eds = {}

    node = port_node(ROOMY, heights=HEIGHT_KS[:1])
    other = da.extend_shares(chain_shares(2, 77), device="cpu")
    node.app = App()
    node.app.published_eds[1] = other
    assert node.block_eds(1) is other
    assert node.block_row(1, 0) == other.row(0)
    assert node.sample_batch_ragged([(1, 0, 0)])[0]["share"] == other.share(0, 0).hex()


def test_gauges_follow_the_nodes_cache():
    node = port_node(ONE_PAGE)
    node.sample_batch_ragged([(3, 5, 5), (2, 1, 1)])
    st = node._eds_cache.stats()
    assert metrics.get_gauge("eds_cache_pages_resident") == st["pages_resident"]
    assert metrics.get_gauge("eds_cache_device_bytes") == st["device_bytes"]
    assert metrics.get_gauge("eds_cache_pin_count") == 0


# ---------------------------------------------------------------------- #
# the durable tier: a node with a home persists, restarts and serves from
# disk, against the JAX Node doing the same in a home of its own


STORE_KS = ((1, 2), (2, 8), (3, 16))


def jax_square(k: int, height: int):
    return jax_da.ExtendedDataSquare.from_device(jax.device_put(port_eds(k, height)), k)


def port_square(k: int, height: int):
    return da.ExtendedDataSquare.from_device(torch.from_numpy(port_eds(k, height).copy()), k)


def persisted_pair(tmp_path, heights=STORE_KS, rows_per_page=None):
    """A port node and a JAX node, each with its own home, each persisting
    the same squares as retention and _persist_block_eds do; the store files
    are byte-identical."""
    ours = Node(device="cpu", home=tmp_path / "port")
    theirs = jax_node.Node(_App(), home=str(tmp_path / "jax"))
    if rows_per_page is not None:
        ours._eds_cache = eds_cache.PagedEdsCache(rows_per_page=rows_per_page, store=ours.store,
                                                  device="cpu")
        theirs._eds_cache = jax_eds_cache.PagedEdsCache(rows_per_page=rows_per_page,
                                                        store=theirs.store)
    for h, k in heights:
        sq = port_square(k, h)
        ours._eds_cache.put(h, sq)
        ours._persist_block_eds(h, sq)
        jsq = jax_square(k, h)
        theirs._eds_cache.put(h, jsq)
        theirs._persist_block_eds(h, jsq)
    for h, _k in heights:
        assert ((tmp_path / "port" / "store" / f"{h}.ctps").read_bytes()
                == (tmp_path / "jax" / "store" / f"{h}.ctps").read_bytes()), h
    return ours, theirs


def restarted(tmp_path, which: str) -> tuple:
    return (Node(device="cpu", home=tmp_path / which),
            jax_node.Node(_App(), home=str(tmp_path / which)))


def test_restarted_node_serves_as_before_and_as_jax(tmp_path):
    ours, theirs = persisted_pair(tmp_path)
    widths = {h: 2 * k for h, k in STORE_KS}
    payloads = payloads_for(widths)
    before = ours.sample_batch_ragged(payloads)
    assert before == theirs.sample_batch_ragged(payloads)
    dahs = {h: json.dumps(ours.block_dah(h).to_json(), sort_keys=True) for h in widths}
    ours, _ = restarted(tmp_path, "port")
    _, theirs = restarted(tmp_path, "jax")
    assert ours.store.heights() == sorted(widths)
    after = ours.sample_batch_ragged(payloads)
    assert after == before == theirs.sample_batch_ragged(payloads)
    for h in widths:  # provers from the stored levels, with no hashing
        assert ours._prover_cache[h][0] is not None
        assert theirs._prover_cache[h][0] is not None
        assert json.dumps(ours.block_dah(h).to_json(), sort_keys=True) == dahs[h]
        assert ours.block_dah(h).hash() == theirs.block_dah(h).hash()
    st = ours._eds_cache.stats()
    assert st["heights_from_store"] == 3 and st["page_store_loads"] > 0
    assert st == theirs._eds_cache.stats()
    for h, _k in STORE_KS:
        coords = [(i, j) for hh, i, j in payloads if hh == h]
        assert ours.sample_batch(h, coords) == theirs.sample_batch(h, coords)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_node_restarts_over_the_others_home(tmp_path, reader):
    ours, _theirs = persisted_pair(tmp_path)
    payloads = payloads_for({h: 2 * k for h, k in STORE_KS})
    want = ours.sample_batch_ragged(payloads)
    home = tmp_path / ("jax" if reader == "port" else "port")
    node = (Node(device="cpu", home=home) if reader == "port"
            else jax_node.Node(_App(), home=str(home)))
    assert node.sample_batch_ragged(payloads) == want


def test_block_dah_after_restart_reads_no_page(tmp_path):
    ours, theirs = persisted_pair(tmp_path)
    served = {h: json.dumps(theirs.block_dah(h).to_json(), sort_keys=True) for h, _k in STORE_KS}
    node, _ = restarted(tmp_path, "port")
    for h, _k in STORE_KS:
        assert json.dumps(node.block_dah(h).to_json(), sort_keys=True) == served[h]
    assert node._eds_cache.stats()["pages"] == 0  # no square was read


def test_persist_fetches_the_square_once_and_records_its_stages(tmp_path):
    from celestia_tpu_torch import tracing

    node = Node(device="cpu", home=tmp_path)
    sq = port_square(8, 1)
    node._eds_cache.put(1, sq)
    before = metrics.get_counter("transfer_bytes", site="store.persist", direction="d2h")
    sink = tracing.push_stage_sink()
    try:
        node._persist_block_eds(1, sq)
    finally:
        tracing.pop_stage_sink()
    moved = metrics.get_counter("transfer_bytes", site="store.persist", direction="d2h") - before
    assert moved == 16 * 16 * 512
    assert {"levels", "d2h", "crc", "write"} <= set(sink.data)
    entry = node.store.entry(1)
    assert entry.levels_len > 0 and entry.rows_per_page == node._eds_cache.rows_per_page
    # a host square persists without levels, and fetches nothing
    node._persist_block_eds(2, port_eds(2, 2))
    assert node.store.entry(2).levels_len == 0
    assert metrics.get_counter("transfer_bytes", site="store.persist",
                               direction="d2h") - before == moved


def test_device_level_failure_raises_at_persist(tmp_path, monkeypatch):
    node = Node(device="cpu", home=tmp_path)
    sq = port_square(2, 1)
    node._eds_cache.put(1, sq)

    def broken(*_a, **_k):
        raise RuntimeError("the card failed")

    monkeypatch.setattr(extend, "eds_row_levels_device", broken)
    with pytest.raises(RuntimeError, match="the card failed"):
        node._persist_block_eds(1, sq)
    assert 1 not in node.store


@pytest.mark.parametrize("kind", ["enospc", "short_write", "fsync_fail"])
def test_disk_failure_at_persist_leaves_serving_to_the_cache(tmp_path, kind):
    ours = Node(device="cpu", home=tmp_path / "port")
    theirs = jax_node.Node(_App(), home=str(tmp_path / "jax"))
    site = "store.fsync" if kind == "fsync_fail" else "store.write"
    for flt, node, sq in ((faults, ours, port_square(2, 1)),
                          (jax_faults, theirs, jax_square(2, 1))):
        node._eds_cache.put(1, sq)
        with flt.inject(flt.rule(site, kind), seed=5):
            node._persist_block_eds(1, sq)  # logged, not raised
        assert 1 not in node.store
        assert node.store.read_only == (kind == "enospc")
    assert ours.sample_batch(1, [(0, 1)]) == theirs.sample_batch(1, [(0, 1)])
    assert ours.sample_batch(1, [(0, 1)])[0] is not None


@pytest.mark.parametrize("times", [1, None])
def test_store_read_drill_refuses_the_struck_height(tmp_path, times):
    """A page record failing its CRC refuses that height's store copy: the
    height answers None and the others as before. The JAX node heals every
    height of the group and reads them again: a one-shot flip answers all,
    a lasting one raises (a difference of record)."""
    ours, theirs = persisted_pair(tmp_path)
    payloads = payloads_for({h: 2 * k for h, k in STORE_KS})
    want = ours.sample_batch_ragged(payloads)
    node, jnode = restarted(tmp_path, "port")[0], restarted(tmp_path, "jax")[1]
    sdc = metrics.get_counter("sdc_detected_total", site="store.read")
    with faults.inject(faults.rule("store.read", "bitflip", times=times), seed=5):
        got = node.sample_batch_ragged(payloads)
    refused = sorted(node._store_refused)
    assert len(refused) == (1 if times == 1 else 3)
    for (h, _i, _j), d, w in zip(payloads, got, want):
        assert d == (None if h in refused else w)
    assert all(h not in node._eds_cache for h in refused)
    assert metrics.get_counter("sdc_detected_total", site="store.read") - sdc == len(refused)
    with jax_faults.inject(jax_faults.rule("store.read", "bitflip", times=times), seed=5):
        if times == 1:
            assert jnode.sample_batch_ragged(payloads) == want
        else:
            with pytest.raises(JaxIntegrityError):
                jnode.sample_batch_ragged(payloads)
    # persisting the height again lifts the refusal
    h = refused[0]
    k = dict(STORE_KS)[h]
    node._persist_block_eds(h, port_square(k, h))
    assert h not in node._store_refused
    node._eds_cache.invalidate(h)
    still = set(refused) - {h}
    assert node.sample_batch_ragged(payloads) == [
        None if hh in still else w for (hh, _i, _j), w in zip(payloads, want)]


def test_sample_batch_refuses_a_rotten_store_copy(tmp_path):
    persisted_pair(tmp_path, heights=STORE_KS[:1])
    node, _ = restarted(tmp_path, "port")
    e = node.store.entry(1)
    with open(e.path, "r+b") as f:
        f.seek(e.page_offset(0) + 20)
        f.write(b"\x00\x00\x00")
    assert node.sample_batch(1, [(0, 0), (3, 3)]) == [None, None]
    assert node._store_refused == {1} and node.block_eds(1) is None


def test_failed_store_load_answers_none_like_jax(tmp_path):
    persisted_pair(tmp_path, heights=STORE_KS[:2])
    node, jnode = restarted(tmp_path, "port")[0], restarted(tmp_path, "jax")[1]
    for which in ("port", "jax"):  # the file vanishes after the re-index
        (tmp_path / which / "store" / "2.ctps").unlink()
    assert node.block_eds(2) is None and jnode.block_eds(2) is None
    assert node.sample_batch(2, [(0, 0)]) == jnode.sample_batch(2, [(0, 0)]) == [None]
    assert node.sample_batch(1, [(0, 0)]) == jnode.sample_batch(1, [(0, 0)])


def test_restart_mixes_page_geometries_like_jax(tmp_path):
    """Heights stored with 2-row pages keep them in a restarted node's
    8-row cache; a crowd over them and a height put after the restart spans
    both geometries."""
    persisted_pair(tmp_path, heights=STORE_KS[:2], rows_per_page=2)
    node, jnode = restarted(tmp_path, "port")[0], restarted(tmp_path, "jax")[1]
    node._eds_cache.put(3, port_square(16, 3))
    jnode._eds_cache.put(3, jax_square(16, 3))
    payloads = payloads_for({1: 4, 2: 16, 3: 32})
    got = node.sample_batch_ragged(payloads)
    assert got == jnode.sample_batch_ragged(payloads)
    assert node._eds_cache.get(1).rows_per_page == 2 and node._eds_cache.get(3).rows_per_page == 8
    assert sum(isinstance(d, dict) for d in got) == 15


def test_store_needs_a_home(tmp_path):
    node = Node(device="cpu")
    assert node.home is None and node.store is None and node._eds_cache.store is None
    node._persist_block_eds(1, port_square(2, 1))  # nothing to persist to
    blocked = tmp_path / "file"
    blocked.write_bytes(b"not a directory")
    ours = Node(device="cpu", home=blocked)  # the store cannot be opened
    theirs = jax_node.Node(_App(), home=None)
    assert ours.store is None and theirs.store is None
