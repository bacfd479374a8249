"""The port's CLI commands (``celestia_tpu_torch/cli.py``) against the JAX
package's, on the CPU.

Each command runs in-process on a port home and on a JAX home, with the
keys' randomness and the genesis clock fixed by monkeypatching; the
commands that build a node take ``--device cpu``. The printed text (with
the home's path made neutral), the exit codes and the files written are
equal: ``keys.json``, ``genesis.json``, the config files, the exported
genesis, and after a rollback the snapshot and the blocks.

The commands that talk to a node (``query``, ``tx``, ``slo``, ``ops``,
``light``) run against each home's node behind its own package's server;
``addrbook`` and ``download-genesis`` (from a local ``file://`` source,
never the network) write the same files. ``start --device cpu`` runs as a
subprocess: it serves ``query`` and ``light``, produces blocks, and stops
on SIGINT with a graceful drain.
"""

import itertools
import pathlib
import json
import os
import time

import pytest

from celestia_tpu import cli as jcli
from celestia_tpu_torch import cli as pcli

GENESIS_TIME = 1_700_000_000.0


@pytest.fixture
def fixed(monkeypatch):
    """os.urandom and time.time made deterministic; the fixture is a reset,
    so each command of a pair sees the same bytes."""
    counter = itertools.count()

    def urandom(n: int) -> bytes:
        return bytes([next(counter) % 251 + 1]) * n

    def reset() -> None:
        nonlocal counter
        counter = itertools.count()

    monkeypatch.setattr(os, "urandom", urandom)
    monkeypatch.setattr(time, "time", lambda: GENESIS_TIME)
    return reset


def run_both(capsys, tmp_path, args, fixed=None, device: bool = False):
    """One command on the JAX home and the port home: (exit code, stdout,
    stderr) of each, the homes' paths replaced by HOME."""
    out = []
    for cli, name in ((jcli, "jax"), (pcli, "port")):
        if fixed is not None:
            fixed()
        home = tmp_path / name
        argv = ["--home", str(home), *args]
        if device and cli is pcli:
            argv += ["--device", "cpu"]
        code = 0
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code
        captured = capsys.readouterr()
        out.append((code, captured.out.replace(str(home), "HOME"),
                    captured.err.replace(str(home), "HOME")))
    assert out[0] == out[1], out
    return out[1]


def same_files(tmp_path, *names) -> None:
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), \
            name


def chain(tmp_path, snapshot_at: int = 1, heights: int = 3) -> None:
    """Blocks on each home through its own package's node: empty blocks at
    1, 2, 3 s, the snapshot after height ``snapshot_at``."""
    for cli, name, kw in ((jcli, "jax", {}), (pcli, "port", {"device": "cpu"})):
        node = cli._build_node(tmp_path / name, **kw)
        for h in range(1, heights + 1):
            node.produce_block(float(h))
            if h == snapshot_at:
                node.save_snapshot()


def test_init_and_keys_match_jax(tmp_path, capsys, fixed):
    code, out, _err = run_both(capsys, tmp_path, ["--chain-id", "cli-test", "init"], fixed)
    assert code == 0 and "initialized chain cli-test at HOME" in out
    same_files(tmp_path, "keys.json", "genesis.json", "config/config.toml", "config/app.toml")
    assert json.loads((tmp_path / "port" / "genesis.json").read_text())["genesis_time"] == \
        GENESIS_TIME
    run_both(capsys, tmp_path, ["keys", "add", "bob"], fixed)
    code, _out, err = run_both(capsys, tmp_path, ["keys", "add", "bob"], fixed)
    assert code == 1 and "already exists" in err
    code, out, _err = run_both(capsys, tmp_path, ["keys", "list"])
    assert code == 0 and out.startswith("validator: celestia1") and "\nbob: celestia1" in out
    run_both(capsys, tmp_path, ["keys", "show", "bob"])
    same_files(tmp_path, "keys.json")
    # a second init keeps the key
    run_both(capsys, tmp_path, ["init"], fixed)
    same_files(tmp_path, "keys.json", "genesis.json")


def test_export_matches_jax(tmp_path, capsys, fixed):
    run_both(capsys, tmp_path, ["init"], fixed)
    chain(tmp_path)
    code, out, _err = run_both(capsys, tmp_path, ["export"], device=True)
    assert code == 0 and json.loads(out)["height"] == 4
    # the zero-height export into a file named by --output: the same text
    # printed and the same document written
    texts = []
    for cli, name, extra in ((jcli, "jax", []), (pcli, "port", ["--device", "cpu"])):
        path = tmp_path / f"{name}-export.json"
        cli.main(["--home", str(tmp_path / name), "export", "--for-zero-height",
                  "--output", str(path), *extra])
        texts.append((capsys.readouterr().out.replace(str(path), "OUT"), path.read_bytes()))
    assert texts[0] == texts[1]
    assert texts[1][0] == "exported genesis (height 0) to OUT\n"
    assert json.loads(texts[1][1])["height"] == 0


def test_export_needs_the_card_unless_given_the_cpu(tmp_path, capsys, fixed):
    import torch

    pcli.main(["--home", str(tmp_path), "init"])
    capsys.readouterr()
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["--home", str(tmp_path), "export"])


def test_start_needs_the_card_unless_given_the_cpu(tmp_path, capsys, fixed):
    import logging

    import torch

    from celestia_tpu_torch import tracing

    pcli.main(["--home", str(tmp_path), "init"])
    capsys.readouterr()
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so the default is valid here")
    # start installs its log handler on this process's stderr: undone after
    tree = logging.getLogger("celestia_tpu_torch")
    saved = (list(tree.handlers), tree.level, tree.propagate)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcli.main(["--home", str(tmp_path), "--port", "0", "start", "--block-time", "0.1"])
    finally:
        tree.handlers[:], tree.level, tree.propagate = saved
        tracing.disable()


def test_rollback_matches_jax(tmp_path, capsys, fixed):
    run_both(capsys, tmp_path, ["init"], fixed)
    chain(tmp_path, snapshot_at=1, heights=3)
    code, out, _err = run_both(capsys, tmp_path, ["rollback"], device=True)
    assert code == 0 and out.startswith("rolled back block 3; chain head is now 2")
    same_files(tmp_path, "meta.json", "state.json", "blocks/1.json", "blocks/2.json")
    assert not (tmp_path / "port" / "blocks" / "3.json").exists()
    # the snapshot is now at the head: nothing more to roll back past it
    code, _out, err = run_both(capsys, tmp_path, ["rollback"], device=True)
    assert code == 1 and "cannot roll back past the last snapshot" in err


def test_rollback_refusals_match_jax(tmp_path, capsys, fixed):
    run_both(capsys, tmp_path, ["init"], fixed)
    code, _out, err = run_both(capsys, tmp_path, ["rollback"], device=True)
    assert code == 1 and "no persisted blocks" in err
    chain(tmp_path, snapshot_at=0, heights=2)  # blocks, no snapshot
    code, _out, err = run_both(capsys, tmp_path, ["rollback"], device=True)
    assert code == 1 and "no state snapshot" in err


def test_compact_matches_jax(tmp_path, capsys, fixed):
    run_both(capsys, tmp_path, ["init"], fixed)
    code, _out, err = run_both(capsys, tmp_path, ["compact"])
    assert code == 1 and "refusing to prune" in err
    chain(tmp_path, snapshot_at=4, heights=5)
    code, out, _err = run_both(capsys, tmp_path, ["compact", "--keep-recent", "1"])
    assert code == 0 and out.strip() == \
        "pruned 2 blocks below height 3 (snapshot at 4, keep-recent 1)"
    for name in ("jax", "port"):
        assert sorted(p.name for p in (tmp_path / name / "blocks").iterdir()) == \
            ["3.json", "4.json", "5.json"]
    # the compacted home still restarts by replay, to the same head
    jnode = jcli._build_node(tmp_path / "jax")
    pnode = pcli._build_node(tmp_path / "port", device="cpu")
    assert pnode.app.height == jnode.app.height == 5
    assert pnode.app.store.app_hashes[pnode.app.store.version] == \
        jnode.app.store.app_hashes[jnode.app.store.version]


def test_build_node_refuses_blocks_without_a_snapshot_like_jax(tmp_path, capsys, fixed):
    run_both(capsys, tmp_path, ["init"], fixed)
    chain(tmp_path, snapshot_at=0, heights=1)
    messages = []
    for cli, name, kw in ((jcli, "jax", {}), (pcli, "port", {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="refusing to re-initialize") as err:
            cli._build_node(tmp_path / name, **kw)
        messages.append(str(err.value).replace(str(tmp_path / name), "HOME"))
    assert messages[0] == messages[1]


def test_an_exported_genesis_starts_a_fresh_home_like_jax(tmp_path, capsys, fixed):
    run_both(capsys, tmp_path, ["init"], fixed)
    chain(tmp_path, snapshot_at=3, heights=3)
    _code, out, _err = run_both(capsys, tmp_path, ["export"], device=True)
    heads = []
    for cli, name, kw in ((jcli, "jax2", {}), (pcli, "port2", {"device": "cpu"})):
        home = tmp_path / name
        home.mkdir()
        (home / "genesis.json").write_text(out)
        node = cli._build_node(home, **kw)
        block = node.produce_block(10.0)
        heads.append((block.height, block.app_hash))
    assert heads[0] == heads[1] and heads[0][0] == 4


# ---- the commands that talk to a running node


@pytest.fixture
def served_homes(tmp_path, capsys, fixed):
    """Both homes initialised alike, each home's node (built by its own
    package's ``_build_node``) at height 2 behind its package's server:
    {package: port}."""
    from celestia_tpu.node.rpc import RpcServer as JServer
    from celestia_tpu_torch.node.rpc import RpcServer as PServer

    run_both(capsys, tmp_path, ["init"], fixed)
    servers = {}
    for cli, name, kw, server in ((jcli, "jax", {}, JServer),
                                  (pcli, "port", {"device": "cpu"}, PServer)):
        node = cli._build_node(tmp_path / name, **kw)
        node.produce_block(1.0)
        node.produce_block(2.0)
        servers[name] = server(node, port=0)
        servers[name].start()
    try:
        yield {name: srv.port for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.stop()


def run_served(capsys, tmp_path, ports, args, norm=lambda text: text):
    """One command against each home's server: (exit code, stdout, stderr)
    of each, normalised; the two must be equal."""
    out = []
    for cli, name in ((jcli, "jax"), (pcli, "port")):
        home = tmp_path / name
        code = 0
        try:
            cli.main(["--home", str(home), "--port", str(ports[name]), *args])
        except SystemExit as e:
            code = e.code
        captured = capsys.readouterr()
        out.append((code, norm(captured.out.replace(str(home), "HOME")
                               .replace(str(ports[name]), "PORT")),
                    norm(captured.err.replace(str(home), "HOME")
                         .replace(str(ports[name]), "PORT"))))
    assert out[0] == out[1], out
    return out[1]


def test_query_matches_jax(tmp_path, capsys, served_homes):
    for path in ("/header/2", "/block/1", "/dah/2", "/eds/2", "/sample/2/1/0",
                 "/params/blob", "/genesis"):
        code, out, _err = run_served(capsys, tmp_path, served_homes, ["query", path])
        assert code == 0 and json.loads(out)
    with pytest.raises(Exception):
        pcli.main(["--port", str(served_homes["port"]), "query", "/block/99"])


def test_tx_matches_jax(tmp_path, capsys, served_homes):
    """``tx send`` and ``tx pfb`` through the Signer over the RPC client:
    the same code and log (the hashes differ: JAX signs with a random
    nonce); a wrong ``--chain-id`` is refused alike."""
    blob = tmp_path / "blob.bin"
    blob.write_bytes(bytes(range(256)) * 7)

    def no_hash(text: str) -> str:
        return "\n".join(json.dumps({k: v for k, v in json.loads(line).items() if k != "hash"})
                         for line in text.splitlines())

    dest = json.loads((tmp_path / "port" / "genesis.json").read_text())["accounts"]
    to = next(iter(dest))
    for args in (["tx", "send", to, "1000"], ["tx", "pfb", "--file", str(blob)],
                 ["tx", "pfb", "--size", "300", "--namespace", "0102030405"]):
        code, out, _err = run_served(capsys, tmp_path, served_homes, args, no_hash)
        assert code == 0 and json.loads(out) == {"code": 0, "log": ""}
    code, _out, err = run_served(capsys, tmp_path, served_homes,
                                 ["--chain-id", "other", "tx", "send", to, "1"])
    assert code == 1 and "disagrees with the node's chain" in err


def test_slo_check_matches_jax(tmp_path, capsys, served_homes):
    def verdict(text: str) -> str:
        if not text:
            return text
        doc = json.loads(text)
        doc["objectives"] = [(o["name"].replace("tpu_", "gpu_"), o["ok"])
                             for o in doc["objectives"]]
        return json.dumps(doc)

    # the objectives read each package's process-wide registry, which the
    # worker's earlier tests wrote: both start from nothing
    from celestia_tpu.telemetry import metrics as jmetrics
    from celestia_tpu_torch.telemetry import metrics as pmetrics

    jmetrics.reset()
    pmetrics.reset()
    code, out, _err = run_served(capsys, tmp_path, served_homes, ["slo", "check"], verdict)
    doc = json.loads(out)
    assert code == 0 and doc["ready"] and doc["healthy"] and doc["slo_ok"]
    assert {c["name"] for c in doc["checks"]} >= {"has_blocks", "store_writable"}
    dead = {"jax": served_homes["jax"], "port": served_homes["port"]}
    for name in dead:
        with __import__("socket").socket() as s:
            s.bind(("127.0.0.1", 0))
            dead[name] = s.getsockname()[1]
    code, _out, err = run_served(capsys, tmp_path, dead, ["slo", "check"],
                                 lambda t: t.split(":")[0])
    assert code == 2 and err.startswith('{"error"')


def test_ops_audit_matches_jax(tmp_path, capsys, served_homes):
    code, out, _err = run_served(capsys, tmp_path, served_homes, ["ops", "audit", "2"])
    assert code == 0 and json.loads(out) == {"height": 2, "width": 2,
                                             "mismatching_parity_cells": 0, "ok": True}
    code, _out, err = run_served(capsys, tmp_path, served_homes, ["ops", "audit", "9"],
                                 lambda t: t.split(":")[0])
    assert code == 2 and err.startswith('{"error"')


def test_light_matches_jax(tmp_path, capsys, served_homes):
    urls = {name: f"http://127.0.0.1:{port}" for name, port in served_homes.items()}
    out = []
    for cli, name in ((jcli, "jax"), (pcli, "port")):
        runs = []
        for extra in (["--once", "--sample", "6"], ["--from-height", "2", "--once"],
                      ["--from-height", "7", "--once"],
                      ["--timeout", "0.01", "--poll", "0.001", "--from-height", "1"]):
            cli.main(["light", "--primary", urls[name], "--watchtowers", urls["jax"], *extra])
            runs.append(capsys.readouterr().out)
        out.append(runs)
    assert out[0] == out[1]
    first = json.loads(out[1][0])
    assert first["accepted"] and first["das"]["sampled"] == 6
    assert json.loads(out[1][2]) == {"height": 7, "accepted": None, "reason": "not yet produced"}
    assert [json.loads(line)["height"] for line in out[1][3].splitlines()] == [1, 2]


def test_addrbook_matches_jax(tmp_path, capsys):
    for args in (["addrbook", "list"], ["addrbook", "add", "http://a:1"],
                 ["addrbook", "add", "http://b:2"], ["addrbook", "add", "http://a:1"],
                 ["addrbook", "remove", "http://a:1"], ["addrbook", "remove", "http://zz:9"],
                 ["addrbook", "add"], ["addrbook", "list"]):
        run_both(capsys, tmp_path, args)
    same_files(tmp_path, "addrbook.json")
    assert json.loads((tmp_path / "port" / "addrbook.json").read_text()) == {
        "peers": ["http://b:2"]}


def test_download_genesis_from_a_local_file_matches_jax(tmp_path, capsys):
    """The source is any URL urllib opens: here a local ``file://`` tree
    whose ``genesis`` file a node would serve at ``/genesis``; the network
    is never touched."""
    src = tmp_path / "source"
    src.mkdir()
    (src / "genesis").write_text(json.dumps({"chain_id": "dl-1", "genesis_time": 5.0,
                                             "accounts": {}}))
    url = src.as_uri()
    code, out, _err = run_both(capsys, tmp_path, ["download-genesis", "--node", url])
    assert code == 0 and out == "wrote genesis for chain dl-1 to HOME/genesis.json\n"
    same_files(tmp_path, "genesis.json")
    code, _out, err = run_both(capsys, tmp_path, ["download-genesis", "--node", url])
    assert code == 1 and "already exists" in err
    code, _out, _err = run_both(capsys, tmp_path, ["download-genesis", "--node", url, "--force"])
    assert code == 0
    code, _out, err = run_both(capsys, tmp_path, ["--chain-id", "other", "download-genesis",
                                                  "--node", url, "--force"])
    assert code == 1 and "refusing: node serves chain 'dl-1'" in err


def test_start_serves_and_stops_on_sigint(tmp_path, capsys):
    """``start --device cpu`` as a subprocess: it serves its RPC (``query``
    and ``light`` answer), produces blocks, and on SIGINT drains the server,
    saves the snapshot, writes its trace and exits 0."""
    import re
    import signal
    import subprocess
    import sys
    import urllib.request

    from celestia_tpu_torch import tracing

    repo = pathlib.Path(__file__).resolve().parents[1]
    home = tmp_path / "node"
    pcli.main(["--home", str(home), "init"])
    capsys.readouterr()
    trace = tmp_path / "trace.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "celestia_tpu_torch.cli", "--home", str(home), "--port", "0",
         "start", "--device", "cpu", "--block-time", "0.2", "--probe-interval", "0.5",
         "--grpc-port", "0", "--trace-out", str(trace)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        m = re.search(r"rpc http://127\.0\.0\.1:(\d+) grpc 127\.0\.0\.1:(\d+)", first)
        assert m, (first, proc.stderr.read() if proc.poll() is not None else "")
        port = m.group(1)
        assert "extend-backend auto" in first and "audit-level off" in first
        heights = [proc.stdout.readline() for _ in range(2)]
        assert [h.split()[:2] for h in heights] == [["height", "1"], ["height", "2"]]
        pcli.main(["--port", port, "query", "/header/2"])
        assert json.loads(capsys.readouterr().out)["height"] == 2
        pcli.main(["light", "--primary", f"http://127.0.0.1:{port}", "--from-height", "2",
                   "--once", "--sample", "4"])
        assert json.loads(capsys.readouterr().out)["das"]["sampled"] == 4
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=30) as resp:
            assert resp.status == 200
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    assert out.rstrip().endswith("node stopped") and "trace written" in out
    assert (home / "meta.json").exists()
    assert json.loads((home / "meta.json").read_text())["height"] >= 2
    assert tracing.validate_chrome_trace(json.loads(trace.read_text())) == []
