"""The port's command line (port of the JAX package's cli.py).

    python -m celestia_tpu_torch.cli [--home H] [--chain-id C] init
    python -m celestia_tpu_torch.cli [--home H] keys add|list|show [NAME]
    python -m celestia_tpu_torch.cli [--home H] export [--for-zero-height]
        [--output PATH] [--device D]
    python -m celestia_tpu_torch.cli [--home H] rollback [--device D]
    python -m celestia_tpu_torch.cli [--home H] compact [--keep-recent N]
    python -m celestia_tpu_torch.cli [--home H] store stat|verify|compact \\
        [--home H] [--byte-budget N] [--keep-recent R]
    python -m celestia_tpu_torch.cli [--home H] [--port P] start [--device D]
        [--block-time S] [--grpc-port G] [--extend-backend B]
        [--calibrate-crossover] [--log-level L] [--trace-out PATH]
        [--probe-interval S] [--audit-level A]
    python -m celestia_tpu_torch.cli [--home H] [--port P] tx pfb|send ...
    python -m celestia_tpu_torch.cli [--port P] query PATH
    python -m celestia_tpu_torch.cli [--port P] slo check
    python -m celestia_tpu_torch.cli [--port P] ops audit HEIGHT
    python -m celestia_tpu_torch.cli light --primary URL [--watchtowers URLS]
        [--from-height H] [--poll S] [--timeout S] [--once] [--sample N]
    python -m celestia_tpu_torch.cli [--home H] addrbook add|remove|list [PEER]
    python -m celestia_tpu_torch.cli [--home H] download-genesis --node URL [--force]

``--home`` (default ``$CELESTIA_HOME`` or ``~/.celestia-tpu``, the JAX
command's) names the node directory: ``keys.json``, ``genesis.json``,
``config/``, the snapshot (``meta.json``, ``state.json``), ``blocks/`` and
the block store under ``store/``. Each command writes the same files,
prints the same text and exits with the same codes as the JAX package's
command on the same directory. A command that builds a node (``start``,
``export``, ``rollback``) takes ``--device``, where its App runs: ``cuda``
(the default) or ``cpu``. ``start`` serves the node's RPC on
``127.0.0.1:--port`` (the commands that talk to a node dial the same port)
and produces a block every ``goal_block_time_seconds``; SIGINT drains the
server and saves the snapshot. The JAX command's compile cache has no
counterpart: the kernels' nvcc builds are cached under ``_build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

DEFAULT_HOME = os.environ.get("CELESTIA_HOME", str(pathlib.Path.home() / ".celestia-tpu"))


def _home(args) -> pathlib.Path:
    home = pathlib.Path(args.home)
    home.mkdir(parents=True, exist_ok=True)
    return home


def _load_keys(home: pathlib.Path) -> dict:
    path = home / "keys.json"
    return json.loads(path.read_text()) if path.exists() else {}


def _save_keys(home: pathlib.Path, keys: dict) -> None:
    (home / "keys.json").write_text(json.dumps(keys, indent=2))


def cmd_init(args) -> None:
    """Write the validator key, ``genesis.json`` (the key funded and bonded
    as the genesis validator) and the layered config files."""
    from celestia_tpu_torch.config import write_default_configs
    from celestia_tpu_torch.crypto import PrivateKey

    home = _home(args)
    keys = _load_keys(home)
    if "validator" not in keys:
        keys["validator"] = os.urandom(32).hex()
        _save_keys(home, keys)
    key = PrivateKey.from_secret(bytes.fromhex(keys["validator"]))
    chain_id = args.chain_id or "celestia-tpu-1"
    genesis = {
        "chain_id": chain_id,
        "genesis_time": time.time(),
        "accounts": {key.bech32_address(): 1_000_000_000_000},
        # the gentx flow: this node's key is a genesis validator with a
        # self-bond (genutil DeliverGenTxs analogue)
        "validators": {key.bech32_address(): 100_000_000_000},
    }
    (home / "genesis.json").write_text(json.dumps(genesis, indent=2))
    write_default_configs(home)
    print(f"initialized chain {chain_id} at {home}")
    print(f"validator address: {key.bech32_address()}")
    print(f"wrote {home}/config/config.toml and {home}/config/app.toml")


def _build_node(home: pathlib.Path, **app_kwargs):
    """The home's node: resumed from its snapshot (``Node.load``, with
    ``app_kwargs``, ``device`` among them, reaching the App before the
    replay), else built from ``genesis.json`` (an exported one through
    ``import_genesis``)."""
    from celestia_tpu_torch.app.app import App
    from celestia_tpu_torch.node import Node

    genesis = json.loads((home / "genesis.json").read_text())
    if (home / "meta.json").exists():
        return Node.load(str(home), **app_kwargs)
    if (home / "blocks").exists() and any((home / "blocks").glob("*.json")):
        raise RuntimeError(
            f"{home} has persisted blocks but no state snapshot "
            "(meta.json) — refusing to re-initialize from genesis over an "
            "existing chain. Restore meta.json/state.json or clear blocks/."
        )
    if "app_state" in genesis:
        from celestia_tpu_torch.app.export import import_genesis

        return Node(import_genesis(genesis, **app_kwargs), home=str(home))
    app = App(chain_id=genesis["chain_id"], **app_kwargs)
    app.init_chain(genesis["accounts"], genesis_time=genesis["genesis_time"],
                   genesis_validators=genesis.get("validators"))
    return Node(app, home=str(home))


def cmd_start(args) -> None:
    """Run the node: its RPC server (with the dispatcher), the prober under
    ``--probe-interval``, the gRPC server under ``grpc_enable`` or
    ``--grpc-port``, and a block every ``goal_block_time_seconds``, produced
    on the dispatcher's thread (the one owner of the device stream, as for
    ``POST /produce_block``) while the server answers."""
    from celestia_tpu_torch import log as log_mod
    from celestia_tpu_torch import tracing
    from celestia_tpu_torch.app.calibration import CrossoverTable, crossover_path
    from celestia_tpu_torch.config import load_config
    from celestia_tpu_torch.node.rpc import RpcServer

    log_mod.configure(args.log_level)
    # the flight recorder is live for the whole run (/debug/flight beside
    # /metrics); --trace-out also collects every span and writes Chrome
    # trace-event JSON at shutdown
    tracing.enable()
    recording = tracing.start_recording() if args.trace_out else None
    home = _home(args)
    flag_overrides = {}
    if args.block_time is not None:
        flag_overrides["consensus.goal_block_time_seconds"] = args.block_time
    if args.extend_backend is not None:
        flag_overrides["app.extend_backend"] = args.extend_backend
    cfg = load_config(home, flag_overrides)
    # the audit policy is installed before the node boots, so the replay's
    # extends are audited too
    if args.audit_level:
        from celestia_tpu_torch import integrity

        integrity.configure(args.audit_level)
    node = _build_node(home, extend_backend=cfg.app.extend_backend, device=args.device)
    node.app.min_gas_price = cfg.app.min_gas_price
    node.mempool.ttl_blocks = cfg.consensus.mempool.ttl_num_blocks
    node.mempool.max_tx_bytes = cfg.consensus.mempool.max_tx_bytes
    # the home's measured backend table overrides the committed one;
    # --calibrate-crossover (or the config) measures and persists a new one
    cal_path = crossover_path(home)
    table = CrossoverTable.load(cal_path)
    if table is not None:
        node.app.crossover = table
    if cfg.app.calibrate_crossover or args.calibrate_crossover:
        node.app.calibrate_crossover(persist_path=cal_path)
    live = node.app.resolve_extend_backend(node.app.gov_square_size_upper_bound())
    if live == "gpu":
        # the blob arena stages mempool blobs on the card at CheckTx, and
        # committed squares stay resident, so a sample moves one row
        node.app.enable_blob_pool()
        node.extend_blocks = True
    server = RpcServer(node, port=args.port)
    server.start()
    prober = None
    if args.probe_interval:
        from celestia_tpu_torch.node.prober import Prober

        prober = Prober(f"http://127.0.0.1:{server.port}", interval=args.probe_interval)
        node.prober = prober
        prober.start()
    grpc_server = None
    grpc_note = ""
    if cfg.app.grpc_enable or args.grpc_port is not None:
        from celestia_tpu_torch.node.grpc_api import NodeGrpcServer

        grpc_server = NodeGrpcServer(node, port=args.grpc_port or 0)
        grpc_server.start()
        grpc_note = f"grpc 127.0.0.1:{grpc_server.port} "
    print(f"node started: chain {node.app.chain_id} height {node.latest_height()} "
          f"rpc http://127.0.0.1:{server.port} {grpc_note}"
          f"min-gas-price {cfg.app.min_gas_price} "
          f"extend-backend {cfg.app.extend_backend} (live: {live}) "
          f"audit-level {getattr(node.app, 'audit_level', 'off')}", flush=True)
    # an initial snapshot, so a crash before the first interval never leaves
    # blocks without meta.json (which _build_node refuses to re-initialize)
    node.save_snapshot()
    snapshot_interval = cfg.app.state_sync.snapshot_interval  # 0: none
    try:
        while True:
            time.sleep(cfg.consensus.goal_block_time_seconds)
            block = server.dispatcher.run_device(node.produce_block, "produce_block")
            if snapshot_interval and block.height % snapshot_interval == 0:
                node.save_snapshot()
            print(f"height {block.height} txs {len(block.txs)} "
                  f"square {block.square_size} data {block.data_hash.hex()[:16]}", flush=True)
    except KeyboardInterrupt:
        if prober is not None:
            prober.stop()
        server.stop()
        if grpc_server is not None:
            grpc_server.stop()
        node.save_snapshot()
        if recording is not None:
            recording.stop()
            path = recording.write(args.trace_out)
            print(f"trace written: {path} ({len(recording.spans)} spans)")
        print("node stopped", flush=True)


def cmd_export(args) -> None:
    """ref: app/export.go via ``celestia-appd export``: print (or write) a
    genesis document a fresh node can start from."""
    from celestia_tpu_torch.app.export import export_app_state_and_validators

    home = _home(args)
    node = _build_node(home, device=args.device)
    genesis = export_app_state_and_validators(node.app, for_zero_height=args.for_zero_height)
    text = json.dumps(genesis, indent=2, sort_keys=True)
    if args.output:
        pathlib.Path(args.output).write_text(text)
        print(f"exported genesis (height {genesis['height']}) to {args.output}")
    else:
        print(text)


def cmd_rollback(args) -> None:
    """Roll the chain back one block (the CometBFT ``rollback`` analogue):
    delete the newest persisted block and replay from the last snapshot,
    which must be below it."""
    home = _home(args)
    blocks_dir = home / "blocks"
    heights = sorted(int(p.stem) for p in blocks_dir.glob("*.json")) \
        if blocks_dir.exists() else []
    if not heights:
        print("no persisted blocks to roll back", file=sys.stderr)
        sys.exit(1)
    latest = heights[-1]
    if not (home / "meta.json").exists():
        print("no state snapshot (meta.json); cannot roll back — restore "
              "meta.json/state.json or clear blocks/", file=sys.stderr)
        sys.exit(1)
    meta = json.loads((home / "meta.json").read_text())
    if meta["height"] >= latest:
        print(
            f"snapshot is at height {meta['height']} >= latest block "
            f"{latest}: cannot roll back past the last snapshot (no "
            "older snapshot retained)",
            file=sys.stderr,
        )
        sys.exit(1)
    (blocks_dir / f"{latest}.json").unlink()
    # prove the store still replays cleanly to the new head
    node = _build_node(home, device=args.device)
    node.save_snapshot()
    print(f"rolled back block {latest}; chain head is now "
          f"{node.app.height} (app hash "
          f"{node.app.store.app_hashes[node.app.store.version].hex()[:16]}…)")


def cmd_download_genesis(args) -> None:
    """Fetch a chain's genesis from a node's ``/genesis`` route and install
    it in the home (ref: cmd/celestia-appd/cmd/download-genesis.go)."""
    import urllib.request

    home = _home(args)
    with urllib.request.urlopen(args.node.rstrip("/") + "/genesis", timeout=15) as resp:
        genesis = json.loads(resp.read())
    if args.chain_id and genesis.get("chain_id") != args.chain_id:
        print(f"refusing: node serves chain {genesis.get('chain_id')!r}, "
              f"expected {args.chain_id!r}", file=sys.stderr)
        sys.exit(1)
    target = home / "genesis.json"
    if target.exists() and not args.force:
        print(f"{target} already exists (use --force to overwrite)", file=sys.stderr)
        sys.exit(1)
    target.write_text(json.dumps(genesis, indent=2, sort_keys=True))
    print(f"wrote genesis for chain {genesis.get('chain_id')} to {target}")


def cmd_addrbook(args) -> None:
    """Manage the peer address book ``addrbook.json`` (ref:
    cmd/celestia-appd/cmd/addrbook.go)."""
    home = _home(args)
    path = home / "addrbook.json"
    book = json.loads(path.read_text()) if path.exists() else {"peers": []}
    if args.book_cmd in ("add", "remove") and not args.peer:
        print(f"addrbook {args.book_cmd} needs a peer URL", file=sys.stderr)
        sys.exit(1)
    if args.book_cmd == "add":
        if args.peer in book["peers"]:
            print(f"{args.peer} already in addrbook")
        else:
            book["peers"].append(args.peer)
            path.write_text(json.dumps(book, indent=2))
            print(f"added {args.peer} ({len(book['peers'])} peers)")
    elif args.book_cmd == "remove":
        if args.peer not in book["peers"]:
            print(f"{args.peer} not in addrbook", file=sys.stderr)
            sys.exit(1)
        book["peers"].remove(args.peer)
        path.write_text(json.dumps(book, indent=2))
        print(f"removed {args.peer} ({len(book['peers'])} peers)")
    else:  # list
        for peer in book["peers"]:
            print(peer)


def cmd_compact(args) -> None:
    """Prune persisted blocks no longer needed for crash recovery: the
    replay starts at the last snapshot, so blocks below its height (less
    ``--keep-recent``) are removed."""
    home = _home(args)
    meta_path = home / "meta.json"
    if not meta_path.exists():
        print("no snapshot; refusing to prune (recovery would need "
              "every block)", file=sys.stderr)
        sys.exit(1)
    snapshot_height = json.loads(meta_path.read_text())["height"]
    floor = max(0, snapshot_height - args.keep_recent)
    removed = 0
    for path in sorted((home / "blocks").glob("*.json")):
        if int(path.stem) < floor:
            path.unlink()
            removed += 1
    print(f"pruned {removed} blocks below height {floor} "
          f"(snapshot at {snapshot_height}, keep-recent {args.keep_recent})")


def cmd_keys(args) -> None:
    from celestia_tpu_torch.crypto import PrivateKey

    home = _home(args)
    keys = _load_keys(home)
    if args.keys_cmd == "add":
        if args.name in keys:
            print(f"key {args.name} already exists", file=sys.stderr)
            sys.exit(1)
        keys[args.name] = os.urandom(32).hex()
        _save_keys(home, keys)
    if args.keys_cmd in ("add", "show"):
        key = PrivateKey.from_secret(bytes.fromhex(keys[args.name]))
        print(f"{args.name}: {key.bech32_address()}")
    elif args.keys_cmd == "list":
        for name, secret in keys.items():
            key = PrivateKey.from_secret(bytes.fromhex(secret))
            print(f"{name}: {key.bech32_address()}")


def _rpc(args, method, path, body=None):
    import urllib.request

    url = f"http://127.0.0.1:{args.port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def cmd_tx(args) -> None:
    """Submit through the Signer over the RPC client (nonce-race recovery
    and min-gas-price bumping included)."""
    from celestia_tpu_torch import blob as blob_pkg
    from celestia_tpu_torch import namespace as ns
    from celestia_tpu_torch.crypto import PrivateKey
    from celestia_tpu_torch.node.client import RpcClient
    from celestia_tpu_torch.node.node import tx_hash
    from celestia_tpu_torch.user import Signer
    from celestia_tpu_torch.x.bank import MsgSend

    home = _home(args)
    keys = _load_keys(home)
    key = PrivateKey.from_secret(bytes.fromhex(keys[args.from_key]))
    client = RpcClient(f"http://127.0.0.1:{args.port}")
    try:
        signer = Signer.setup_single(key, client)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        sys.exit(1)
    if args.chain_id is not None and args.chain_id != signer.chain_id:
        print(f"--chain-id {args.chain_id} disagrees with the node's chain {signer.chain_id}",
              file=sys.stderr)
        sys.exit(1)
    if args.tx_cmd == "pfb":
        data = pathlib.Path(args.file).read_bytes() if args.file else os.urandom(args.size)
        b = blob_pkg.new_blob(ns.new_v0(bytes.fromhex(args.namespace)), data, 0)
        res = signer.submit_pay_for_blob([b])
    else:  # send
        res = signer.submit_tx([MsgSend(key.bech32_address(), args.to, args.amount)])
    print(json.dumps({"code": res.code, "log": res.log, "hash": tx_hash(res.raw).hex()}))


def cmd_query(args) -> None:
    print(json.dumps(_rpc(args, "GET", args.path)))


def fetch(base: str, path: str) -> tuple[int, dict]:
    """GET ``base + path``: (status, JSON body). A 503 from /readyz carries
    a JSON body: that is a verdict, not an unreachable node."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, {"error": f"HTTP {e.code}"}


def cmd_slo(args) -> None:
    """``slo check``: one health, readiness and SLO verdict of a running
    node. Exit 0 fit, 1 not ready or an objective breaching, 2 unreachable."""
    base = f"http://127.0.0.1:{args.port}"
    try:
        _, health = fetch(base, "/healthz")
        ready_status, ready = fetch(base, "/readyz")
        _, debug = fetch(base, "/debug/slo")
    except (OSError, ValueError) as e:
        print(json.dumps({"error": f"node unreachable: {e}"}), file=sys.stderr)
        sys.exit(2)
    slo_ok = bool(debug.get("slo", {}).get("ok", False))
    verdict = {
        "healthy": bool(health.get("ok")),
        "ready": ready_status == 200,
        "checks": ready.get("checks", []),
        "slo_ok": slo_ok,
        "objectives": debug.get("slo", {}).get("objectives", []),
        "probe_last": debug.get("probe_last"),
    }
    print(json.dumps(verdict, indent=2))
    sys.exit(0 if (verdict["ready"] and slo_ok) else 1)


def cmd_ops(args) -> None:
    """``ops audit <height>``: fetch a committed block's extended square
    from a running node and re-verify every row and column against the
    erasure code on the host. Exit 0 clean, 1 on a mismatching parity cell,
    2 when the block is unavailable."""
    import numpy as np

    from celestia_tpu_torch import integrity

    try:
        doc = _rpc(args, "GET", f"/eds/{args.height}")
    except Exception as e:  # noqa: BLE001 — unreachable or missing: exit 2
        print(json.dumps({"error": f"cannot fetch eds: {e}"}), file=sys.stderr)
        sys.exit(2)
    w = int(doc["width"])
    eds = np.stack([np.frombuffer(bytes.fromhex(r), dtype=np.uint8).reshape(w, -1)
                    for r in doc["rows"]])
    mism = int(integrity.host_eds_mismatch(eds, w // 2))
    print(json.dumps({"height": args.height, "width": w, "mismatching_parity_cells": mism,
                      "ok": mism == 0}))
    sys.exit(0 if mism == 0 else 1)


def cmd_store(args) -> None:
    """``store stat|verify|compact``: inspect, deep-verify or garbage-collect
    the CRC32C-guarded block store under --home (specs/store.md). ``stat``
    re-indexes shallowly (header and size checks) and prints the index
    summary; ``verify`` also checks EVERY page record's CRC and exits 1
    when any file was quarantined (the offline bit-rot audit of a node's
    persisted chain). ``compact --byte-budget N [--keep-recent R]`` evicts
    whole cold heights (lowest first, the newest R kept) until the store
    fits N bytes, and exits 1 if it still does not; retained files are
    untouched, so their DAH bytes are the same before and after."""
    from celestia_tpu_torch.store import BlockStore

    home = _home(args)
    root = home / "store"
    if not root.is_dir():
        print(json.dumps({"error": f"no block store at {root}"}), file=sys.stderr)
        sys.exit(1)
    store = BlockStore(root)
    report = store.reindex(deep=(args.store_cmd == "verify"))
    doc = dict(store.stats())
    doc["cmd"] = args.store_cmd
    doc["skipped_files"] = report["skipped"]
    if args.store_cmd == "compact":
        if args.byte_budget is None:
            print(json.dumps({"error": "compact requires --byte-budget"}), file=sys.stderr)
            sys.exit(2)
        doc["compaction"] = store.compact(args.byte_budget, keep_recent=args.keep_recent)
        doc.update(store.stats())
    print(json.dumps(doc, indent=2))
    if args.store_cmd == "verify" and report["skipped"]:
        sys.exit(1)
    if args.store_cmd == "compact" and doc["compaction"]["over_budget"]:
        sys.exit(1)


def cmd_light(args) -> None:
    """Fraud-aware light client: follow headers from a primary node, screen
    each against the watchtowers' fraud proofs, print one JSON line per
    decision. Exit 2 when a verified proof condemns a header, 3 when a
    sampled block is unavailable."""
    from celestia_tpu_torch.node.client import (
        FraudAwareLightClient,
        FraudDetected,
        RpcClient,
        Unavailable,
    )

    primary = RpcClient(args.primary)
    towers = [RpcClient(u.strip()) for u in args.watchtowers.split(",") if u.strip()]
    lc = FraudAwareLightClient(primary, towers)
    height = args.from_height
    # the idle timeout restarts at every accepted header
    idle_since = time.monotonic()
    polls = 0
    while True:
        try:
            hdr = lc.accept_header(height)
        except FraudDetected as e:
            print(json.dumps({"height": height, "accepted": False, "fraud": str(e)}))
            raise SystemExit(2)
        if hdr is None:
            if args.once:
                # an explicit record: silence would read as screened clean
                print(json.dumps({"height": height, "accepted": None,
                                  "reason": "not yet produced"}))
                return
            if args.timeout and time.monotonic() - idle_since > args.timeout:
                return
            time.sleep(args.poll)
            polls += 1
            # proofs that arrive after acceptance: a windowed pass each
            # poll, a full pass every 32
            try:
                lc.rescreen(window=None if polls % 32 == 0 else 64)
            except FraudDetected as e:
                print(json.dumps({"height": getattr(e, "height", None), "accepted": False,
                                  "fraud": str(e)}))
                raise SystemExit(2)
            if len(lc.headers) > 16384:
                for h in sorted(lc.headers)[:-8192]:
                    del lc.headers[h]
            continue
        record = {"height": height, "accepted": True, "data_hash": hdr["data_hash"]}
        if args.sample:
            try:
                record["das"] = lc.sample_availability(height, n=args.sample)
            except Unavailable as e:
                record.update(accepted=False, unavailable=str(e))
                print(json.dumps(record))
                raise SystemExit(3)
        print(json.dumps(record))
        idle_since = time.monotonic()
        height += 1
        if args.once:
            return


def _nonneg(v) -> int:
    n = int(v)
    if n < 0:
        raise argparse.ArgumentTypeError("--sample must be >= 0")
    return n


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="celestia-tpu-torch")
    parser.add_argument("--home", default=DEFAULT_HOME)
    parser.add_argument("--port", type=int, default=26657)
    # None = not passed: init falls back to the default chain id; tx checks
    # a passed value against the node's chain
    parser.add_argument("--chain-id", default=None)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def device_flag(p) -> None:
        p.add_argument("--device", default="cuda",
                       help="where the node's App runs: cuda (default) or cpu")

    sub.add_parser("init")
    p_start = sub.add_parser("start")
    # None = not passed, so config-file and env values are not masked
    p_start.add_argument("--block-time", type=float, default=None)
    p_start.add_argument("--grpc-port", type=int, default=None,
                         help="also serve the gRPC API on this port (0 = ephemeral; "
                              "default: only when app.toml grpc_enable)")
    p_start.add_argument("--extend-backend", default=None,
                         choices=["auto", "gpu", "native", "numpy"],
                         help="ExtendBlock backend (default: config app.extend_backend, "
                              "'auto')")
    p_start.add_argument("--calibrate-crossover", action="store_true",
                         help="measure the per-k gpu/native crossover now and persist it "
                              "to config/crossover.json")
    p_start.add_argument("--log-level", default="info",
                         choices=["debug", "info", "warning", "error"])
    p_start.add_argument("--trace-out", default=None, metavar="PATH",
                         help="write Chrome trace-event JSON of every span to PATH at "
                              "shutdown")
    p_start.add_argument("--probe-interval", type=float, default=None, metavar="SECONDS",
                         help="run the synthetic DAS prober against this node every "
                              "SECONDS (default: off)")
    p_start.add_argument("--audit-level", default=None, choices=["off", "sampled", "full"],
                         help="integrity audit of every device extend and repair")
    device_flag(p_start)
    p_export = sub.add_parser("export")
    p_export.add_argument("--for-zero-height", action="store_true")
    p_export.add_argument("--output", default=None)
    device_flag(p_export)
    p_keys = sub.add_parser("keys")
    p_keys.add_argument("keys_cmd", choices=["add", "list", "show"])
    p_keys.add_argument("name", nargs="?", default="validator")
    p_rollback = sub.add_parser("rollback")
    device_flag(p_rollback)
    p_compact = sub.add_parser("compact")
    p_compact.add_argument("--keep-recent", type=int, default=100,
                           help="blocks to retain below the snapshot height")

    p_store = sub.add_parser(
        "store", help="inspect (stat), CRC-audit (verify) or GC (compact) the "
        "on-disk block store under --home; verify exits 1 on any quarantined "
        "file, compact evicts cold heights to a byte budget")
    p_store.add_argument("store_cmd", choices=["stat", "verify", "compact"])
    # also accepted after the command; the top-level value stands otherwise
    p_store.add_argument("--home", default=argparse.SUPPRESS)
    p_store.add_argument("--byte-budget", type=int, default=None,
                         help="compact: target on-disk byte budget (required)")
    p_store.add_argument("--keep-recent", type=int, default=16,
                         help="compact: newest heights never evicted")

    p_tx = sub.add_parser("tx")
    tx_sub = p_tx.add_subparsers(dest="tx_cmd", required=True)
    p_pfb = tx_sub.add_parser("pfb")
    p_pfb.add_argument("--from", dest="from_key", default="validator")
    # ascii "testing123": all-zero-prefixed ids are primary-reserved
    p_pfb.add_argument("--namespace", default="74657374696e67313233",
                       help="up to 10 user bytes, hex")
    p_pfb.add_argument("--size", type=int, default=1000)
    p_pfb.add_argument("--file", default=None)
    p_send = tx_sub.add_parser("send")
    p_send.add_argument("--from", dest="from_key", default="validator")
    p_send.add_argument("to")
    p_send.add_argument("amount", type=int)

    p_query = sub.add_parser("query")
    p_query.add_argument("path")

    p_slo = sub.add_parser("slo", help="SLO/readiness checks against a running node")
    p_slo.add_argument("slo_cmd", choices=["check"])

    p_ops = sub.add_parser("ops", help="operator drills against a running node")
    ops_sub = p_ops.add_subparsers(dest="ops_cmd", required=True)
    p_audit = ops_sub.add_parser(
        "audit", help="host-recompute the erasure code over one committed block's extended "
        "square (exit 1 on any mismatch)")
    p_audit.add_argument("height", type=int)

    p_dl = sub.add_parser("download-genesis")
    p_dl.add_argument("--node", required=True, help="RPC base URL of a live node to fetch from")
    p_dl.add_argument("--force", action="store_true")

    p_book = sub.add_parser("addrbook")
    p_book.add_argument("book_cmd", choices=["add", "remove", "list"])
    p_book.add_argument("peer", nargs="?", default=None)

    p_light = sub.add_parser(
        "light", help="fraud-aware light client: follow headers from a primary node, reject "
        "on verified bad-encoding proofs")
    p_light.add_argument("--primary", required=True, help="full node RPC base URL to follow")
    p_light.add_argument("--watchtowers", default="",
                         help="comma-separated RPC URLs serving /fraud/befp")
    p_light.add_argument("--from-height", type=int, default=1)
    p_light.add_argument("--poll", type=float, default=1.0)
    p_light.add_argument("--timeout", type=float, default=0.0,
                         help="stop waiting for new headers after this many seconds "
                              "(0 = follow forever)")
    p_light.add_argument("--once", action="store_true",
                         help="screen exactly --from-height, then exit")
    p_light.add_argument("--sample", type=_nonneg, default=0, metavar="N",
                         help="also sample N random shares per header (exit 3 on an "
                              "unavailable block)")

    args = parser.parse_args(argv)
    {
        "init": cmd_init,
        "start": cmd_start,
        "export": cmd_export,
        "keys": cmd_keys,
        "tx": cmd_tx,
        "query": cmd_query,
        "slo": cmd_slo,
        "ops": cmd_ops,
        "download-genesis": cmd_download_genesis,
        "addrbook": cmd_addrbook,
        "rollback": cmd_rollback,
        "compact": cmd_compact,
        "store": cmd_store,
        "light": cmd_light,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
