"""The port's command line (port of the JAX package's cli.py: the commands
that need no RPC).

    python -m celestia_tpu_torch.cli [--home H] [--chain-id C] init
    python -m celestia_tpu_torch.cli [--home H] keys add|list|show [NAME]
    python -m celestia_tpu_torch.cli [--home H] export [--for-zero-height]
        [--output PATH] [--device D]
    python -m celestia_tpu_torch.cli [--home H] rollback [--device D]
    python -m celestia_tpu_torch.cli [--home H] compact [--keep-recent N]
    python -m celestia_tpu_torch.cli [--home H] store stat|verify|compact \\
        [--home H] [--byte-budget N] [--keep-recent R]

``--home`` (default ``$CELESTIA_HOME`` or ``~/.celestia-tpu``, the JAX
command's) names the node directory: ``keys.json``, ``genesis.json``,
``config/``, the snapshot (``meta.json``, ``state.json``), ``blocks/`` and
the block store under ``store/``. Each command writes the same files,
prints the same text and exits with the same codes as the JAX package's
command on the same directory. A command that builds a node (``export``,
``rollback``) takes ``--device``, where its App runs: ``cuda`` (the
default) or ``cpu``.
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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="celestia-tpu-torch")
    parser.add_argument("--home", default=DEFAULT_HOME)
    # None = not passed: init falls back to the default chain id
    parser.add_argument("--chain-id", default=None)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def device_flag(p) -> None:
        p.add_argument("--device", default="cuda",
                       help="where the node's App runs: cuda (default) or cpu")

    sub.add_parser("init")
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

    args = parser.parse_args(argv)
    {
        "init": cmd_init,
        "export": cmd_export,
        "keys": cmd_keys,
        "rollback": cmd_rollback,
        "compact": cmd_compact,
        "store": cmd_store,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
