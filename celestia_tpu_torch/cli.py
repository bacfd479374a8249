"""The port's command line (port of the JAX package's cli.py, its ``store``
command; the node's other commands come with the App).

    python -m celestia_tpu_torch.cli [--home H] store stat|verify|compact \\
        [--home H] [--byte-budget N] [--keep-recent R]

``--home`` (before or after the command; default ``$CELESTIA_HOME`` or
``~/.celestia-tpu``, the JAX command's) names the node directory whose
``store/`` holds the block store. The command prints the same JSON document
and exits with the same codes as the JAX package's ``store`` command on the
same directory.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

DEFAULT_HOME = os.environ.get("CELESTIA_HOME", str(pathlib.Path.home() / ".celestia-tpu"))


def _home(args) -> pathlib.Path:
    home = pathlib.Path(args.home)
    home.mkdir(parents=True, exist_ok=True)
    return home


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
    sub = parser.add_subparsers(dest="cmd", required=True)

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
    {"store": cmd_store}[args.cmd](args)


if __name__ == "__main__":
    main()
