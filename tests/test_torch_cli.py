"""The port's CLI commands ``init``, ``keys``, ``export``, ``rollback`` and
``compact`` (``celestia_tpu_torch/cli.py``) against the JAX package's, on
the CPU.

Each command runs in-process on a port home and on a JAX home, with the
keys' randomness and the genesis clock fixed by monkeypatching; the
commands that build a node take ``--device cpu``. The printed text (with
the home's path made neutral), the exit codes and the files written are
equal: ``keys.json``, ``genesis.json``, the config files, the exported
genesis, and after a rollback the snapshot and the blocks.
"""

import itertools
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
