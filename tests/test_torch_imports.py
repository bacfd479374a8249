"""The port stands alone: celestia_tpu_torch and chip_smoke.py import
neither jax nor any module of celestia_tpu nor the ``cryptography`` wheel
(the card's machine has none), and no entry runs on the CPU unless asked
to."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from celestia_tpu_torch import da, device, proof
from celestia_tpu_torch.app import calibration, proposal
from celestia_tpu_torch.app.app import App
from celestia_tpu_torch.da import repair as da_repair
from celestia_tpu_torch.node import Node, eds_cache
from celestia_tpu_torch.node.pipeline import BlockPipeline
from celestia_tpu_torch.ops import blob_pool, extend, ragged, repair, transfers
from celestia_tpu_torch.parallel import multihost
from celestia_tpu_torch.shares import tail_padding_share
from celestia_tpu_torch.shares.splitters import Range
from celestia_tpu_torch.service import CodecBackend
from celestia_tpu_torch.store import BlockStore
from celestia_tpu_torch import testutil

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "celestia_tpu_torch"
# the state machine's modules: keys and signatures, the state store, txs,
# the ante chain and the keepers
STATE_MACHINE = ("bech32", "crypto", "crypto.ripemd160", "smt", "state", "tx",
                 "app.context", "app.errors", "app.ante", "x", "x.auth", "x.bank", "x.blob",
                 "x.blob.types", "x.blob.keeper", "x.feegrant", "x.vesting", "x.authz",
                 "x.staking", "x.distribution", "x.slashing", "x.mint", "x.crisis",
                 "x.paramfilter", "x.gov", "x.upgrade")
# the IBC and Blobstream modules, the fraud proofs, the native runtime and
# the App
APP_STACK = ("crypto.keccak", "x.blobstream_abi", "x.blobstream", "x.lightclient",
             "x.connection", "x.ibc", "x.transfer", "x.tokenfilter", "da.fraud", "native",
             "app", "app.calibration", "app.app")
# the node's block path and what stands around it: consensus, export,
# config, the Signer and the test harnesses
NODE_STACK = ("node.consensus", "app.export", "config", "user", "testutil",
              "testutil.network", "testutil.malicious", "testutil.ibc")
# the device lane: the runtime ledger, the dispatcher, the block pipeline
# and the codec service
DEVICE_LANE = ("devledger", "node.dispatch", "node.pipeline", "service", "service.wire",
               "service.codec_service")
# multi-GPU: the mesh and the multi-process runtime (torch.distributed)
MULTI_GPU = ("parallel", "parallel.multihost")
# the network surface: the RPC server and its clients, gRPC, the prober, the
# SLO engine and the Blobstream verify flow
NETWORK = ("slo", "x.blobstream_client", "node.rpc", "node.client", "node.grpc_api",
           "node.prober")
# the chaos harness, the gateway, the process fleet, txsim, the recorder and
# the scenario engine
HARNESSES = ("testutil.chaosnet", "txsim", "node.gateway", "node.fleet", "tools",
             "tools.tsdb", "scenarios.spec", "scenarios.library", "scenarios.openload",
             "scenarios.verdict", "scenarios.world", "scenarios.fleet", "scenarios.engine",
             "scenarios", "scenarios.__main__")


def _forbidden(module: str) -> bool:
    """jax, jaxlib, celestia_tpu and cryptography with their submodules —
    not celestia_tpu_torch, whose name starts with the same letters."""
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "celestia_tpu", "cryptography")


def test_forbidden_matches_exact_package_names():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("celestia_tpu") and _forbidden("celestia_tpu.ops.rs_tpu")
    assert _forbidden("cryptography") and _forbidden("cryptography.hazmat.primitives")
    assert not _forbidden("celestia_tpu_torch")
    assert not _forbidden("celestia_tpu_torch.ops.extend")


def test_importing_every_module_loads_no_jax_and_no_celestia_tpu():
    script = (
        "import importlib, json, pkgutil, sys\n"
        "import celestia_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "celestia_tpu_torch.__path__, 'celestia_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'modules': names, 'loaded': sorted(sys.modules)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("ops.extend", "da", "telemetry", "faults", "tracing", "integrity",
                 "ops.transfers", "ops.repair", "ops.repair_cuda", "da.repair",
                 "ops.merkle_cuda", "ops.ragged", "ops.ragged_cuda", "proof", "node",
                 "node.node", "node.eds_cache", "appconsts", "blob", "shares",
                 "shares.info_byte", "shares.splitters", "shares.parse", "inclusion",
                 "inclusion.cache", "square", "ops.blob_pool", "ops.assemble",
                 "ops.assemble_cuda", "app.proposal", "log", "store", "store.powercut",
                 "cli", *STATE_MACHINE, *APP_STACK, *NODE_STACK, *DEVICE_LANE, *MULTI_GPU,
                 *NETWORK, *HARNESSES):
        assert f"celestia_tpu_torch.{name}" in doc["modules"]
    bad = [m for m in doc["loaded"] if _forbidden(m)]
    assert not bad, f"the port loaded {bad}"


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_no_source_file_imports_jax_or_celestia_tpu():
    build = PACKAGE / "_build"  # generated at run time, not source
    files = [p for p in sorted(PACKAGE.rglob("*.py")) if build not in p.parents]
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        bad = [n for n in _imports(path) if _forbidden(n)]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


SQUARE = np.zeros((1, 1, 512), np.uint8)
EDS = np.zeros((2, 2, 512), np.uint8)
PRESENT = np.array([[False, True], [True, True]])


def _resident_dah():
    """A node on the CPU serving a host square from a ResidentEdsCache:
    the square's roots go to its own device, None = CUDA."""
    node = Node(device="cpu")
    node._eds_cache = eds_cache.ResidentEdsCache()
    node._eds_cache.put(1, da.ExtendedDataSquare(EDS, 1))
    return node.block_dah(1)


def _gather_cuda_page():
    """gather_rows on a page on the CUDA device, which must exist."""
    page = torch.zeros((2, 2, 512), dtype=torch.uint8, device=device.resolve(None))
    return ragged.gather_rows([(page, 0, 2)])

ENTRIES = {
    "resolve": lambda: device.resolve(None),
    "roots_device": lambda: extend.roots_device(SQUARE),
    "extend_roots_device": lambda: extend.extend_roots_device(SQUARE),
    "extend_roots_device_resident": lambda: extend.extend_roots_device_resident(SQUARE),
    "extend_and_root_device": lambda: extend.extend_and_root_device(SQUARE),
    "eds_roots_device": lambda: extend.eds_roots_device(EDS),
    "eds_row_levels_device": lambda: extend.eds_row_levels_device(EDS),
    "batched_roots_device": lambda: extend.batched_roots_device([SQUARE, SQUARE]),
    "device_put_chunked": lambda: transfers.device_put_chunked(SQUARE, site="t"),
    "extend_shares": lambda: da.extend_shares(SQUARE.reshape(1, 512)),
    "min_data_availability_header": lambda: da.min_data_availability_header(),
    "repair_device": lambda: repair.repair_device(EDS, PRESENT),
    "stage_resident_repair": lambda: repair.stage_resident_repair(EDS, PRESENT),
    "repair_resident_verified": lambda: repair.repair_resident_verified(EDS, PRESENT),
    "da.repair.repair": lambda: da_repair.repair(EDS, PRESENT),
    "repair_eds": lambda: da_repair.repair_eds(da.ExtendedDataSquare(EDS, 1), PRESENT),
    "Node": lambda: Node(),
    # the device is resolved before the home is touched: no directory is made
    "Node(home=...)": lambda: Node(home=REPO / "_no_such_home"),
    "PagedEdsCache": lambda: eds_cache.PagedEdsCache(),
    "PagedEdsCache(store=...)": lambda: eds_cache.PagedEdsCache(store=BlockStore.__new__(BlockStore)),
    "ResidentEdsCache.block_dah": _resident_dah,
    "gather_rows": _gather_cuda_page,
    "DeviceBlobArena": lambda: blob_pool.DeviceBlobArena(8192),
    "assembled_proposal_dah": lambda: proposal.assembled_proposal_dah(
        blob_pool.DeviceBlobArena(8192, device="cpu"), [tail_padding_share()], None, 1),
    "new_share_inclusion_proof": lambda: proof.new_share_inclusion_proof(
        [tail_padding_share()], tail_padding_share().namespace(), Range(0, 1)),
    "new_tx_inclusion_proof": lambda: proof.new_tx_inclusion_proof([b"\x01" * 40], 0, 1),
    "App": lambda: App(),
    "Node(app)": lambda: Node(App()),
    # the App is made before the home is read: no directory is needed
    "Node.load": lambda: Node.load(REPO / "_no_such_home"),
    "Node.state_sync_from": lambda: Node.state_sync_from(
        {"height": 0, "chain_id": "c", "app_version": 1, "block_time": 0.0,
         "app_hash": "", "state": b'{"data": {}, "version": 0}'.hex()}),
    "testnode": lambda: testutil.testnode(),
    "App(extend_backend=...)": lambda: App(extend_backend="native"),
    "measure_crossover": lambda: calibration.measure_crossover((1,)),
    "measure_xor_crossover": lambda: calibration.measure_xor_crossover((1,)),
    "BlockPipeline": lambda: BlockPipeline(1),
    "CodecBackend": lambda: CodecBackend(),
    "multihost.initialize": lambda: multihost.initialize("127.0.0.1:1", 1, 0),
    "RpcChaosNode(paged_budget_bytes=...)": lambda: _chaos_node(paged_budget_bytes=1 << 20),
    "ScenarioWorld": lambda: _scenario_world(),
    "run_scenario": lambda: _scenarios().run_scenario(_scenarios().get("smoke")),
    "scenarios CLI": lambda: _scenarios_cli(["smoke"]),
}


def _chaos_node(**kw):
    from celestia_tpu_torch.testutil.chaosnet import RpcChaosNode

    return RpcChaosNode(heights=1, k=1, **kw)


def _scenarios():
    from celestia_tpu_torch import scenarios

    return scenarios


def _scenario_world():
    from celestia_tpu_torch.scenarios.world import ScenarioWorld

    return ScenarioWorld(_scenarios().get("smoke"), seed=1)


def _scenarios_cli(argv):
    from celestia_tpu_torch.scenarios.__main__ import main

    return main(argv)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entries_refuse_to_fall_back_to_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRIES[name]()


def test_resolve_gives_the_cpu_only_when_asked():
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_the_state_machine_signs_and_verifies_without_cryptography():
    """With the wheel made unimportable, the port's keys sign, verify and
    derive addresses, and a PFB tx passes validate_blob_tx and the ante."""
    script = (
        "import sys\n"
        "sys.modules['cryptography'] = None\n"
        "from celestia_tpu_torch import blob, namespace, state, tx\n"
        "from celestia_tpu_torch.app import ante, context\n"
        "from celestia_tpu_torch.crypto import PrivateKey, verify_signature\n"
        "from celestia_tpu_torch.x import auth, bank\n"
        "from celestia_tpu_torch.x.blob import types\n"
        "key = PrivateKey.from_secret(b'k')\n"
        "b = blob.new_blob(namespace.new_v0(b'no-crypto'), b'data' * 100, 0)\n"
        "msg = types.new_msg_pay_for_blobs(key.bech32_address(), b)\n"
        "t = tx.sign_tx(key, [msg], 'c', 0, 0, tx.Fee(amount=10**5, gas_limit=10**5))\n"
        "raw = blob.marshal_blob_tx(t.marshal(), [b])\n"
        "decoded = types.validate_blob_tx(blob.unmarshal_blob_tx(raw)[0])\n"
        "store = state.StateStore()\n"
        "auth.AccountKeeper(store).get_or_create(key.bech32_address())\n"
        "bank.BankKeeper(store).mint(key.bech32_address(), 10**6)\n"
        "ctx = context.Context(store.branch(), 'c', 2, 0.0, 1, context.ExecMode.CHECK)\n"
        "ante.AnteHandler()(ctx, decoded, len(t.marshal()))\n"
        "assert not verify_signature(key.public_key(), b'x', key.sign(b'y'))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'cryptography'))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "['cryptography']"


def test_the_store_cli_and_the_explorer_import_no_jax():
    """The operator's command and the powercut explorer stand alone too."""
    script = (
        "import json, sys\n"
        "import celestia_tpu_torch.cli, celestia_tpu_torch.store.powercut\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'celestia_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []



def test_the_network_surface_imports_without_grpc():
    """With grpc made unimportable, the node package, its RPC server and
    clients, the prober, the SLO engine, the gRPC module itself and the CLI
    import, and none loads grpc or the JAX package; only the gRPC server
    and client classes need it."""
    script = (
        "import json, sys\n"
        "sys.modules['grpc'] = None\n"
        "import celestia_tpu_torch.node, celestia_tpu_torch.node.rpc\n"
        "import celestia_tpu_torch.node.client, celestia_tpu_torch.node.prober\n"
        "import celestia_tpu_torch.node.grpc_api as g, celestia_tpu_torch.slo\n"
        "import celestia_tpu_torch.cli, celestia_tpu_torch.x.blobstream_client\n"
        "try:\n"
        "    g.GrpcClient('127.0.0.1:1')\n"
        "    refused = False\n"
        "except ImportError:\n"
        "    refused = True\n"
        "print(json.dumps([refused, sorted(m for m in sys.modules if m.split('.')[0] in "
        "('grpc', 'jax', 'jaxlib', 'celestia_tpu') and sys.modules[m] is not None)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]
