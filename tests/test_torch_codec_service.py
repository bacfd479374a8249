"""The port's codec service (celestia_tpu_torch/service/) against the JAX
package's service/.

The port's wire codecs marshal byte for byte as the JAX package's (proto3
omission of zero scalars included) and parse each other's bytes. The host
backend (``CodecBackend(device="cpu")``) answers the four calls at every
power-of-two k from 1 to 16 as the JAX package's ``CodecBackend(use_tpu=
False)`` does, through the native runtime and through the plain host paths;
the card's spelling (``use_gpu`` on a CPU backend runs the device entries'
plain versions) gives the same bytes. A port server answers a JAX client
and a JAX server a port client over loopback grpc, a bad buffer is
INVALID_ARGUMENT, the degrade is narrowed to device faults, and importing
the package loads no grpc.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from celestia_tpu.service import codec_service as jax_codec
from celestia_tpu.service import wire as jax_wire
from celestia_tpu_torch import faults, integrity, native
from celestia_tpu_torch import namespace as ns
from celestia_tpu_torch.da.repair import UnrepairableError
from celestia_tpu_torch.service import codec_service, wire
from celestia_tpu_torch.telemetry import metrics

REPO = pathlib.Path(__file__).resolve().parents[1]
KS = (1, 2, 4, 8, 16)


def square(k: int, seed: int) -> np.ndarray:
    """A square with sorted v0 namespaces (the host roots check the push
    order)."""
    r = np.random.default_rng(seed)
    flat = r.integers(0, 256, size=(k * k, 512), dtype=np.uint8)
    subs = sorted(r.integers(0, 200, size=(k * k, 10), dtype=np.uint8).tolist())
    for i, sub in enumerate(subs):
        flat[i, :29] = np.frombuffer(ns.new_v0(bytes(sub)).bytes, np.uint8)
    return flat.reshape(k, k, 512)


def mask(k: int, seed: int) -> np.ndarray:
    """25% of the cells erased at random: always repairable (a pattern the
    sweeps cannot undo needs more than k erased cells in each of more than k
    rows and columns)."""
    r = np.random.default_rng(seed)
    w = 2 * k
    present = np.ones((w, w), dtype=bool)
    present.reshape(-1)[r.choice(w * w, size=(w * w) // 4, replace=False)] = False
    return present


# ---------------------------------------------------------------------- #
# wire


MESSAGES = [
    ("EncodeRequest", (4, 512, b"\x01\x02\x03")),
    ("EncodeRequest", (0, 0, b"")),
    ("EncodeRequest", (3, 2, b"\xff")),
    ("EncodeRequest", (0, 512, b"")),
    ("EdsRequest", (2, 512, b"\xaa" * 40)),
    ("EdsRequest", (0, 0, b"")),
    ("RepairRequest", (2, 512, b"\xaa" * 16, b"\x01\x00" * 8)),
    ("RepairRequest", (1, 0, b"", b"\x01")),
    ("EdsResponse", (b"e" * 300,)),
    ("EdsResponse", (b"",)),
    ("RootsResponse", ([b"r" * 90, b"s" * 90], [b"c" * 90], b"d" * 32)),
    ("RootsResponse", ([], [], b"")),
]


@pytest.mark.parametrize("name,args", MESSAGES, ids=[f"{m[0]}-{i}" for i, m in enumerate(MESSAGES)])
def test_wire_is_byte_equal_to_the_jax_wire(name, args):
    ours, theirs = getattr(wire, name)(*args), getattr(jax_wire, name)(*args)
    raw = ours.marshal()
    assert raw == theirs.marshal()
    assert getattr(wire, name).unmarshal(raw) == ours
    assert getattr(jax_wire, name).unmarshal(raw) == theirs
    if not any(args):
        assert raw == b""  # proto3: zero scalars and empty bytes are omitted


def test_wire_layout_is_protoc_s():
    assert wire.EncodeRequest(3, 2, b"\xff").marshal() == bytes(
        [0x08, 0x03, 0x10, 0x02, 0x1A, 0x01, 0xFF])


def test_the_proto_keeps_the_jax_package_and_service():
    """The copy differs only in its comments: one client for both servers."""
    ours = (REPO / "celestia_tpu_torch/service/tpu_codec.proto").read_text()
    theirs = (REPO / "celestia_tpu/service/tpu_codec.proto").read_text()

    def body(text):
        return [ln for ln in text.splitlines() if ln.strip() and not ln.startswith("//")]

    assert body(ours) == body(theirs)
    assert codec_service.SERVICE_NAME == jax_codec.SERVICE_NAME


# ---------------------------------------------------------------------- #
# the four calls


def calls(backend, k: int, seed: int):
    """The four calls' answers on one square."""
    sq = square(k, seed)
    eds = backend.encode(k, 512, sq.tobytes())
    present = mask(k, seed)
    erased = np.frombuffer(eds, np.uint8).reshape(2 * k, 2 * k, 512).copy()
    erased[~present] = 0
    return {
        "encode": eds,
        "extend_and_root": backend.extend_and_root(k, 512, sq.tobytes()),
        "roots": backend.roots(k, 512, eds),
        "repair": backend.repair(k, 512, erased.tobytes(), present.astype(np.uint8).tobytes()),
    }


@pytest.fixture(scope="module")
def jax_answers():
    backend = jax_codec.CodecBackend(use_tpu=False)
    return {k: calls(backend, k, 10 + k) for k in KS}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("host", ["native", "plain"])
def test_the_host_backend_answers_as_the_jax_host_backend(k, host, jax_answers, monkeypatch):
    if host == "native" and not native.available():
        pytest.skip("no g++ here: the native runtime cannot build")
    if host == "plain":
        monkeypatch.setattr(native, "available", lambda: False)
    backend = codec_service.CodecBackend(device="cpu")
    assert not backend.use_gpu
    got = calls(backend, k, 10 + k)
    assert got == jax_answers[k]
    assert got["repair"] == got["encode"]


@pytest.mark.parametrize("k", (1, 4))
def test_the_cards_spelling_answers_as_the_host(k, jax_answers):
    """``use_gpu`` on a CPU backend runs the card's entries (extend,
    roots-only core, repair_device) through their plain versions."""
    backend = codec_service.CodecBackend(device="cpu")
    backend.use_gpu = True
    assert calls(backend, k, 10 + k) == jax_answers[k]
    assert backend._gpu_strikes == 0


def test_encode_and_extend_want_512_byte_shares():
    backend = codec_service.CodecBackend(device="cpu")
    for call in (backend.encode, backend.extend_and_root):
        with pytest.raises(ValueError):
            call(2, 64, bytes(2 * 2 * 64))
        with pytest.raises(ValueError, match="expected 2048"):
            call(2, 512, bytes(100))


# ---------------------------------------------------------------------- #
# the narrowed degrade


def _backend_failing_with(monkeypatch, exc):
    from celestia_tpu_torch.ops import extend

    backend = codec_service.CodecBackend(device="cpu", gpu_strike_limit=2)
    backend.use_gpu = True

    def fail(*_a, **_k):
        raise exc

    monkeypatch.setattr(extend, "extend_roots_device", fail)
    return backend


@pytest.mark.parametrize("exc", [faults.DeviceUnavailable("gone"),
                                 integrity.IntegrityError("bad result")],
                         ids=["unavailable", "integrity"])
def test_device_faults_degrade_to_the_host_and_disable_after_the_limit(monkeypatch, exc, jax_answers):
    backend = _backend_failing_with(monkeypatch, exc)
    sq = square(2, 12)
    before = metrics.get_counter("codec_gpu_fallback_total", op="encode")
    disabled = metrics.get_counter("codec_gpu_disabled_total")
    assert backend.encode(2, 512, sq.tobytes()) == jax_answers[2]["encode"]
    assert backend._gpu_strikes == 1 and backend.use_gpu
    assert backend.encode(2, 512, sq.tobytes()) == jax_answers[2]["encode"]
    assert backend._gpu_strikes == 2 and not backend.use_gpu
    assert metrics.get_counter("codec_gpu_fallback_total", op="encode") == before + 2
    assert metrics.get_counter("codec_gpu_disabled_total") == disabled + 1


@pytest.mark.parametrize("exc", [ValueError("shape"), UnrepairableError("pattern"),
                                 RuntimeError("kernel bug"), KeyError("x")],
                         ids=["value", "unrepairable", "runtime", "key"])
def test_other_errors_propagate_without_a_strike(monkeypatch, exc):
    """Where the JAX backend serves any failure from the host, the port's
    lets everything but a device fault through."""
    backend = _backend_failing_with(monkeypatch, exc)
    with pytest.raises(type(exc)):
        backend.encode(2, 512, square(2, 1).tobytes())
    assert backend._gpu_strikes == 0 and backend.use_gpu


def test_the_jax_backend_degrades_on_any_error(monkeypatch):
    """The difference of record, on the JAX side: a RuntimeError from its
    device path is served from the host."""
    from celestia_tpu.ops import extend_tpu

    def fail(*_a, **_k):
        raise RuntimeError("kernel bug")

    monkeypatch.setattr(extend_tpu, "extend_roots_device", fail)
    backend = jax_codec.CodecBackend(use_tpu=True)
    sq = square(2, 3)
    assert backend.encode(2, 512, sq.tobytes()) == \
        jax_codec.CodecBackend(use_tpu=False).encode(2, 512, sq.tobytes())
    assert backend._tpu_strikes == 1


# ---------------------------------------------------------------------- #
# the method bodies and grpc


def test_call_in_process_gives_the_servers_bytes():
    backend = codec_service.CodecBackend(device="cpu")
    sq = square(4, 2)
    raw = wire.EncodeRequest(4, 512, sq.tobytes()).marshal()
    resp = wire.RootsResponse.unmarshal(
        codec_service.call_in_process(backend, "ExtendAndRoot", raw))
    assert (resp.row_roots, resp.col_roots, resp.dah_hash) == \
        jax_codec.CodecBackend(use_tpu=False).extend_and_root(4, 512, sq.tobytes())


@pytest.fixture(scope="module")
def servers():
    pytest.importorskip("grpc")
    ours = codec_service.CodecServer(device="cpu")
    theirs = jax_codec.CodecServer(use_tpu=False)
    ours.start()
    theirs.start()
    yield ours, theirs
    ours.stop()
    theirs.stop()


@pytest.mark.parametrize("pairing", ["jax client, port server", "port client, jax server"])
def test_cross_package_loopback(servers, pairing):
    ours, theirs = servers
    if pairing.startswith("jax"):
        client = jax_codec.CodecClient(f"127.0.0.1:{ours.port}")
    else:
        client = codec_service.CodecClient(f"127.0.0.1:{theirs.port}")
    try:
        k = 4
        sq = square(k, 5)
        eds = client.encode(sq)
        host = jax_codec.CodecBackend(use_tpu=False)
        assert eds.tobytes() == host.encode(k, 512, sq.tobytes())
        assert tuple(client.extend_and_root(sq)) == host.extend_and_root(k, 512, sq.tobytes())
        assert tuple(client.roots(eds)) == host.roots(k, 512, eds.tobytes())
        present = mask(k, 5)
        erased = eds.copy()
        erased[~present] = 0
        assert client.repair(erased, present).tobytes() == eds.tobytes()
    finally:
        client.close()


def test_a_bad_buffer_is_invalid_argument(servers):
    import grpc

    ours, _theirs = servers
    client = codec_service.CodecClient(f"127.0.0.1:{ours.port}", retries=0)
    try:
        with pytest.raises(grpc.RpcError) as err:
            client.extend_and_root(square(2, 1)[:, :1, :])
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        client.close()


def test_a_lost_backend_is_unavailable_and_retried(servers):
    import grpc

    ours, _theirs = servers
    client = codec_service.CodecClient(f"127.0.0.1:{ours.port}", retries=1, backoff_base=0.0)
    before = metrics.get_counter("codec_call_retry_total", method="Roots")
    try:
        eds = np.frombuffer(codec_service.CodecBackend(device="cpu").encode(
            2, 512, square(2, 4).tobytes()), np.uint8).reshape(4, 4, 512)
        with faults.inject(faults.rule("codec.backend", "unavailable", times=2), seed=1):
            with pytest.raises(grpc.RpcError) as err:
                client.roots(eds)
        assert err.value.code() == grpc.StatusCode.UNAVAILABLE
        assert metrics.get_counter("codec_call_retry_total", method="Roots") == before + 1
        with faults.inject(faults.rule("codec.backend", "unavailable", times=1), seed=1):
            assert client.roots(eds)[2] == codec_service.CodecBackend(device="cpu").roots(
                2, 512, eds.tobytes())[2]
    finally:
        client.close()


def test_importing_the_service_loads_no_grpc():
    script = (
        "import json, sys\n"
        "import celestia_tpu_torch.service\n"
        "from celestia_tpu_torch.service import CodecBackend, wire, codec_service\n"
        "CodecBackend(device='cpu')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'grpc')))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
