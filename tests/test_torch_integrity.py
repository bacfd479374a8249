"""The port's faults, CRC-32C, GF(256) syndrome and audit engine, against
the JAX package's faults and integrity modules.

The JAX syndrome runs as its own tests run it on the CPU (``jax.jit`` on
XLA:CPU); the port's runs K4's plain version on CPU tensors. Both packages
get the same squares, indices, rules and seeds, and must give the same
counts, the same flipped bytes and the same ``IntegrityError.mismatches``.
"""

import functools

import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu import faults as jax_faults
from celestia_tpu import integrity as jax_integrity
from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch import da, faults, integrity
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import extend, rs_cuda
from celestia_tpu_torch.telemetry import metrics
from tests.test_torch_extend import square

SMALL_K = [1, 2, 4, 8, 16]
SEED = 1337


@pytest.fixture(autouse=True)
def _audits_off_after():
    """The audit policy is process-global in both packages."""
    yield
    integrity.configure("off")
    jax_integrity.configure("off")


def host_eds(k: int, seed: int = 3) -> np.ndarray:
    return np.asarray(jax_da.extend_shares(
        square(k, seed=seed).reshape(k * k, SHARE_SIZE)).data)


# RFC 3720, B.4: CRC-32C of 32 zeros, 32 0xff, 0..31, 31..0; and "123456789"
RFC3720 = [(bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
           (bytes(range(32)), 0x46DD794E), (bytes(range(31, -1, -1)), 0x113FDB5C),
           (b"123456789", 0xE3069283)]


@pytest.mark.parametrize("data,want", RFC3720)
def test_crc32c_rfc3720_vectors(data, want):
    assert integrity.crc32c(data) == want
    assert integrity._crc32c_bytewise(data) == want


@pytest.mark.parametrize("size", [0, 1, 511, 4095, 4096, 5000, 65543, 1 << 20])
def test_crc32c_matches_jax_package(size):
    buf = np.random.default_rng(size).integers(0, 256, size=size, dtype=np.uint8)
    assert integrity.crc32c(buf) == jax_integrity.crc32c(buf)
    assert integrity.crc32c(buf.tobytes()) == jax_integrity.crc32c(buf.tobytes())
    if size <= 5000:
        assert integrity._crc32c_vectorized(buf) == integrity._crc32c_bytewise(buf.tobytes())


def _flipped(eds: np.ndarray, flips: int, seed: int) -> np.ndarray:
    out = eds.copy()
    rng = np.random.default_rng(seed)
    flat = out.reshape(-1)
    for pos in rng.choice(flat.size, size=flips, replace=False):
        flat[pos] ^= np.uint8(1 << int(rng.integers(8)))
    return out


@pytest.mark.parametrize("flips", [0, 1, 2, 3])
@pytest.mark.parametrize("k", SMALL_K)
def test_syndrome_matches_jitted_syndrome(k, flips):
    eds = _flipped(host_eds(k), flips, seed=10 * k + flips)
    rng = np.random.default_rng(k + flips)
    for q in sorted({min(4, 2 * k), 2 * k}):
        ri = rng.choice(2 * k, size=q, replace=False).astype(np.int32)
        ci = rng.choice(2 * k, size=q, replace=False).astype(np.int32)
        want = int(jax_integrity._jitted_syndrome(k, q)(eds, ri, ci))
        got = integrity.syndrome(torch.from_numpy(eds), ri, ci)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == want
        plain = integrity.syndrome(torch.from_numpy(eds), ri, ci, rs_cuda.encode_into_reference)
        assert int(plain) == want
    if flips == 0:
        assert want == 0


@pytest.mark.parametrize("flips", [0, 1, 3])
@pytest.mark.parametrize("k", [2, 8])
def test_host_checks_match_jax_package(k, flips):
    eds = _flipped(host_eds(k), flips, seed=k)
    assert integrity.host_eds_mismatch(eds, k) == jax_integrity.host_eds_mismatch(eds, k)
    assert (integrity.host_recompute_mismatch(eds, k)
            == jax_integrity.host_recompute_mismatch(eds, k))
    clean = host_eds(k)
    assert np.array_equal(da.extend_host(clean[:k, :k]), clean)
    for level in ("sampled", "full"):
        ours = integrity.IntegrityEngine(level, q=2, seed=5)
        theirs = jax_integrity.IntegrityEngine(level, q=2, seed=5)
        for _ in range(3):
            assert ours.audit_host_eds(eds, k) == theirs.audit_host_eds(eds, k)
        assert ours.sample_chunks(7) == theirs.sample_chunks(7)


def test_engine_audits_device_eds_like_jax_package():
    k = 4
    eds = _flipped(host_eds(k), 2, seed=99)
    for level in ("sampled", "full"):
        ours = integrity.IntegrityEngine(level, q=3, seed=11)
        theirs = jax_integrity.IntegrityEngine(level, q=3, seed=11)
        for _ in range(4):
            assert (ours.audit_device_eds(torch.from_numpy(eds), k, where="t")
                    == theirs.audit_device_eds(eds, k, where="t"))
        assert ours.detections == theirs.detections and ours.audits == theirs.audits


def test_bitflipper_strikes_the_same_byte_in_both_packages():
    rule = ("device.extend.output", "bitflip")
    eds = host_eds(2)
    with faults.inject(faults.rule(*rule), seed=SEED):
        ours = faults.fire(rule[0])
    with jax_faults.inject(jax_faults.rule(*rule), seed=SEED):
        theirs = jax_faults.fire(rule[0])
    flipped = ours(torch.from_numpy(eds))
    assert isinstance(flipped, torch.Tensor)
    assert np.array_equal(flipped.numpy(), theirs(eds))
    assert np.array_equal(ours(eds), theirs(eds))
    assert ours(b"abc") == theirs(b"abc")
    assert np.count_nonzero(flipped.numpy() != eds) == 1
    assert not np.shares_memory(flipped.numpy(), eds)  # a copy, the input intact


def test_injector_schedules_match_jax_package():
    def run(mod):
        rules = [mod.rule("transfer.chunk", "bitflip", probability=0.5),
                 mod.rule("device.*", "corrupt", after=1, times=2)]
        out = []
        with mod.inject(*rules, seed=SEED) as inj:
            for i in range(12):
                site = "transfer.chunk" if i % 2 else "device.extend"
                fn = mod.fire(site, index=i)
                out.append(None if fn is None else fn(bytes(range(64))))
        return out, inj.schedule, inj.site_timeline

    assert run(faults) == run(jax_faults)


@pytest.mark.parametrize("level", ["sampled", "full"])
def test_extend_output_bitflip_drill_matches_jax_package(level):
    k = 4
    sq = square(k, seed=3)
    results = []
    for ext, flt, integ, kw in ((extend_tpu, jax_faults, jax_integrity, {}),
                                (extend, faults, integrity, {"device": "cpu"})):
        integ.configure(level, q=4, seed=7)
        with flt.inject(flt.rule("device.extend.output", "bitflip"), seed=SEED):
            try:
                ext.extend_roots_device(sq, **kw)
                results.append(None)
            except integ.IntegrityError as err:
                assert err.site == "device.extend.output" and err.k == k
                assert err.eds.shape == (2 * k, 2 * k, SHARE_SIZE)
                results.append((err.mismatches, err.eds.tobytes()))
    assert results[0] == results[1]
    assert results[1] is not None and results[1][0] > 0  # this seed's flip is caught


def test_extend_output_bitflip_resident_raises_and_counts():
    k = 4
    integrity.configure("full")
    before = metrics.get_counter("sdc_detected_total", site="device.extend.output")
    with faults.inject(faults.rule("device.extend.output", "bitflip"), seed=SEED):
        with pytest.raises(integrity.IntegrityError) as ei:
            extend.extend_roots_device_resident(square(k), device="cpu")
    assert integrity.host_eds_mismatch(ei.value.eds, k) > 0
    assert metrics.get_counter("sdc_detected_total", site="device.extend.output") == before + 1


def test_extend_output_bitflip_silent_with_audits_off():
    k = 4
    sq = square(k, seed=3)
    integrity.configure("off")
    jax_integrity.configure("off")
    with faults.inject(faults.rule("device.extend.output", "bitflip"), seed=SEED):
        ours = extend.extend_roots_device(sq, device="cpu")[0]
    with jax_faults.inject(jax_faults.rule("device.extend.output", "bitflip"), seed=SEED):
        theirs = extend_tpu.extend_roots_device(sq)[0]
    assert np.array_equal(ours, np.asarray(theirs))
    assert np.count_nonzero(ours != host_eds(k)) == 1


def test_clean_extend_passes_the_full_audit():
    integrity.configure("full")
    eds, _rows, _cols = extend.extend_roots_device(square(8), device="cpu")
    assert np.array_equal(eds, host_eds(8, seed=42))
    assert integrity.get().audits == 1 and integrity.get().detections == 0


def _damaged(k: int):
    """``tests/test_integrity.py``'s repair case: the EDS with two cells
    erased (and zeroed), and its mask."""
    eds = host_eds(k)
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[0, 0] = False
    present[1, 2] = False
    return eds, np.where(present[..., None], eds, 0).astype(np.uint8), present


@pytest.mark.parametrize("level", ["sampled", "full"])
def test_repair_output_bitflip_drill_matches_jax_package(level):
    from celestia_tpu.ops import repair_tpu
    from celestia_tpu_torch.ops import repair

    k = 4
    _eds, damaged, present = _damaged(k)
    results = []
    for call, flt, integ in (
            (lambda: repair_tpu.repair_tpu(damaged, present), jax_faults, jax_integrity),
            (lambda: repair.repair_device(damaged, present, device="cpu"), faults, integrity)):
        integ.configure(level, q=4, seed=7)
        with flt.inject(flt.rule("device.repair.output", "bitflip"), seed=SEED):
            try:
                call()
                results.append(None)
            except integ.IntegrityError as err:
                assert err.site == "device.repair.output" and err.where == "device.repair"
                results.append((err.mismatches, np.asarray(err.eds).tobytes()))
    assert results[0] == results[1]
    assert results[1] is not None and results[1][0] > 0  # this seed's flip is caught


def test_repair_output_bitflip_resident_raises_and_counts():
    from celestia_tpu_torch.ops import repair

    k = 4
    eds, damaged, present = _damaged(k)
    integrity.configure("full")
    before = metrics.get_counter("sdc_detected_total", site="device.repair.output")
    with faults.inject(faults.rule("device.repair.output", "bitflip"), seed=SEED):
        with pytest.raises(integrity.IntegrityError) as ei:
            repair.repair_resident_verified(torch.from_numpy(damaged), present, device="cpu")
    assert ei.value.site == "device.repair.output"
    assert np.count_nonzero(ei.value.eds != eds) == 1
    assert metrics.get_counter("sdc_detected_total", site="device.repair.output") == before + 1


def test_clean_repair_passes_the_full_audit():
    from celestia_tpu_torch.ops import repair

    k = 4
    eds, damaged, present = _damaged(k)
    integrity.configure("full")
    out = repair.repair_device(damaged, present, device="cpu")
    assert np.array_equal(out, eds)
    assert integrity.get().audits == 1 and integrity.get().detections == 0


def test_configure_levels():
    assert integrity.configure("off") is integrity.NOOP
    assert integrity.configure(None) is integrity.NOOP
    assert not integrity.NOOP.enabled and integrity.NOOP.sample_chunks(5) == frozenset()
    with pytest.raises(ValueError):
        integrity.configure("paranoid")
    eng = integrity.configure("sampled", q=2, seed=1)
    assert integrity.get() is eng and eng.enabled
    assert eng.sample_chunks(2) == frozenset({0, 1}) and len(eng.sample_chunks(9)) == 2


@functools.lru_cache(maxsize=None)
def _crc_case(size: int) -> tuple[bytes, int]:
    """A seeded buffer and its CRC-32C from the bytewise oracle."""
    buf = np.random.default_rng(size + 7).integers(0, 256, size=size, dtype=np.uint8).tobytes()
    return buf, integrity._crc32c_bytewise(buf)


@pytest.mark.parametrize("branch", ["google_crc32c", "numpy"])
@pytest.mark.parametrize("size", [0, 1, 4095, 4096, (1 << 20) + 3])
def test_crc32c_dispatch_matches_the_bytewise_oracle(monkeypatch, branch, size):
    """Both branches of the port's dispatch, as the JAX package's: the
    native module where importable, the numpy path when the module's handle
    is None. Each gives the bytewise oracle's value on bytes and arrays."""
    if branch == "numpy":
        monkeypatch.setattr(integrity, "_native_crc32c", None)
    else:
        monkeypatch.setattr(integrity, "_native_crc32c", pytest.importorskip("google_crc32c"))
    assert integrity.crc32c_implementation() == branch
    buf, want = _crc_case(size)
    assert integrity.crc32c(buf) == want
    assert integrity.crc32c(np.frombuffer(buf, np.uint8)) == want
    assert jax_integrity.crc32c(buf) == want


def test_crc32c_dispatch_picks_what_the_jax_package_picks():
    """With nothing installed for it, the port runs the native module
    exactly when the JAX package does."""
    assert (integrity._native_crc32c is None) == (jax_integrity._native_crc32c is None)
