"""The port's mesh routing against the JAX package's and its own
single-device route, byte for byte.

One case of each JAX mesh function (``celestia_tpu.parallel``), built on the
conftest's 8 virtual devices at the meshes and k the JAX package's own tests
compile (its persistent compile cache serves both), against the port's
spelling on a mesh of CPU shards. Then the routed entries under
``configure_mesh`` against the single-device route for every mesh of
``test_torch_parallel.py``, with their ``sharded`` span attribute; the
fallback of an sp that does not divide k, and of a call naming other
kernels or another device than the mesh's; ``configure_mesh`` and
``make_mesh``'s refusals; the device ledger's new build on a flip of the
mesh's shape; and the block pipeline on a mesh against the pipeline without
one and the JAX pipeline on its mesh.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from celestia_tpu import parallel as jax_parallel
from celestia_tpu.node import pipeline as jax_pipeline
from celestia_tpu_torch import devledger, parallel, tracing
from celestia_tpu_torch.node.pipeline import BlockPipeline
from celestia_tpu_torch.ops import extend
from celestia_tpu_torch.telemetry import metrics
from tests.test_torch_parallel import (
    CPU, MESHES, cpu_mesh, jax_host, same_as_references, same_levels, single, square,
)


@pytest.fixture(autouse=True)
def _no_mesh():
    """No mesh outlives a test, in either package."""
    parallel.configure_mesh(None)
    jax_parallel.configure_mesh(None)
    yield
    parallel.configure_mesh(None)
    jax_parallel.configure_mesh(None)


# ---------------------------------------------------------------------- #
# one case of each JAX mesh function (the meshes and k the JAX package's
# tests/test_parallel.py compiles)


def test_jax_extend_and_root_rowsharded_equals_the_port():
    k = 8
    sq = square(k)
    want = jax.block_until_ready(
        jax_parallel.extend_and_root_rowsharded(jax_parallel.make_mesh(dp=1, sp=8), k)(sq))
    got = parallel.extend_and_root_rowsharded(cpu_mesh(1, 8), k)(sq)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_jax_eds_row_levels_rowsharded_equals_the_port():
    k = 8
    eds = jax_host(k)[0]
    want = jax.block_until_ready(
        jax_parallel.eds_row_levels_rowsharded(jax_parallel.make_mesh(dp=1, sp=8), k)(eds))
    got = parallel.eds_row_levels_rowsharded(cpu_mesh(1, 8), k)(eds)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_jax_sharded_extend_and_root_equals_the_port():
    k = 8
    batch = np.stack([square(k, h) for h in (1, 2, 3, 4)])
    want = jax.block_until_ready(
        jax_parallel.sharded_extend_and_root(jax_parallel.make_mesh(dp=2, sp=2), k)(batch))
    got = parallel.sharded_extend_and_root(cpu_mesh(2, 2), k)(batch)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def stream(pipe, squares):
    out = [b for h, sq in enumerate(squares, 1) if (b := pipe.feed(h, sq)) is not None]
    return out + pipe.drain()


def test_pipeline_on_a_mesh_equals_the_pipeline_without_one_and_the_jax_mesh_pipeline():
    """Row C through the port's BlockPipeline on a (1, 2) mesh, against the
    port's pipeline without a mesh and the JAX pipeline on the (1, 8) mesh
    the JAX package's tests compile (its extend_root_levels_rowsharded)."""
    k = 8
    squares = [square(k, h) for h in range(1, 4)]
    plain = stream(BlockPipeline(k, device="cpu"), squares)
    parallel.configure_mesh(cpu_mesh(1, 2))
    before = metrics.get_counter("transfer_bytes", site="pipeline.h2d", direction="h2d")
    ours = stream(BlockPipeline(k, device="cpu"), squares)
    assert metrics.get_counter("transfer_bytes", site="pipeline.h2d", direction="h2d") == (
        before + sum(sq.nbytes for sq in squares))
    jax_parallel.configure_mesh(jax_parallel.make_mesh(dp=1, sp=8))
    theirs = stream(jax_pipeline.BlockPipeline(k), squares)
    assert len(ours) == len(plain) == len(theirs) == len(squares)
    for a, b, c in zip(ours, plain, theirs):
        assert a.height == b.height == c.height
        for name in ("eds", "row_roots", "col_roots", "dah"):
            got = getattr(a, name)
            assert np.array_equal(got, getattr(b, name))
            assert np.array_equal(got, np.asarray(getattr(c, name)))
        for x, y, z in zip(a.levels, b.levels, c.levels):
            assert np.array_equal(x, y) and np.array_equal(x, np.asarray(z))


def test_a_pipeline_on_another_device_than_the_mesh_refuses():
    parallel.configure_mesh(parallel.Mesh(parallel.device_array(["meta", "meta"], (1, 2))))
    with pytest.raises(ValueError, match="gathers onto"):
        BlockPipeline(8, device="cpu").feed(1, square(8))


# ---------------------------------------------------------------------- #
# the mesh routing of the entries


def _entries(sq, eds):
    """Every routed host entry's outputs, as numpy."""
    resident, rows, cols = extend.extend_roots_device_resident(sq, device="cpu")
    return {
        "roots_device": extend.roots_device(sq, device="cpu"),
        "extend_roots_device": extend.extend_roots_device(sq, device="cpu"),
        "extend_roots_device_resident": (resident.numpy(), rows, cols),
        "extend_and_root_device": extend.extend_and_root_device(sq, device="cpu"),
        "eds_row_levels_device": extend.eds_row_levels_device(eds, device="cpu"),
    }


@functools.lru_cache(maxsize=None)
def single_route(k: int):
    """The entries with no mesh configured."""
    return _entries(square(k), single(k)[0][0].numpy())


@pytest.mark.parametrize("dp,sp", MESHES)
def test_routed_entries_equal_the_single_device_route(dp, sp):
    k = 8
    want = single_route(k)
    parallel.configure_mesh(cpu_mesh(dp, sp))
    assert extend._mesh_if_divisible(k) is not None
    tracing.enable()
    try:
        with tracing.record() as rec:
            got = _entries(square(k), single(k)[0][0].numpy())
    finally:
        tracing.disable()
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for a, b in zip(got[name], want[name]):
            assert np.array_equal(a, b), name
    same_levels(k, got["eds_row_levels_device"])
    sharded = [sp_.attrs.get("sharded") for sp_ in rec.spans
               if sp_.name in ("extend.rs_nmt", "extend.nmt_levels")]
    assert len(sharded) == len(want) and all(sharded)


def test_the_staged_entries_route_the_mesh():
    """extend_and_root_staged and extend_root_levels_staged (Row C) on a
    mesh: the same bytes as without one, from a device tensor or from row
    shards staged on the mesh."""
    k = 8
    sq = square(k)
    (eds, rows, cols, dah), levels = single(k)
    mesh = cpu_mesh(1, 2)
    parallel.configure_mesh(mesh)
    for staged in (torch.from_numpy(sq), extend._stage_sharded(sq, mesh)):
        for a, b in zip(extend.extend_and_root_staged(staged), (eds, rows, cols, dah)):
            assert torch.equal(a, b)
        out = extend.extend_root_levels_staged(staged)
        for a, b in zip(out[:4], (eds, rows, cols, dah)):
            assert torch.equal(a, b)
        same_levels(k, out[4])


def test_a_k_the_mesh_does_not_divide_falls_back():
    k = 8
    sq = square(k)
    parallel.configure_mesh(cpu_mesh(1, 3))
    assert extend.active_mesh() is not None
    assert extend._mesh_if_divisible(k) is None
    tracing.enable()
    try:
        with tracing.record() as rec:
            out = extend.extend_and_root_device(sq, device="cpu")
    finally:
        tracing.disable()
    same_as_references(k, out)
    assert [sp_.attrs["sharded"] for sp_ in rec.spans if sp_.name == "extend.rs_nmt"] == [False]


def test_a_call_naming_other_kernels_or_another_device_takes_the_single_device_route():
    """The mesh runs the wrappers and gathers onto its first device: a call
    naming the plain versions, or another device, runs the single-device
    route with what it names (``sharded`` False, no row-sharded build), and
    the same bytes."""
    k = 8
    sq = square(k)
    want = single_route(k)
    (eds, rows, cols, dah), _levels = single(k)
    meta = parallel.Mesh(parallel.device_array(["meta", "meta"], (1, 2)))
    for mesh, kw in ((cpu_mesh(1, 2), {"device": "cpu", "kernels": extend.PLAIN}),
                     (meta, {"device": "cpu"})):
        parallel.configure_mesh(mesh)
        tracing.enable()
        try:
            with tracing.record() as rec:
                got = {
                    "roots_device": extend.roots_device(sq, **kw),
                    "extend_and_root_device": extend.extend_and_root_device(sq, **kw),
                    "eds_row_levels_device": extend.eds_row_levels_device(eds.numpy(), **kw),
                }
        finally:
            tracing.disable()
        for name, out in got.items():
            assert all(np.array_equal(a, b) for a, b in zip(out, want[name])), name
        assert [sp_.attrs["sharded"] for sp_ in rec.spans
                if sp_.name in ("extend.rs_nmt", "extend.nmt_levels")] == [False] * 3
        staged = extend.extend_root_levels_staged(torch.from_numpy(sq), kw.get("kernels",
                                                                               extend.KERNELS))
        for a, b in zip(staged[:4], (eds, rows, cols, dah)):
            assert torch.equal(a, b)
        same_levels(k, staged[4])
        for builder in (extend._rowsharded, extend._rowsharded_roots,
                        extend._rowsharded_levels, extend._rowsharded_full):
            assert builder.cache_info().currsize == 0


def test_row_shards_refuse_other_kernels_and_a_cleared_mesh():
    k = 8
    mesh = cpu_mesh(1, 2)
    parallel.configure_mesh(mesh)
    shards = extend._stage_sharded(square(k), mesh)
    with pytest.raises(ValueError, match="row shards"):
        extend.extend_and_root_staged(shards, extend.PLAIN)
    parallel.configure_mesh(None)
    with pytest.raises(ValueError, match="row shards"):
        extend.extend_root_levels_staged(shards)


def test_configure_mesh_refuses_a_mesh_without_sp():
    mesh = parallel.Mesh(parallel.device_array([CPU] * 8, (8,)), ("dp",))
    with pytest.raises(ValueError, match="'sp' axis"):
        parallel.configure_mesh(mesh)
    with pytest.raises(ValueError, match="'sp' axis"):
        jax_parallel.configure_mesh(jax.sharding.Mesh(np.asarray(jax.devices()), ("dp",)))


def test_make_mesh_needs_enough_devices():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {have + 1} devices, have {have}"):
        parallel.make_mesh(1, have + 1)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        jax_parallel.make_mesh(1, 9)
    mesh = parallel.make_mesh(2, 2, [CPU] * 5)
    assert mesh.shape == {"dp": 2, "sp": 2} and mesh.first == CPU


def test_a_flip_of_the_mesh_shape_is_a_new_build():
    """The row-sharded builders key the mesh's shape in (key_extra): the
    same k on another mesh shape is one more build under a new key, the
    same shape again none."""
    k = 8
    sq = square(k)
    entry = "extend.rowsharded_roots"

    def builds():
        return metrics.get_counter("device_build_total", entry=entry)

    parallel.configure_mesh(cpu_mesh(1, 2))
    extend.roots_device(sq, device="cpu")
    first = builds()
    extend.roots_device(sq, device="cpu")
    assert builds() == first  # cached
    parallel.configure_mesh(cpu_mesh(2, 2))
    extend.roots_device(sq, device="cpu")
    assert builds() == first + 1
    seen = devledger.ledger._seen[entry]
    assert {"(8)|(('dp', 1), ('sp', 2))", "(8)|(('dp', 2), ('sp', 2))"} <= seen


