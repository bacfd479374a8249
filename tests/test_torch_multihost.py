"""The port's multi-process runtime (celestia_tpu_torch/parallel/multihost.py)
over torch.distributed, against the JAX package's host path.

Two OS processes form a gloo group over TCP on the loopback address, each
contributing 2 CPU shards: the global (dp = 2, sp = 2) mesh keeps each sp row
inside one process, and dp spans the processes. Each process extends its
slice of the batch on its own mesh, and ``gather_to_hosts`` gives every
process the DAHs of the whole batch in rank order, which must equal the JAX
package's ``celestia_tpu.da`` for every square. The workers import the port
alone. Then the runtime's refusals in this process: NCCL is never chosen
for CPU devices, and no device list means CUDA.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu_torch.parallel import multihost
from tests.test_torch_parallel import square

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
K = 8

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from celestia_tpu_torch.parallel import multihost

rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
multihost.initialize(f"127.0.0.1:{port}", world, rank, local_devices=["cpu", "cpu"])
mesh = multihost.process_mesh(sp=2)
try:
    multihost.process_mesh(sp=3)
    refused = False
except ValueError:
    refused = True
batch = np.load(path)
per = len(batch) // world
local = batch[rank * per:(rank + 1) * per]
fn = multihost.distributed_extend_and_root(mesh, local.shape[1])
eds, rows, cols, dah = fn(multihost.shard_batch_from_host(local, mesh))
dahs = multihost.gather_to_hosts(dah, mesh)
doc = {"rank": rank, "backend": dist.get_backend(), "mesh": mesh.shape,
       "process": [mesh.process_index, mesh.process_count], "refused": refused,
       "dahs": [d.tobytes().hex() for d in dahs],
       "foreign": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "celestia_tpu"))}
multihost.shutdown()
print("MULTIHOST " + json.dumps(doc), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_gather_the_jax_dahs(tmp_path):
    batch = np.stack([square(K, h) for h in range(1, WORLD + 1)])  # one square a dp row
    path = tmp_path / "batch.npy"
    np.save(path, batch)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(WORLD), port, str(path)],
                              cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = [jax_da.new_data_availability_header(jax_da.extend_shares(sq)).hash().hex()
            for sq in batch]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        doc = json.loads(next(line for line in out.splitlines()
                              if line.startswith("MULTIHOST "))[len("MULTIHOST "):])
        assert doc["rank"] == r and doc["backend"] == "gloo"
        assert doc["mesh"] == {"dp": 1, "sp": 2} and doc["process"] == [r, WORLD]
        assert doc["refused"] and doc["foreign"] == []
        assert doc["dahs"] == want


def test_initialize_never_picks_nccl_for_the_cpu_nor_gloo_for_a_card():
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        multihost.initialize("127.0.0.1:1", 1, 0, backend="nccl", local_devices=["cpu"])
    with pytest.raises(ValueError, match="one kind"):
        multihost.initialize("127.0.0.1:1", 1, 0, local_devices=["cpu", "meta"])
    with pytest.raises(RuntimeError, match="initialize first"):
        multihost.process_mesh(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.initialize("127.0.0.1:1", 1, 0)
