"""celestia_tpu_torch — the PyTorch/CUDA port of celestia_tpu for NVIDIA Hopper.

The block-extension hot path of the JAX package, on an H100:

    k×k share square -> Leopard RS extension over GF(2^8) -> 2k×2k EDS
      -> NMT leaf digest of every cell -> 2k row roots + 2k column roots
      -> DataAvailabilityHeader hash

and EDS repair: an EDS with erased shares -> planned Leopard decode sweeps
on the card -> the repaired EDS, its roots checked against the DAH.

Layout (module names follow the JAX package so each counterpart is easy to
find; nothing here imports jax or celestia_tpu):

- ``device``             — device resolution (``None`` means CUDA; the CPU only on request)
- ``appconsts``          — the protocol constants the slice needs
- ``namespace``          — 29-byte versioned namespaces
- ``ops.gf256``          — GF(2^8) tables, the Leopard encode and erasure decode (host numpy)
- ``ops.rs``             — RS encode as a GF(2) bit-matrix product (plain torch)
- ``ops.sha256``         — SHA-256 byte/word layout helpers and ``sha256_fixed``
- ``ops.sha256_cuda``    — batched SHA-256 kernel (K3) and its plain version
- ``ops.rs_cuda``        — fused encode+leaf-hash (K1), leaf-hash (K2) and
  encode (K4) kernels; ``extend_square``, the unfused dense extend
- ``ops.xor_schedule``   — the XOR-schedule compiler (host numpy) and its plain
  evaluators
- ``ops.xor_cuda``       — XOR-schedule encode+leaf-hash (K5) and encode (K6)
  kernels; ``extend_square_xor``, the unfused XOR extend
- ``ops.nmt_cuda``       — the NMT tree kernel (leaf-digest grid -> row and column
  roots and the row levels, one launch) and its plain level loop
- ``ops.merkle_cuda``    — the DAH merkle kernel (K3's merkle form: B DAHs' hashes
  from their axis roots, one launch) and its plain level loop
- ``ops.nmt_host``       — hashlib NMT / RFC-6962 merkle (host oracle, DAH hash)
- ``ops.transfers``      — chunked pinned H2D staging, chunked D2H, sliced reads of a
  device-resident square, with byte counters, spans and CRC-32C sink checks
- ``ops.extend``         — the main path: square -> EDS -> roots -> DAH, on
  four routes (fused/unfused × dense/XOR) picked per k; the roots-only core
  and the batched roots of the replay verifier
- ``ops.repair_cuda``    — the decode sweep kernel (one planned Leopard decode sweep, in
  place in the EDS) and its plain version
- ``ops.repair``         — EDS repair on the card: the sweep plan, the resident repair
  verified against the DAH roots, ``repair_device``
- ``app.calibration``    — the port's measured routing tables: the App's gpu/native
  crossover and the dense/XOR table
- ``da``                 — ExtendedDataSquare (with sliced reads) and
  DataAvailabilityHeader; ``da.repair``, the host repair and ``repair_eds``
- ``telemetry``          — counters and histogram timers
- ``faults``             — seeded fault injection at the device boundaries
- ``tracing``            — spans, the flight recorder, stage sinks, fenced profiling
- ``integrity``          — CRC-32C, the GF(256) syndrome through K4, the audit engine
- ``bech32``, ``crypto`` — addresses, secp256k1 keys and signatures on Python integers
  (RFC 6979 nonces, a pure-Python RIPEMD-160; no ``cryptography`` wheel)
- ``smt``, ``state``, ``tx`` — the app hash's sparse Merkle tree, the branching state
  store, the tx wire format and the message registry
- ``app.context``, ``app.errors``, ``app.ante`` and ``x.*`` — the ante chain and the
  keepers, IBC (light client, connections, channels, transfer, tokenfilter) and
  Blobstream included (host Python, copies of the JAX package's); ``crypto.keccak``
- ``app.app``            — the App: CheckTx, Prepare/ProcessProposal, block execution,
  ExtendBlock, on the ``gpu``, ``native`` or ``numpy`` backend, with the strikes,
  sticky degrade and SDC quarantine; ``app.proposal``, its blob-arena DAH
- ``da.fraud``           — bad-encoding fraud proofs (the quarantine's evidence oracle)
- ``native``             — the native C++ runtime (``csrc/host/``, g++ at first use)

The CUDA kernels live in ``csrc/`` and are built with nvcc at first use
(``ops._cuda``).
"""

__version__ = "0.1.0"
