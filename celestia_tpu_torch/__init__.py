"""celestia_tpu_torch — the PyTorch/CUDA port of celestia_tpu for NVIDIA Hopper.

The block-extension hot path of the JAX package, on an H100:

    k×k share square -> Leopard RS extension over GF(2^8) -> 2k×2k EDS
      -> NMT leaf digest of every cell -> 2k row roots + 2k column roots
      -> DataAvailabilityHeader hash

Layout (module names follow the JAX package so each counterpart is easy to
find; nothing here imports jax or celestia_tpu):

- ``device``             — device resolution (``None`` means CUDA; the CPU only on request)
- ``appconsts``          — the protocol constants the slice needs
- ``namespace``          — 29-byte versioned namespaces
- ``ops.gf256``          — GF(2^8) tables and the Leopard encode (host numpy)
- ``ops.rs``             — RS encode as a GF(2) bit-matrix product (plain torch)
- ``ops.sha256``         — SHA-256 byte/word layout helpers and ``sha256_fixed``
- ``ops.sha256_cuda``    — batched SHA-256 kernel (K3) and its plain version
- ``ops.rs_cuda``        — fused encode+leaf-hash (K1) and leaf-hash (K2) kernels
- ``ops.nmt_host``       — hashlib NMT / RFC-6962 merkle (host oracle, DAH hash)
- ``ops.extend``         — the main path: square -> EDS -> roots -> DAH
- ``da``                 — ExtendedDataSquare and DataAvailabilityHeader

The CUDA kernels live in ``csrc/`` and are built with nvcc at first use
(``ops._cuda``).
"""

__version__ = "0.1.0"
