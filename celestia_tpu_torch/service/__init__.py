"""The codec service boundary (port of the JAX package's service/): a gRPC
sidecar that serves the card's codec behind rsmt2d-Codec-shaped RPCs. See
tpu_codec.proto. Importing the package imports no grpc: only the server
and the client need it."""

from celestia_tpu_torch.service.codec_service import CodecBackend, CodecClient, CodecServer

__all__ = ["CodecBackend", "CodecClient", "CodecServer"]
