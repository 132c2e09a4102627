"""Wire-contract protos, copied from ``seldon_core_tpu/proto/``: the
``.proto`` files differ from the JAX package's only in comments, and the
generated ``*_pb2`` modules are the same files, so their serialized
descriptors are byte for byte the JAX package's (both packages add
``prediction.proto``, package ``seldon.tpu``, to protobuf's default pool,
which accepts an identical file twice and refuses a different one). Do
not regenerate them or rename their package.

Importing a ``*_pb2`` module needs ``google.protobuf``: the port imports
them only inside the functions that serve or call gRPC."""

from pathlib import Path

PROTO_DIR = Path(__file__).resolve().parent
