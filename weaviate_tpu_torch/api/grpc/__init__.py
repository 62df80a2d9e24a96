"""gRPC v1 API (reference: adapters/handlers/grpc/ + grpc/proto/v1).

Wire-compatible with reference v1 clients: same package, messages, field
numbers (see v1.proto). The servicer is hand-wired through
``grpc.method_handlers_generic_handler`` instead of grpc_tools-generated
stubs (grpc_tools is not in this environment; the generated wiring is the
same four unary-unary handlers).
"""

from weaviate_tpu_torch.api.grpc.server import GrpcServer

__all__ = ["GrpcServer"]
