"""Public API layer: REST (/v1), gRPC, GraphQL.

Reference: adapters/handlers/{rest,graphql,grpc}.
"""

from weaviate_tpu_torch.api.rest import RestServer

__all__ = ["RestServer"]
