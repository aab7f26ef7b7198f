"""Protocol servers of the port (``nornicdb_tpu/server``): Bolt (Neo4j
drivers) and HTTP (the Neo4j transaction API, search, auth, admin,
metrics, MCP, the console, GraphQL in ``graphql`` and the Qdrant REST
API in ``qdrant``), the PackStream codec, the Qdrant gRPC services
(``qdrant_grpc``) and the native gRPC search (``grpc_search``) on the
port's own unary gRPC over HTTP/2 (``grpcwire``, in place of grpcio), and
the OAuth 2.0 test provider (``oauth_provider``).

Not ported yet: the device broker, the shared-memory read plane and the
prefork workers (ROADMAP A6d). ``broker`` and ``shm`` hold only the
metric families those modules declare, so ``/metrics`` renders the JAX
package's catalog.
"""

from nornicdb_tpu_torch.server.bolt import BoltServer
from nornicdb_tpu_torch.server.http import HttpServer
from nornicdb_tpu_torch.server.packstream import Structure, pack, to_wire, unpack

__all__ = ["BoltServer", "HttpServer", "Structure", "pack", "to_wire", "unpack"]
