"""Protocol servers of the port (``nornicdb_tpu/server``): Bolt (Neo4j
drivers) and HTTP (the Neo4j transaction API, search, auth, admin,
metrics, MCP, the console, GraphQL in ``graphql`` and the Qdrant REST
API in ``qdrant``), and the PackStream codec.

Not ported yet: the Qdrant gRPC services and native gRPC search (ROADMAP
A6b-2), the device broker, the shared-memory read plane and the prefork
workers (A6d). ``broker``, ``shm`` and ``grpc_search`` hold only the
metric families those modules declare, so ``/metrics`` renders the JAX
package's catalog.
"""

from nornicdb_tpu_torch.server.bolt import BoltServer
from nornicdb_tpu_torch.server.http import HttpServer
from nornicdb_tpu_torch.server.packstream import Structure, pack, to_wire, unpack

__all__ = ["BoltServer", "HttpServer", "Structure", "pack", "to_wire", "unpack"]
