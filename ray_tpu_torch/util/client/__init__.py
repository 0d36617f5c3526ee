# Copied from ray_tpu/util/client/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""``ray://`` client mode (reference: python/ray/util/client/ — gRPC proxy
driver described in python/ray/util/client/ARCHITECTURE.md: a thin client
ships pickled functions/args to a server that runs a real driver and holds
the object refs).

Here the transport is the framework's own length-prefixed RPC protocol
(_private/protocol.py) instead of gRPC: ``ClientServer`` embeds a real
driver, ``ClientContext`` (returned by ``ray_tpu_torch.init("ray://host:port")``)
proxies remote()/get()/put()/actors to it. Refs on the client are
``ClientObjectRef`` handles naming server-held refs; the server releases
them when the client connection drops.
"""

from ray_tpu_torch.util.client.client import ClientContext, ClientObjectRef, connect
from ray_tpu_torch.util.client.server import ClientServer, serve

__all__ = ["ClientContext", "ClientObjectRef", "connect", "ClientServer",
           "serve"]
