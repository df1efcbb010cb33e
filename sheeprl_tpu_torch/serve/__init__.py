"""Policy serving: request batcher, in-process clients and the gateway."""

from sheeprl_tpu_torch.serve.batcher import RequestBatcher, ServeClosed, ServeRequestError
from sheeprl_tpu_torch.serve.client import LocalServeClient
from sheeprl_tpu_torch.serve.gateway import ServeGateway
from sheeprl_tpu_torch.serve.model import GatewayModel

__all__ = [
    "GatewayModel",
    "LocalServeClient",
    "RequestBatcher",
    "ServeClosed",
    "ServeGateway",
    "ServeRequestError",
]
