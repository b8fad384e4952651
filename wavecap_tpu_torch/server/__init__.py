"""HTTP/WebSocket service layer.

The port's copy of ``wavecap_tpu/server/__init__.py``, with the same public names.
"""

from .app import AppServer, AppState, build_router
from .httpd import HttpServer, Router, Request, Response, WebSocket, HttpError

__all__ = [n for n in dir() if not n.startswith("_")]
