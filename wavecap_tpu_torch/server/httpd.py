"""Minimal asyncio HTTP/1.1 + WebSocket server (stdlib only).

The reference serves FastAPI+uvicorn (reference ``app.py:179``); that
stack isn't available here, so this module implements the small subset
needed for the same API surface: request parsing, path routing with
parameters, JSON bodies, chunked/streaming responses, and RFC 6455
WebSocket upgrade with text/binary frames, ping/pong and close.

The port's copy of ``wavecap_tpu/server/httpd.py``, with the same public names.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import re
import struct
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger(__name__)

WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_BODY = 10 * 1024 * 1024
MAX_HEADER_BYTES = 16 * 1024  # total request head (line + headers)
MAX_HEADERS = 100
# Slow-loris bounds: a request head must arrive within HEAD_TIMEOUT of the
# first byte; a body within BODY_TIMEOUT; an idle keep-alive connection is
# closed after IDLE_TIMEOUT (reference relies on uvicorn's h11 timeouts).
HEAD_TIMEOUT = 30.0
BODY_TIMEOUT = 60.0
IDLE_TIMEOUT = 120.0
MAX_CONNECTIONS = 512


class HttpError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(message)
        self.status = status
        self.message = message or {
            400: "bad request",
            401: "unauthorized",
            404: "not found",
            405: "method not allowed",
            409: "conflict",
            413: "body too large",
            414: "request line too long",
            422: "unprocessable",
            429: "too many requests",
            431: "headers too large",
            500: "internal error",
            503: "overloaded",
        }.get(status, "error")


@dataclass
class Request:
    method: str
    path: str
    query: dict
    headers: dict
    body: bytes
    params: dict = field(default_factory=dict)
    remote: str = ""  # client IP

    def json(self) -> Any:
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except ValueError:
            raise HttpError(400, "invalid JSON body")


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: dict = field(default_factory=dict)
    # async byte-chunk iterator -> Transfer-Encoding: chunked response
    # (reference serves .mp3/.opus/.aac audio via StreamingResponse,
    # reference api.py:2483-2650)
    stream: Any = None

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        return cls(status=status, body=json.dumps(obj).encode())

    @classmethod
    def text(cls, s: str, status: int = 200) -> "Response":
        return cls(status=status, body=s.encode(), content_type="text/plain")

    @classmethod
    def streaming(
        cls, gen: Any, content_type: str, headers: dict | None = None
    ) -> "Response":
        return cls(stream=gen, content_type=content_type, headers=headers or {})


class WebSocket:
    """Server-side WebSocket on asyncio streams.

    Backpressure contract: every stream handler pumps from its own
    bounded drop-oldest subscription queue, so a slow client can only
    stall its own pump coroutine inside ``drain()`` — never another
    subscriber.  ``send_timeout`` bounds even that: a consumer whose TCP
    buffer stays full for this long is evicted (socket closed,
    ``ConnectionError`` raised into its pump) instead of pinning the
    subscription/encoder forever.  The reference leans on uvicorn for
    the same guarantee.
    """

    #: seconds a send may wait on a full client TCP buffer before the
    #: connection is declared dead and evicted
    send_timeout: float = 15.0

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.closed = False
        self._send_lock = asyncio.Lock()

    async def send_text(self, s: str) -> None:
        await self._send_frame(0x1, s.encode())

    async def send_json(self, obj: Any) -> None:
        await self.send_text(json.dumps(obj))

    async def send_bytes(self, data: bytes) -> None:
        await self._send_frame(0x2, data)

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self.closed:
            raise ConnectionError("websocket closed")
        header = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header.append(n)
        elif n < 65536:
            header.append(126)
            header += struct.pack(">H", n)
        else:
            header.append(127)
            header += struct.pack(">Q", n)
        async with self._send_lock:
            self.writer.write(bytes(header) + payload)
            try:
                await asyncio.wait_for(self.writer.drain(), self.send_timeout)
            except (asyncio.TimeoutError, TimeoutError):
                # slow-consumer eviction: free the pump + subscription
                self.closed = True
                try:
                    self.writer.close()
                except RuntimeError:  # pragma: no cover
                    pass
                raise ConnectionError("websocket send timeout (slow consumer)")

    async def recv(self) -> tuple[str, bytes] | None:
        """Returns (kind, payload) with kind in text|binary, or None on close."""
        frags: list[bytes] = []
        frag_op = 0
        while True:
            try:
                hdr = await self.reader.readexactly(2)
            except (asyncio.IncompleteReadError, ConnectionError):
                self.closed = True
                return None
            fin = hdr[0] & 0x80
            opcode = hdr[0] & 0x0F
            masked = hdr[1] & 0x80
            n = hdr[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", await self.reader.readexactly(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", await self.reader.readexactly(8))[0]
            if n > MAX_BODY:
                await self.close(1009)
                return None
            mask = await self.reader.readexactly(4) if masked else b"\0\0\0\0"
            payload = bytearray(await self.reader.readexactly(n))
            if masked:
                for i in range(n):
                    payload[i] ^= mask[i % 4]
            if opcode == 0x8:  # close
                self.closed = True
                try:
                    await self._send_frame(0x8, bytes(payload[:2]))
                except ConnectionError:
                    pass
                return None
            if opcode == 0x9:  # ping
                await self._send_frame(0xA, bytes(payload))
                continue
            if opcode == 0xA:  # pong
                continue
            if opcode in (0x1, 0x2):
                frag_op = opcode
                if fin:
                    return ("text" if opcode == 0x1 else "binary", bytes(payload))
                frags = [bytes(payload)]
                continue
            if opcode == 0x0:  # continuation
                frags.append(bytes(payload))
                if fin:
                    data = b"".join(frags)
                    return ("text" if frag_op == 0x1 else "binary", data)

    async def close(self, code: int = 1000) -> None:
        if not self.closed:
            self.closed = True
            try:
                await self._send_frame(0x8, struct.pack(">H", code))
            except (ConnectionError, RuntimeError):
                pass
        try:
            self.writer.close()
        except RuntimeError:  # pragma: no cover
            pass


Handler = Callable[[Request], Awaitable[Response]]
WsHandler = Callable[[Request, WebSocket], Awaitable[None]]


class Router:
    def __init__(self):
        self.routes: list[tuple[str, re.Pattern, Handler]] = []
        self.ws_routes: list[tuple[re.Pattern, WsHandler]] = []

    @staticmethod
    def _compile(pattern: str) -> re.Pattern:
        # {name} matches one path segment; {name+} spans segments (static trees)
        regex = re.sub(r"\{(\w+)\+\}", r"(?P<\1>.+)", pattern)
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", regex)
        return re.compile("^" + regex + "$")

    def route(self, method: str, pattern: str):
        def deco(fn: Handler):
            self.routes.append((method.upper(), self._compile(pattern), fn))
            return fn

        return deco

    def get(self, p):
        return self.route("GET", p)

    def post(self, p):
        return self.route("POST", p)

    def put(self, p):
        return self.route("PUT", p)

    def patch(self, p):
        return self.route("PATCH", p)

    def delete(self, p):
        return self.route("DELETE", p)

    def websocket(self, pattern: str):
        def deco(fn: WsHandler):
            self.ws_routes.append((self._compile(pattern), fn))
            return fn

        return deco

    def find(self, method: str, path: str):
        allowed = False
        for m, rx, fn in self.routes:
            match = rx.match(path)
            if match:
                if m == method:
                    return fn, match.groupdict()
                allowed = True
        if allowed:
            raise HttpError(405)
        return None, {}

    def find_ws(self, path: str):
        for rx, fn in self.ws_routes:
            match = rx.match(path)
            if match:
                return fn, match.groupdict()
        return None, {}


class HttpServer:
    def __init__(self, router: Router, host: str = "0.0.0.0", port: int = 8087):
        self.router = router
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self.middleware: list[Callable[[Request], Awaitable[None]]] = []
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # Python 3.12 wait_closed() waits for every connection handler;
            # a handler parked on a quiet stream would hang shutdown, so
            # give in-flight requests a short grace then cancel the rest.
            if self._conns:
                await asyncio.wait(set(self._conns), timeout=2.0)
            for task in list(self._conns):
                task.cancel()
            await self._server.wait_closed()
            self._server = None

    @property
    def bound_port(self) -> int:
        assert self._server is not None and self._server.sockets
        return self._server.sockets[0].getsockname()[1]

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        remote = peer[0] if peer else ""
        task = asyncio.current_task()
        if task is not None:
            if len(self._conns) >= MAX_CONNECTIONS:
                try:
                    writer.write(
                        b"HTTP/1.1 503 X\r\nContent-Length: 0\r\n"
                        b"Connection: close\r\n\r\n"
                    )
                    await writer.drain()
                finally:
                    writer.close()
                return
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except HttpError as e:
                    body = json.dumps({"error": e.message}).encode()
                    writer.write(
                        f"HTTP/1.1 {e.status} X\r\nContent-Type: application/json\r\n"
                        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
                        + body
                    )
                    await writer.drain()
                    break
                except asyncio.TimeoutError:
                    break
                if req is None:
                    break
                req.remote = remote
                if req.headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_ws(req, reader, writer)
                    return
                keep = await self._handle_http(req, writer, reader)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:  # pragma: no cover
            logger.exception("connection handler error")
        finally:
            try:
                writer.close()
            except RuntimeError:
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Request | None:
        # Idle keep-alive wait is bounded separately from the head read so a
        # client that opens a socket and trickles bytes (slow loris) cannot
        # hold a connection slot: once the first byte arrives, the rest of
        # the head must land within HEAD_TIMEOUT.
        try:
            line = await asyncio.wait_for(reader.readline(), IDLE_TIMEOUT)
        except (ConnectionError, ValueError, asyncio.LimitOverrunError):
            return None
        if not line:
            return None
        if len(line) > MAX_HEADER_BYTES:
            raise HttpError(414, "request line too long")
        try:
            method, target, _version = line.decode("latin1").split()
        except ValueError:
            return None

        async def read_head() -> dict[str, str]:
            headers: dict[str, str] = {}
            total = len(line)
            while True:
                try:
                    h = await reader.readline()
                except (ValueError, asyncio.LimitOverrunError):
                    raise HttpError(431, "header line too long")
                if h in (b"\r\n", b"\n", b""):
                    return headers
                total += len(h)
                if total > MAX_HEADER_BYTES or len(headers) >= MAX_HEADERS:
                    raise HttpError(431, "headers too large")
                if b":" in h:
                    k, v = h.decode("latin1").split(":", 1)
                    headers[k.strip().lower()] = v.strip()

        headers = await asyncio.wait_for(read_head(), HEAD_TIMEOUT)
        body = b""
        try:
            n = int(headers.get("content-length", "0") or 0)
        except ValueError:
            raise HttpError(400, "invalid content-length")
        if n < 0:
            raise HttpError(400, "invalid content-length")
        if n:
            if n > MAX_BODY:
                raise HttpError(413, "body too large")
            try:
                body = await asyncio.wait_for(reader.readexactly(n), BODY_TIMEOUT)
            except asyncio.IncompleteReadError:
                return None
        parsed = urlparse(target)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        return Request(
            method=method.upper(),
            path=parsed.path,
            query=query,
            headers=headers,
            body=body,
        )

    async def _handle_http(
        self,
        req: Request,
        writer: asyncio.StreamWriter,
        reader: asyncio.StreamReader | None = None,
    ) -> bool:
        try:
            for mw in self.middleware:
                await mw(req)
            fn, params = self.router.find(req.method, req.path)
            if fn is None:
                raise HttpError(404)
            req.params = params
            resp = await fn(req)
        except HttpError as e:
            resp = Response.json({"error": e.message}, status=e.status)
        except Exception:
            logger.exception("handler error for %s %s", req.method, req.path)
            resp = Response.json({"error": "internal error"}, status=500)

        if resp.stream is not None:
            head = (
                f"HTTP/1.1 {resp.status} X\r\n"
                f"Content-Type: {resp.content_type}\r\n"
                "Transfer-Encoding: chunked\r\n"
                "Cache-Control: no-cache\r\n"
                "Access-Control-Allow-Origin: *\r\n"
            )
            for k, v in resp.headers.items():
                head += f"{k}: {v}\r\n"
            head += "Connection: close\r\n\r\n"
            writer.write(head.encode())
            await writer.drain()
            # A half-closed client (FIN, no RST) never fails writes and
            # leaves is_closing() False; watch the read side for EOF so a
            # quiet stream notices the client is gone.
            eof_task = (
                asyncio.ensure_future(reader.read(1)) if reader is not None else None
            )
            try:
                async for chunk in resp.stream:
                    if eof_task is not None and eof_task.done():
                        break
                    if not chunk:
                        # keepalive tick from the generator: probe liveness
                        if writer.is_closing():
                            break
                        continue
                    writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                    await writer.drain()
                writer.write(b"0\r\n\r\n")
                await writer.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                if eof_task is not None:
                    eof_task.cancel()
                aclose = getattr(resp.stream, "aclose", None)
                if aclose is not None:
                    try:
                        await aclose()
                    except Exception:  # pragma: no cover
                        pass
            return False  # long-lived response: close the connection
        head = (
            f"HTTP/1.1 {resp.status} X\r\n"
            f"Content-Type: {resp.content_type}\r\n"
            f"Content-Length: {len(resp.body)}\r\n"
            "Access-Control-Allow-Origin: *\r\n"
        )
        for k, v in resp.headers.items():
            head += f"{k}: {v}\r\n"
        head += "Connection: keep-alive\r\n\r\n"
        writer.write(head.encode() + resp.body)
        await writer.drain()
        return True

    async def _handle_ws(
        self, req: Request, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        # Run the middleware chain (auth, rate limit) on the upgrade request
        # before completing the handshake, same as plain HTTP requests.
        try:
            for mw in self.middleware:
                await mw(req)
        except HttpError as e:
            body = json.dumps({"error": e.message}).encode()
            writer.write(
                f"HTTP/1.1 {e.status} X\r\nContent-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
                + body
            )
            await writer.drain()
            return
        fn, params = self.router.find_ws(req.path)
        key = req.headers.get("sec-websocket-key")
        if fn is None or not key:
            writer.write(b"HTTP/1.1 404 X\r\nContent-Length: 0\r\n\r\n")
            await writer.drain()
            return
        accept = base64.b64encode(
            hashlib.sha1((key + WS_MAGIC).encode()).digest()
        ).decode()
        writer.write(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
            ).encode()
        )
        await writer.drain()
        req.params = params
        ws = WebSocket(reader, writer)
        # Stream handlers are send-only; drain incoming frames in the
        # background so client keepalive pings get ponged (recv() answers
        # them) even while the handler blocks on data production.
        drain = asyncio.create_task(self._ws_drain(ws))
        handler = asyncio.create_task(fn(req, ws))
        try:
            # drain returning means the client closed or vanished; cancel a
            # handler parked on quiet data production (it would otherwise
            # never notice and leak until shutdown).
            await asyncio.wait({handler, drain}, return_when=asyncio.FIRST_COMPLETED)
            if not handler.done():
                handler.cancel()
            await handler
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:  # pragma: no cover
            logger.exception("ws handler error for %s", req.path)
        finally:
            drain.cancel()
            if not handler.done():
                handler.cancel()  # conn task itself cancelled (server stop)
            await ws.close()

    @staticmethod
    async def _ws_drain(ws: "WebSocket") -> None:
        try:
            while not ws.closed:
                if await ws.recv() is None:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
