"""Minimal asyncio HTTP/1.1 core (h11-based): server, client, transports.

The proxy's serving and upstream layers.  Keeps full control over streaming
(watch responses are long-lived chunked streams whose frames must be relayed
byte-exactly — reference pkg/authz/frames.go) and over encoding ownership
(the proxy strips the client's Accept-Encoding and handles upstream gzip
itself — reference pkg/proxy/server.go:98-108).

Two transports implement the upstream seam:
- HandlerTransport: direct in-process dispatch to a Handler (the reference's
  pkg/inmemory round tripper)
- H11Transport: real TCP/TLS connections.

`h11` is imported by the two classes that speak HTTP on a socket
(`H11Transport`, `HttpServer`) when they run, never at module import:
the in-process path (`HandlerTransport`, the embedded client, the fake
kube-apiserver) needs no third-party package.
"""

from __future__ import annotations

import asyncio
import gzip as gzip_mod
import ssl
from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable, Optional
from urllib.parse import urlsplit


class Headers:
    """Case-insensitive multi-value header collection."""

    def __init__(self, items: Optional[list] = None):
        self._items: list[tuple[str, str]] = []
        for k, v in items or []:
            self.add(k, v)

    def add(self, key: str, value: str) -> None:
        self._items.append((str(key), str(value)))

    def set(self, key: str, value: str) -> None:
        self.remove(key)
        self.add(key, value)

    def remove(self, key: str) -> None:
        lk = key.lower()
        self._items = [(k, v) for k, v in self._items if k.lower() != lk]

    def get(self, key: str, default: str = "") -> str:
        lk = key.lower()
        for k, v in self._items:
            if k.lower() == lk:
                return v
        return default

    def get_all(self, key: str) -> list:
        lk = key.lower()
        return [v for k, v in self._items if k.lower() == lk]

    def items(self) -> list:
        return list(self._items)

    def to_dict(self) -> dict:
        """{name: [values]} with canonical casing of first occurrence."""
        out: dict[str, list] = {}
        for k, v in self._items:
            out.setdefault(k, []).append(v)
        return out

    def __contains__(self, key: str) -> bool:
        return any(k.lower() == key.lower() for k, _ in self._items)

    def copy(self) -> "Headers":
        return Headers(self._items)


@dataclass
class Request:
    method: str
    target: str               # path + optional ?query
    headers: Headers = field(default_factory=Headers)
    body: bytes = b""
    # request-scoped context values (request_info, user, response filterer…)
    context: dict = field(default_factory=dict)
    peer_cert: Optional[dict] = None  # TLS client certificate, if any
    peer_cert_der: Optional[bytes] = None  # same certificate, DER bytes

    @property
    def path(self) -> str:
        return urlsplit(self.target).path


@dataclass
class Response:
    status: int = 200
    headers: Headers = field(default_factory=Headers)
    body: bytes = b""
    # set for streaming responses (watch); consumed exactly once
    stream: Optional[AsyncIterator[bytes]] = None

    @property
    def is_stream(self) -> bool:
        return self.stream is not None


Handler = Callable[[Request], Awaitable[Response]]


def json_response(status: int, obj, content_type: str = "application/json") -> Response:
    import json
    body = json.dumps(obj).encode()
    resp = Response(status=status, body=body)
    resp.headers.set("Content-Type", content_type)
    return resp


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class Transport:
    async def round_trip(self, req: Request) -> Response:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class HandlerTransport(Transport):
    """In-process dispatch (reference pkg/inmemory/transport.go)."""

    def __init__(self, handler: Handler):
        self.handler = handler

    async def round_trip(self, req: Request) -> Response:
        return await self.handler(req)


class H11Transport(Transport):
    """One TCP/TLS connection per request (no pooling); handles gzip
    decompression so response filtering always sees plaintext."""

    def __init__(self, base_url: str,
                 ssl_context: Optional[ssl.SSLContext] = None):
        split = urlsplit(base_url)
        self.scheme = split.scheme or "http"
        self.host = split.hostname or "localhost"
        self.port = split.port or (443 if self.scheme == "https" else 80)
        self.ssl_context = ssl_context

    async def round_trip(self, req: Request) -> Response:
        import h11

        ssl_ctx = None
        if self.scheme == "https":
            ssl_ctx = self.ssl_context
            if ssl_ctx is None:
                ssl_ctx = ssl.create_default_context()
        reader, writer = await asyncio.open_connection(
            self.host, self.port, ssl=ssl_ctx)
        conn = h11.Connection(our_role=h11.CLIENT)

        headers = [(k, v) for k, v in req.headers.items()
                   if k.lower() not in ("host", "content-length",
                                        "transfer-encoding", "connection",
                                        "accept-encoding")]
        headers.append(("Host", f"{self.host}:{self.port}"))
        headers.append(("Content-Length", str(len(req.body))))
        # the transport owns encoding negotiation (reference activity.go:
        # 208-215, server.go:98-108): ask for gzip on its own behalf and
        # decompress transparently below, so callers always see plaintext.
        # Watch streams are relayed frame-by-frame without buffering, so
        # no gzip there.
        if "watch" not in urlsplit(req.target).query:
            headers.append(("Accept-Encoding", "gzip"))

        writer.write(conn.send(h11.Request(
            method=req.method.encode(), target=req.target.encode(),
            headers=[(k.encode(), v.encode()) for k, v in headers])))
        if req.body:
            writer.write(conn.send(h11.Data(data=req.body)))
        writer.write(conn.send(h11.EndOfMessage()))
        await writer.drain()

        async def next_event():
            while True:
                event = conn.next_event()
                if event is h11.NEED_DATA:
                    data = await reader.read(65536)
                    conn.receive_data(data)
                    continue
                return event

        event = await next_event()
        if not isinstance(event, h11.Response):
            writer.close()
            raise ConnectionError(f"unexpected h11 event {event!r}")
        resp = Response(status=event.status_code)
        for k, v in event.headers:
            resp.headers.add(k.decode(), v.decode())

        content_type = resp.headers.get("Content-Type", "")
        is_watch = "watch" in urlsplit(req.target).query and (
            "json" in content_type or content_type == "")

        if is_watch:
            async def stream():
                try:
                    while True:
                        ev = await next_event()
                        if isinstance(ev, h11.Data):
                            yield bytes(ev.data)
                        elif isinstance(ev, (h11.EndOfMessage,
                                             h11.ConnectionClosed)):
                            return
                finally:
                    writer.close()

            resp.stream = stream()
            return resp

        chunks = []
        while True:
            ev = await next_event()
            if isinstance(ev, h11.Data):
                chunks.append(bytes(ev.data))
            elif isinstance(ev, (h11.EndOfMessage, h11.ConnectionClosed)):
                break
        writer.close()
        resp.body = b"".join(chunks)
        if resp.headers.get("Content-Encoding").lower() == "gzip":
            resp.body = gzip_mod.decompress(resp.body)
            resp.headers.remove("Content-Encoding")
            resp.headers.set("Content-Length", str(len(resp.body)))
        return resp


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class HttpServer:
    """asyncio HTTP/1.1 server driving a Handler; supports TLS with optional
    client-certificate auth and streaming (chunked) responses."""

    def __init__(self, handler: Handler,
                 ssl_context: Optional[ssl.SSLContext] = None):
        self.handler = handler
        self.ssl_context = ssl_context
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._track_conn, host, port, ssl=self.ssl_context)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # long-lived watch connections would block wait_closed forever
            for task in list(self._conn_tasks):
                task.cancel()
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5)
            except asyncio.TimeoutError:
                pass
            self._server = None

    async def _track_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            await self._serve_conn(reader, writer)
        except asyncio.CancelledError:
            pass
        finally:
            self._conn_tasks.discard(task)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        peer_cert = peer_cert_der = None
        ssl_obj = writer.get_extra_info("ssl_object")
        if ssl_obj is not None:
            try:
                peer_cert = ssl_obj.getpeercert()
                peer_cert_der = ssl_obj.getpeercert(True)
            except ValueError:
                peer_cert = peer_cert_der = None
        import h11

        conn = h11.Connection(our_role=h11.SERVER)
        try:
            while True:
                event = await self._next_event(conn, reader)
                if isinstance(event, h11.ConnectionClosed) or event is None:
                    return
                if not isinstance(event, h11.Request):
                    return
                req = Request(
                    method=event.method.decode(),
                    target=event.target.decode(),
                    headers=Headers([(k.decode(), v.decode())
                                     for k, v in event.headers]),
                    peer_cert=peer_cert,
                    peer_cert_der=peer_cert_der,
                )
                body = bytearray()
                while True:
                    ev = await self._next_event(conn, reader)
                    if isinstance(ev, h11.Data):
                        body.extend(ev.data)
                    elif isinstance(ev, h11.EndOfMessage):
                        break
                    elif ev is None or isinstance(ev, h11.ConnectionClosed):
                        return
                req.body = bytes(body)

                try:
                    resp = await self.handler(req)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # panic recovery boundary
                    resp = json_response(500, {
                        "kind": "Status", "apiVersion": "v1",
                        "status": "Failure",
                        "message": f"internal error: {e}",
                        "code": 500})

                await self._write_response(conn, writer, resp)
                if conn.our_state is h11.MUST_CLOSE or resp.is_stream:
                    return
                conn.start_next_cycle()
        except (ConnectionResetError, BrokenPipeError, h11.RemoteProtocolError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    async def _next_event(conn: "h11.Connection",
                          reader: asyncio.StreamReader):
        import h11

        while True:
            event = conn.next_event()
            if event is h11.NEED_DATA:
                data = await reader.read(65536)
                if not data and conn.their_state is h11.IDLE:
                    return None
                conn.receive_data(data)
                continue
            return event

    @staticmethod
    async def _write_response(conn: "h11.Connection",
                              writer: asyncio.StreamWriter,
                              resp: Response) -> None:
        import h11

        headers = [(k, v) for k, v in resp.headers.items()
                   if k.lower() not in ("content-length", "transfer-encoding",
                                        "connection", "date")]
        if resp.is_stream:
            headers.append(("Transfer-Encoding", "chunked"))
            writer.write(conn.send(h11.Response(
                status_code=resp.status,
                headers=[(k.encode(), v.encode()) for k, v in headers])))
            await writer.drain()
            try:
                async for chunk in resp.stream:
                    if chunk:
                        writer.write(conn.send(h11.Data(data=chunk)))
                        await writer.drain()
            finally:
                try:
                    writer.write(conn.send(h11.EndOfMessage()))
                    await writer.drain()
                except Exception:
                    pass
            return
        headers.append(("Content-Length", str(len(resp.body))))
        writer.write(conn.send(h11.Response(
            status_code=resp.status,
            headers=[(k.encode(), v.encode()) for k, v in headers])))
        if resp.body:
            writer.write(conn.send(h11.Data(data=resp.body)))
        writer.write(conn.send(h11.EndOfMessage()))
        await writer.drain()
