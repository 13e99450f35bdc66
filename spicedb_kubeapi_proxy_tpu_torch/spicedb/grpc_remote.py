"""Remote permissions endpoint over gRPC and the standalone authz server
(the reference's spicedb/grpc_remote.py).

`RemoteEndpoint` is the reference's remote-SpiceDB mode (options.go:
331-368: a TLS or insecure channel, bearer-token credentials, a custom CA
or a pinned server certificate).  `PermissionsGrpcServer` is its
inverse: it serves any local endpoint over gRPC, the `torch://` endpoint
on the card behind the cross-request dispatcher included, so many proxy
instances share one card: their concurrent RPCs fuse into device-sized
kernel batches on the server (`python -m
spicedb_kubeapi_proxy_tpu_torch.permsd`).  Method paths and message
encodings follow authzed.api.v1 (spicedb/wire.py).

Verbs: CheckPermission, CheckBulkPermissions, LookupResources
(server-stream), ReadRelationships (server-stream), WriteRelationships,
DeleteRelationships, Watch (server-stream).

grpcio is imported where a channel is dialed or the server starts, never
when this module loads: the wire codecs and the seven handlers
(`PermissionsGrpcServer.handlers()`) run where grpcio is absent, and
there dialing or serving raises `GrpcUnavailableError` with the
reference's "requires grpcio" message.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Iterable, Optional

from . import wire
from .endpoints import PermissionsEndpoint
from .store import WatchQueue
from .types import (
    AlreadyExistsError,
    CheckRequest,
    CheckResult,
    Permissionship,
    Precondition,
    PreconditionFailedError,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectRef,
    WatchUpdate,
)

_PERMS = "/authzed.api.v1.PermissionsService/"
_WATCH = "/authzed.api.v1.WatchService/Watch"

_identity = lambda b: b  # noqa: E731 — payloads are already bytes


class GrpcUnavailableError(ImportError):
    """grpcio is not installed: no channel can be dialed, no server run."""


def _grpc():
    """The grpc module, imported at use."""
    try:
        import grpc
        import grpc.aio  # noqa: F401
    except ImportError as e:
        raise GrpcUnavailableError(
            f"the remote endpoint and permsd require grpcio: {e}") from e
    return grpc


def _status(name: str):
    """The gRPC status code `name` (grpc.StatusCode member), or the name
    itself where grpcio is absent (the handlers driven in-process)."""
    try:
        import grpc
    except ImportError:
        return name
    return grpc.StatusCode[name]


class RemoteEndpointError(Exception):
    def __init__(self, code, details: str):
        self.code = code
        super().__init__(f"remote endpoint error {code}: {details}")


def _map_rpc_error(e) -> Exception:
    grpc = _grpc()
    code = e.code() if callable(getattr(e, "code", None)) else None
    details = e.details() if callable(getattr(e, "details", None)) else str(e)
    if code == grpc.StatusCode.ALREADY_EXISTS:
        return AlreadyExistsError(details)
    return RemoteEndpointError(code, details or "")


class _RemoteWatcher(WatchQueue):
    """Adapter: a background sync-gRPC Watch stream feeding the same
    poll()/next()/close() surface as store.Watcher (the async consumer in
    authz/watch.py awaits next() directly — the stream thread wakes it
    through the queue, no polling)."""

    def __init__(self, target: str, object_types: Optional[list],
                 channel_factory, metadata: Iterable = ()):
        super().__init__()
        # the bearer token travels on the stream as on every other RPC
        # (the reference's watcher sends none, so against a server that
        # requires a token its stream ends UNAUTHENTICATED at once and
        # the watch delivers nothing)
        self._metadata = list(metadata)
        # channel creation happens ON the stream thread: the factory may
        # fetch and pin the server certificate (blocking socket I/O) and
        # watch() is called synchronously from async code
        # (responsefilterer.py run_watcher): the loop must not block
        self._target = target
        self._channel = None
        self._channel_lock = threading.Lock()
        self._closed_early = False
        self._thread = threading.Thread(
            target=self._run, args=(object_types, channel_factory),
            name="authz-remote-watch", daemon=True)
        self._thread.start()

    def _run(self, object_types, channel_factory) -> None:
        try:
            grpc = _grpc()
        except GrpcUnavailableError:
            import logging
            logging.getLogger(__name__).exception(
                "remote watch of %s needs grpcio", self._target)
            self._mark_closed()
            return
        try:
            with self._channel_lock:
                if self._closed_early:
                    return
            # the factory may block (TCP dial, cert-pin fetch): run it
            # OUTSIDE the lock so close() never waits on it
            channel = channel_factory()
            with self._channel_lock:
                if self._closed_early:
                    channel.close()
                    return
                self._channel = channel
            call = channel.unary_stream(
                _WATCH, request_serializer=_identity,
                response_deserializer=_identity,
            )(wire.enc_watch_request(object_types),
              metadata=self._metadata or None)
            for payload in call:
                revision, updates = wire.dec_watch_response(payload)
                if not updates:
                    continue
                self._push(WatchUpdate(updates=tuple(updates),
                                       revision=revision))
        except grpc.RpcError:
            pass  # channel closed / server gone: surface as closed watcher
        except Exception:
            import logging
            logging.getLogger(__name__).exception(
                "remote watch setup failed for %s — watch delivers no "
                "events", self._target)
        finally:
            self._mark_closed()

    def close(self) -> None:
        self._mark_closed()
        with self._channel_lock:
            self._closed_early = True
            channel = self._channel
        if channel is not None:
            channel.close()


class RemoteEndpoint(PermissionsEndpoint):
    """gRPC client for a remote permissions service (reference
    options.go:331-368 channel semantics: `grpcs`/`https` or `--spicedb-
    insecure` plaintext, bearer token metadata, optional custom CA)."""

    def __init__(self, target: str, token: str = "", insecure: bool = False,
                 ca_pem: Optional[bytes] = None, skip_verify: bool = False):
        self.target = target
        self.token = token
        self.insecure = insecure
        self.ca_pem = ca_pem
        self.skip_verify = skip_verify
        self._pinned: Optional[tuple] = None  # (pem, channel options) cache
        self._aio_channel = None
        self._lock = threading.Lock()

    # -- channels -----------------------------------------------------------

    def _metadata(self) -> list:
        return ([("authorization", f"Bearer {self.token}")]
                if self.token else [])

    @staticmethod
    def _parse_target(target: str) -> tuple:
        """(host, port) from a gRPC dial target.  Handles `[::1]:443`
        bracketed IPv6 (brackets stripped for the socket dial), bare IPv6
        addresses with no port, and `host[:port]` (default port 443)."""
        if target.startswith("["):
            host, _, rest = target[1:].partition("]")
            port = rest[1:] if rest.startswith(":") else ""
        elif target.count(":") > 1:  # bare IPv6 literal, no port
            host, port = target, ""
        else:
            host, _, port = target.partition(":")
        return host, int(port) if port.isdigit() else 443

    def _pin_server_cert(self) -> tuple:
        """skip_verify support (reference options.go:349-355
        `WithInsecureSkipVerify`): gRPC-python has no "don't verify" knob,
        so fetch the server's own certificate once (bounded 10s timeout,
        cached), pin it as the trust root, and override the TLS target name
        with the certificate's own subject so hostname verification passes
        for IP dials / SAN mismatches.  Returns (pem bytes, channel options).

        Blocking socket I/O: async callers go through _ensure_pinned(),
        which runs this in an executor; only the sync watch thread and
        channel setup with the result already cached reach it directly.
        """
        if self._pinned is not None:
            return self._pinned
        import ssl
        host, port = self._parse_target(self.target)
        pem = ssl.get_server_certificate((host, port), timeout=10.0)
        options = []
        try:
            from cryptography import x509
            from cryptography.x509.oid import NameOID

            cert = x509.load_pem_x509_certificate(pem.encode())
            names = []
            try:
                san = cert.extensions.get_extension_for_class(
                    x509.SubjectAlternativeName)
                names = list(san.value.get_values_for_type(x509.DNSName))
            except x509.ExtensionNotFound:
                pass
            names += [a.value for a in
                      cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)]
            if names and names[0] != host:
                options = [("grpc.ssl_target_name_override", names[0])]
        except Exception:
            pass  # no name override; pinning alone may still suffice
        # benign race: two concurrent fetchers produce the same certificate
        self._pinned = (pem.encode(), options)
        return self._pinned

    def _needs_pin(self) -> bool:
        return (not self.insecure and self.skip_verify
                and self.ca_pem is None and self._pinned is None)

    async def _ensure_pinned(self) -> None:
        """Fetch/pin the server certificate off-loop, before channel
        creation, so no blocking socket I/O ever runs on the event loop."""
        if self._needs_pin():
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._pin_server_cert)

    def _creds(self) -> tuple:
        """(channel credentials, channel options) for TLS channels."""
        grpc = _grpc()
        if self.ca_pem is not None or not self.skip_verify:
            return grpc.ssl_channel_credentials(
                root_certificates=self.ca_pem), []
        pem, options = self._pin_server_cert()
        return grpc.ssl_channel_credentials(root_certificates=pem), options

    def _channel(self):
        if self._aio_channel is None:
            grpc = _grpc()
            with self._lock:
                if self._aio_channel is None:
                    if self.insecure:
                        self._aio_channel = grpc.aio.insecure_channel(
                            self.target)
                    else:
                        creds, options = self._creds()
                        self._aio_channel = grpc.aio.secure_channel(
                            self.target, creds, options=options)
        return self._aio_channel

    def _sync_channel(self):
        grpc = _grpc()
        if self.insecure:
            return grpc.insecure_channel(self.target)
        creds, options = self._creds()
        return grpc.secure_channel(self.target, creds, options=options)

    async def _unary(self, method: str, payload: bytes) -> bytes:
        grpc = _grpc()
        await self._ensure_pinned()
        fn = self._channel().unary_unary(
            _PERMS + method, request_serializer=_identity,
            response_deserializer=_identity)
        try:
            return await fn(payload, metadata=self._metadata())
        except grpc.RpcError as e:
            raise _map_rpc_error(e) from e

    async def _unary_stream(self, method: str, payload: bytes):
        """Open a server-stream and yield raw frames as they arrive."""
        grpc = _grpc()
        await self._ensure_pinned()
        fn = self._channel().unary_stream(
            _PERMS + method, request_serializer=_identity,
            response_deserializer=_identity)
        try:
            async for chunk in fn(payload, metadata=self._metadata()):
                yield chunk
        except grpc.RpcError as e:
            raise _map_rpc_error(e) from e

    # -- verbs --------------------------------------------------------------

    async def check_permission(self, req: CheckRequest) -> CheckResult:
        payload = await self._unary("CheckPermission",
                                    wire.enc_check_request(req))
        return wire.dec_check_response(payload)

    async def check_bulk_permissions(self, reqs: list) -> list:
        if not reqs:
            return []
        payload = await self._unary("CheckBulkPermissions",
                                    wire.enc_bulk_request(reqs))
        return wire.dec_bulk_response(payload)

    async def lookup_resources(self, resource_type: str, permission: str,
                               subject: SubjectRef) -> list:
        return [rid async for rid in self.lookup_resources_stream(
            resource_type, permission, subject)]

    async def lookup_resources_stream(self, resource_type: str,
                                      permission: str, subject: SubjectRef):
        """Incremental drain of the LookupResources server-stream
        (reference lookups.go:74-135): ids yield as frames arrive.

        CONDITIONAL results are SKIPPED here, as the reference does for its
        remote SpiceDB (lookups.go:85-88): a real SpiceDB streams caveated
        matches with permissionship=CONDITIONAL, and including them in a
        prefilter allowed-set would over-grant.  (Local endpoints never
        emit them: their LookupResources is definite-plane.)"""
        payload = wire.enc_lookup_request(resource_type, permission, subject)
        async for chunk in self._unary_stream("LookupResources", payload):
            rid, ship = wire.dec_lookup_response(chunk)
            if ship != Permissionship.HAS_PERMISSION:
                continue
            yield rid

    async def lookup_resources_batch(self, resource_type: str,
                                     permission: str, subjects: list) -> list:
        """Concurrent LookupResources streams, not sequential ones: a
        permsd server over `torch://` fuses concurrent callers into device
        batches (spicedb/dispatch.py), so issuing the whole batch at once
        lets the SERVER batch it."""
        return list(await asyncio.gather(
            *[self.lookup_resources(resource_type, permission, s)
              for s in subjects]))

    async def read_relationships(self, flt: Optional[RelationshipFilter]) -> list:
        return [rel async for rel in self.read_relationships_stream(flt)]

    async def read_relationships_stream(self, flt: Optional[RelationshipFilter]):
        async for chunk in self._unary_stream("ReadRelationships",
                                              wire.enc_read_request(flt)):
            yield wire.dec_read_response(chunk)

    async def write_relationships(self, updates: Iterable[RelationshipUpdate],
                                  preconditions: Iterable[Precondition] = ()) -> int:
        payload = await self._unary(
            "WriteRelationships",
            wire.enc_write_request(list(updates), list(preconditions)))
        return wire.dec_write_response(payload)

    async def delete_relationships(self, flt: RelationshipFilter,
                                   preconditions: Iterable[Precondition] = ()) -> int:
        payload = await self._unary(
            "DeleteRelationships",
            wire.enc_delete_request(flt, list(preconditions)))
        return wire.dec_delete_response(payload)

    def watch(self, object_types: Optional[Iterable[str]] = None):
        return _RemoteWatcher(self.target,
                              list(object_types) if object_types else None,
                              self._sync_channel, self._metadata())

    async def close(self) -> None:
        if self._aio_channel is not None:
            await self._aio_channel.close()


# -- server ------------------------------------------------------------------


def _bearer_interceptor(token: str):
    """A grpc.aio server interceptor refusing every RPC whose
    `authorization` metadata is not `Bearer <token>` (UNAUTHENTICATED)."""
    import hmac

    grpc = _grpc()
    want = f"Bearer {token}".encode()

    class _BearerInterceptor(grpc.aio.ServerInterceptor):
        def _authed(self, handler_call_details) -> bool:
            for k, v in handler_call_details.invocation_metadata or ():
                if k == "authorization":
                    got = v.encode() if isinstance(v, str) else v
                    if hmac.compare_digest(got, want):
                        return True
            return False

        async def intercept_service(self, continuation, handler_call_details):
            handler = await continuation(handler_call_details)
            if handler is None or self._authed(handler_call_details):
                return handler

            async def deny(ignored_request, context):
                await context.abort(grpc.StatusCode.UNAUTHENTICATED,
                                    "invalid or missing bearer token")

            async def deny_stream(ignored_request, context):
                await context.abort(grpc.StatusCode.UNAUTHENTICATED,
                                    "invalid or missing bearer token")
                yield  # pragma: no cover - abort raises before any yield

            # deny with a handler of the method's streaming shape, so a
            # server-streaming verb (Watch) gets a clean UNAUTHENTICATED
            # rather than a handler-type mismatch
            if handler.response_streaming:
                return grpc.unary_stream_rpc_method_handler(
                    deny_stream, request_deserializer=_identity,
                    response_serializer=_identity)
            return grpc.unary_unary_rpc_method_handler(
                deny, request_deserializer=_identity,
                response_serializer=_identity)

    return _BearerInterceptor()


class PermissionsGrpcServer:
    """Serves any PermissionsEndpoint over gRPC (the remote half of the
    endpoint seam).  Over a batched `torch://` endpoint this is a
    network-shared card: concurrent RPCs from many proxies fuse into
    device-sized kernel batches on the server."""

    def __init__(self, endpoint: PermissionsEndpoint, token: str = "",
                 tls_cert: Optional[bytes] = None,
                 tls_key: Optional[bytes] = None):
        self.endpoint = endpoint
        self._token = token
        self._tls = (tls_cert, tls_key) if tls_cert and tls_key else None
        self._server = None
        self.port: Optional[int] = None

    # -- handlers -----------------------------------------------------------

    def handlers(self) -> dict:
        """method path -> (response_streaming, handler): the seven verbs
        as async functions of (request bytes, context), the unary ones
        returning the response bytes and the streaming ones yielding them.
        A failure calls `await context.abort(code, details)`, which raises
        (grpc's context does; an in-process caller's must too).  They need
        no grpcio: `start()` wraps them in grpc's method handlers."""
        ep = self.endpoint

        async def check(request: bytes, context) -> bytes:
            try:
                res = await ep.check_permission(wire.dec_check_request(request))
            except Exception as e:
                await context.abort(_status("FAILED_PRECONDITION"), str(e))
            return wire.enc_check_response(res)

        async def bulk(request: bytes, context) -> bytes:
            reqs = wire.dec_bulk_request(request)
            try:
                results = await ep.check_bulk_permissions(reqs)
            except Exception as e:
                await context.abort(_status("FAILED_PRECONDITION"), str(e))
            rev = max((r.checked_at for r in results), default=0)
            return wire.enc_bulk_response(rev, results)

        async def lookup(request: bytes, context):
            rtype, perm, subject = wire.dec_lookup_request(request)
            try:
                ids = await ep.lookup_resources(rtype, perm, subject)
            except Exception as e:
                await context.abort(_status("FAILED_PRECONDITION"), str(e))
                return
            for rid in ids:
                yield wire.enc_lookup_response(0, rid)

        async def read(request: bytes, context):
            flt = wire.dec_read_request(request)
            rels = await ep.read_relationships(flt)
            for rel in rels:
                yield wire.enc_read_response(0, rel)

        async def write(request: bytes, context) -> bytes:
            updates, preconditions = wire.dec_write_request(request)
            try:
                rev = await ep.write_relationships(updates, preconditions)
            except AlreadyExistsError as e:
                await context.abort(_status("ALREADY_EXISTS"), str(e))
            except PreconditionFailedError as e:
                await context.abort(_status("FAILED_PRECONDITION"), str(e))
            except Exception as e:
                await context.abort(_status("INVALID_ARGUMENT"), str(e))
            return wire.enc_write_response(rev)

        async def delete(request: bytes, context) -> bytes:
            flt, preconditions = wire.dec_delete_request(request)
            try:
                rev = await ep.delete_relationships(flt, preconditions)
            except PreconditionFailedError as e:
                await context.abort(_status("FAILED_PRECONDITION"), str(e))
            except Exception as e:
                await context.abort(_status("INVALID_ARGUMENT"), str(e))
            return wire.enc_delete_response(rev)

        async def watch(request: bytes, context):
            object_types = wire.dec_watch_request(request)
            watcher = self.endpoint.watch(object_types)
            loop = asyncio.get_running_loop()
            try:
                while True:
                    update = await loop.run_in_executor(None, watcher.poll, 0.5)
                    if update is None:
                        if watcher.closed or context.cancelled():
                            return
                        continue
                    yield wire.enc_watch_response(update.revision,
                                                  list(update.updates))
            finally:
                watcher.close()

        return {
            _PERMS + "CheckPermission": (False, check),
            _PERMS + "CheckBulkPermissions": (False, bulk),
            _PERMS + "LookupResources": (True, lookup),
            _PERMS + "ReadRelationships": (True, read),
            _PERMS + "WriteRelationships": (False, write),
            _PERMS + "DeleteRelationships": (False, delete),
            _WATCH: (True, watch),
        }

    # -- lifecycle ----------------------------------------------------------

    async def start(self, address: str = "127.0.0.1:0") -> int:
        grpc = _grpc()
        interceptors = ([_bearer_interceptor(self._token)]
                        if self._token else [])
        server = grpc.aio.server(interceptors=interceptors)
        kw = dict(request_deserializer=_identity, response_serializer=_identity)
        handlers = {
            path: (grpc.unary_stream_rpc_method_handler(fn, **kw) if streaming
                   else grpc.unary_unary_rpc_method_handler(fn, **kw))
            for path, (streaming, fn) in self.handlers().items()}

        class _Generic(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                return handlers.get(handler_call_details.method)

        server.add_generic_rpc_handlers((_Generic(),))
        if self._tls:
            creds = grpc.ssl_server_credentials([(self._tls[1], self._tls[0])])
            self.port = server.add_secure_port(address, creds)
        else:
            self.port = server.add_insecure_port(address)
        await server.start()
        self._server = server
        return self.port

    async def stop(self, grace: float = 1.0) -> None:
        if self._server is not None:
            await self._server.stop(grace)
            self._server = None
