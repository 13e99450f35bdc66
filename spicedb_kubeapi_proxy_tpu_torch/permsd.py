"""Standalone authorization service: serve a permissions endpoint over
gRPC (the reference's permsd.py).

The network inverse of the proxy's `--spicedb-endpoint grpc://` mode: run
the `torch://` endpoint (with cross-request batched dispatch) on the
machine that owns the card, and point any number of proxy instances at
it — concurrent RPCs from all of them fuse into device-sized kernel
batches on the server.  It replaces a remote SpiceDB (reference
options.go:331-368) with a remote card evaluator behind the same
seven-verb gRPC surface.

    python -m spicedb_kubeapi_proxy_tpu_torch.permsd \\
        --listen-address 0.0.0.0:50051 \\
        --spicedb-endpoint torch:// \\
        --spicedb-bootstrap bootstrap.yaml \\
        --spicedb-token sekrit \\
        [--tls-cert-file cert.pem --tls-key-file key.pem]

`--spicedb-endpoint` defaults to `torch://`, on the CUDA card (it raises
where there is none); `torch://?device=cpu` and `embedded://` run on the
CPU when asked for.  grpcio is needed to serve: without it the command
exits 1 with the "requires grpcio" message before building anything.
SIGTERM or SIGINT stops it with exit 0.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys
from typing import Optional

from .spicedb.endpoints import Bootstrap, create_endpoint
from .spicedb.grpc_remote import (
    GrpcUnavailableError,
    PermissionsGrpcServer,
    _grpc,
)

log = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.permsd")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="permsd", description="CUDA authorization gRPC service")
    p.add_argument("--listen-address", default="127.0.0.1:50051")
    p.add_argument("--spicedb-endpoint", default="torch://",
                   help="backend to serve: torch:// (default, the CUDA "
                        "card), torch://?device=cpu or embedded://")
    p.add_argument("--spicedb-bootstrap", default="",
                   help="YAML file with bootstrap schema/relationships")
    p.add_argument("--spicedb-token", default="",
                   help="require this bearer token on every RPC")
    p.add_argument("--tls-cert-file", default="")
    p.add_argument("--tls-key-file", default="")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    return p


async def run(args, ready_cb=None) -> None:
    bootstrap: Optional[Bootstrap] = None
    if args.spicedb_bootstrap:
        bootstrap = Bootstrap.from_file(args.spicedb_bootstrap)
    endpoint = create_endpoint(args.spicedb_endpoint, bootstrap=bootstrap)
    tls_cert = tls_key = None
    if args.tls_cert_file and args.tls_key_file:
        # key material loads off the loop: startup shares this loop with
        # ready_cb-driven embedders
        loop = asyncio.get_running_loop()

        def _read_bytes(path):
            with open(path, "rb") as f:
                return f.read()

        tls_cert = await loop.run_in_executor(
            None, _read_bytes, args.tls_cert_file)
        tls_key = await loop.run_in_executor(
            None, _read_bytes, args.tls_key_file)
    server = PermissionsGrpcServer(endpoint, token=args.spicedb_token,
                                   tls_cert=tls_cert, tls_key=tls_key)
    port = await server.start(args.listen_address)
    log.info("permsd serving %s on %s (port %d)%s",
             args.spicedb_endpoint, args.listen_address, port,
             " [TLS]" if tls_cert else "")
    if ready_cb is not None:
        ready_cb(port)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-unix
            pass
    try:
        await stop.wait()
    finally:
        await server.stop()
        close = getattr(endpoint, "close", None)
        if close is not None:
            await close()


def main(argv: Optional[list] = None) -> int:
    from .cli import _normalize_argv

    args = build_parser().parse_args(_normalize_argv(
        list(sys.argv[1:] if argv is None else argv)))
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 4 else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    try:
        _grpc()
    except GrpcUnavailableError as e:
        print(f"permsd: {e}", file=sys.stderr)
        return 1
    try:
        asyncio.run(run(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
