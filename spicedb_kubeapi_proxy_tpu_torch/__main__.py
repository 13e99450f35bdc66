"""`python -m spicedb_kubeapi_proxy_tpu_torch` (this package's reference
__main__.py; cmd/spicedb-kubeapi-proxy/main.go:20-29 upstream)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
