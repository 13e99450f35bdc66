"""Deliberate compiler mutations — the port's fuzz harness's own tripwire.

A differential fuzzer that never fires is indistinguishable from one
that cannot fire.  These context managers inject a *real* class of
kernel bug into the port's graph compiler (ops/graph_compile.py) at
runtime; the fixed-seed smoke set must catch each one and shrink it to a
small artifact (`python -m spicedb_kubeapi_proxy_tpu_torch.fuzz
--mutation NAME`).  The compiler calls `_finalize_program` and
`_compile_expr` through its module globals (compile_graph,
compile_graph_columnar and the expression recursion), so a patch here
reaches every graph an endpoint builds while it is live; the host oracle
is untouched.  They are test and tooling helpers, never imported by
serving code.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def wildcard_plane_skipped():
    """Compile device graphs with every wildcard term dropped — the
    `user:*` plane silently skipped, exactly the class of bug where one
    lowering path forgets a term class.  Any wildcard-granted answer
    diverges from the oracle."""
    from ..ops import graph_compile as gc

    orig = gc._finalize_program

    def broken(prog, schema, src_arr, dst_arr, wildcard_map, arrow_slots,
               *args, **kwargs):
        return orig(prog, schema, src_arr, dst_arr, {}, arrow_slots,
                    *args, **kwargs)

    gc._finalize_program = broken
    try:
        yield
    finally:
        gc._finalize_program = orig


@contextlib.contextmanager
def exclusion_dropped():
    """Compile permission programs with `base - subtract` lowered as
    just `base` — the subtraction plane skipped.  Any banned/denied
    subject the oracle rejects shows up allowed on the device."""
    from ..ops import graph_compile as gc
    from ..spicedb import schema as sch

    orig = gc._compile_expr

    def broken(prog, schema, t, p, expr, arrow_slots, counter):
        if isinstance(expr, sch.Exclusion):
            expr = expr.base
        return orig(prog, schema, t, p, expr, arrow_slots, counter)

    gc._compile_expr = broken
    try:
        yield
    finally:
        gc._compile_expr = orig


MUTATIONS = {
    "wildcard-plane-skipped": wildcard_plane_skipped,
    "exclusion-dropped": exclusion_dropped,
}
