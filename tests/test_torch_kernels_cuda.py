"""The torch port's CUDA kernels against their plain-torch twins, on a card.

Needs a CUDA device and nvcc (the kernels have no CPU mode), so every test
here carries the `cuda` marker and skips where no device is present.  It
imports nothing but the port, so it also runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu_torch.models import workloads
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)

WILDCARD = ("definition user {}\ndefinition doc {\n"
            "  relation viewer: user | user:*\n  relation banned: user\n"
            "  permission view = viewer - banned\n}")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _graphs(schema, rels):
    bs = Bootstrap(schema, "\n".join(rels))
    return [create_endpoint(f"torch://?device={d}", bs).graph()
            for d in ("cpu", "cuda")]


def _workload():
    w = workloads.rbac_deny(n_pods=400, n_users=300, n_groups=10)
    return w.schema_text, w.relationships


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 33, 256])
def test_every_sweep_step_matches_its_twin(lanes):
    _needs_card()
    g_cpu, g = _graphs(*_workload())
    kc, prog = g.kernel, g.prog
    main, aux = g.snapshot()
    rng = np.random.default_rng(lanes)
    w = max(1, -(-lanes // 32))
    w = 1 << (w - 1).bit_length()
    q = np.full(32 * w, prog.dead_index, np.int32)
    q[:lanes] = rng.integers(0, prog.dead_index, lanes)
    qd = torch.from_numpy(q).cuda()
    nt = prog.state_size + kc.n_aux_rows
    x0 = kernels.seed_bitplanes(qd, nt, w, prog.dead_index)
    assert torch.equal(x0, reference.seed_bitplanes(qd, nt, w,
                                                    prog.dead_index))
    x = x0.clone()
    for _ in range(2):
        a, b = x.clone(), x.clone()
        for step in kc.sweep_steps(main, aux):
            EllKernelCache.run_step(step, a, x0, None, kernels)
            EllKernelCache.run_step(step, b, x0, None, reference)
            torch.cuda.synchronize()
            assert torch.equal(a, b), step[0]
        assert kernels.sweep_delta(a, x, prog.dead_index).tolist() == \
            reference.sweep_delta(b, x, prog.dead_index).tolist()
        x = a
    off, length = prog.slot_range("pod", "view")
    assert torch.equal(kernels.lookup_T(x, off, length),
                       reference.lookup_T(x, off, length))
    gi = torch.from_numpy(rng.integers(0, prog.state_size, 999)
                          .astype(np.int32)).cuda()
    gc = torch.from_numpy(rng.integers(0, lanes, 999).astype(np.int32)).cuda()
    assert torch.equal(kernels.check_gather(x, gi, gc),
                       reference.check_gather(x, gi, gc))


@pytest.mark.cuda
def test_card_and_cpu_endpoints_agree_with_wildcards():
    _needs_card()
    rels = ["doc:d1#viewer@user:*", "doc:d1#banned@user:u3",
            "doc:d2#viewer@user:u1"]
    rels += [f"doc:x{i}#viewer@user:u{i % 9}" for i in range(50)]
    g_cpu, g = _graphs(WILDCARD, rels)
    q = np.full(64, g.prog.dead_index, np.int32)
    q[:40] = np.arange(40) % g.prog.dead_index
    off, length = g.prog.slot_range("doc", "view")
    kernels.reset_launches()
    got = g.run_lookup_packed_T_device(off, length, q)
    want = g_cpu.run_lookup_packed_T_device(off, length, q)
    assert torch.equal(got[0].cpu(), want[0])
    assert np.array_equal(got[1], want[1])
    assert all(kernels.LAUNCHES[k] for k in
               ("seed_bitplanes", "ell_gather_or", "perm_program",
                "sweep_delta", "lookup_T"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 32])
def test_scatter_rows_matches_its_twin(k):
    """Copy-on-write row scatter on random tables: b from 1 to 4096 dirty
    rows, duplicates with equal values included, `src` never written."""
    _needs_card()
    rng = np.random.default_rng(k)
    r = 50_000 if k == 2 else 6_000
    src = torch.from_numpy(rng.integers(-2**31, 2**31, (r, k), dtype=np.int64)
                           .astype(np.int32)).cuda()
    src0 = src.clone()
    kernels.reset_launches()
    for b in (1, 2, 17, 512, 4096):
        rows = rng.integers(0, r, b).astype(np.int32)
        rows = np.concatenate([rows, rows[: b // 2], np.repeat(rows[-1:], 3)])
        uniq, first = np.unique(rows, return_index=True)
        vals = rng.integers(-2**31, 2**31, (len(rows), k),
                            dtype=np.int64).astype(np.int32)
        vals = vals[first[np.searchsorted(uniq, rows)]]
        t_rows = torch.from_numpy(rows).cuda()
        t_vals = torch.from_numpy(vals).cuda()
        got = kernels.scatter_rows(src, t_rows, t_vals)
        torch.cuda.synchronize()
        assert torch.equal(got, reference.scatter_rows(src, t_rows, t_vals))
        assert torch.equal(src, src0)
    # a row-offset view: for K = 2 it is not 16-byte aligned and takes
    # the scalar copy path
    view = src[1:]
    rows = torch.tensor([0, 5, 5], dtype=torch.int32, device="cuda")
    vals = torch.full((3, k), 7, dtype=torch.int32, device="cuda")
    assert torch.equal(kernels.scatter_rows(view, rows, vals),
                       reference.scatter_rows(view, rows, vals))
    assert kernels.LAUNCHES["scatter_rows"] == 6
