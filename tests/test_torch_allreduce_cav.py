"""The plain-torch twins of the G-way `or_combine` and of `cav_gather_or`,
held on the CPU against a fold of `|` and against the JAX reference's own
Jacobi step.

`or_combine(parts)` must leave every replica equal to the OR of all G
partials, and `parallel.collectives.or_allreduce` must do the same over a
data shard's replicas (through the wrappers, which take the twin for CPU
tensors), past the kernel's 8 replicas a launch too, counting 2 (G - 1)
partials of bytes.  The caveat gather's twin must equal the maybe-plane
update of the reference's `make_ell_step` step (ops/ell.py:528-536) run
eagerly on the CPU, on caveat tables with holes mid-row, all-dead rows,
live sources next to the dead row and, for the mesh's block form, a
`dst_lo` block.  Inputs are seeded numpy words with bit 31 live;
tolerance 0 (int32 words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu.ops import ell as ref_ell
from spicedb_kubeapi_proxy_tpu.ops.graph_compile import GraphProgram
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins
from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives


def _words(rng, shape) -> np.ndarray:
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _fold(parts: list) -> np.ndarray:
    acc = parts[0].copy()
    for p in parts[1:]:
        acc |= p
    return acc


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (4_099, 8)])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_or_combine_twin_is_a_fold_of_or(g, shape):
    rng = np.random.default_rng(g * 100 + shape[0])
    host = [_words(rng, shape) for _ in range(g)]
    assert any((h < 0).any() for h in host) or shape == (1, 1)
    parts = [torch.from_numpy(h.copy()) for h in host]
    kernels.or_combine(parts)
    want = _fold(host)
    assert all(np.array_equal(p.numpy(), want) for p in parts)


def test_or_combine_refuses_an_empty_list():
    with pytest.raises(kernels.KernelError):
        kernels.or_combine([])


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 9, 16])
def test_or_allreduce_is_a_fold_of_or(g):
    """Every replica ends at the OR of all partials, in groups of at most
    MAX_OR_PARTS replicas a combine past 8, and the bytes counted are
    each peer's partial in and the result out to each peer."""
    rng = np.random.default_rng(g)
    host = [_words(rng, (1_001, 4)) for _ in range(g)]
    parts = [torch.from_numpy(h.copy()) for h in host]
    calls = []

    class Spy:
        @staticmethod
        def or_combine(grp):
            assert len(grp) <= kernels.MAX_OR_PARTS
            calls.append(len(grp))
            kernels.or_combine(grp)

    collectives.reset_collectives()
    collectives.or_allreduce(parts, Spy)
    want = _fold(host)
    assert all(np.array_equal(p.numpy(), want) for p in parts)
    step = kernels.MAX_OR_PARTS - 1
    assert calls == [1 + min(step, g - 1 - i) for i in range(0, g - 1, step)]
    c = collectives.COLLECTIVES["or_allreduce"]
    assert c["calls"] == (g > 1)
    assert c["bytes"] == (2 * (g - 1) * 1_001 * 4 * 4 if g > 1 else 0)


def _reference_cav(x: np.ndarray, idx_cav: np.ndarray, half: int) -> np.ndarray:
    """The reference's Jacobi step on a program with no permission op, no
    wildcard and no aux row, from state `x` with an all-zero seed and an
    all-dead main table: what it leaves in the maybe plane is the caveat
    gather's OR, and its definite plane is zero."""
    nt = x.shape[0]
    prog = GraphProgram(state_size=nt, edge_src=np.zeros(0, np.int32),
                        edge_dst=np.zeros(0, np.int32))
    step = ref_ell.make_ell_step(prog, 0, half=half)
    dead = prog.dead_index
    u32 = lambda a: jnp.asarray(a.view(np.uint32))
    out = step(u32(x), u32(np.zeros_like(x)),
               u32(np.full((nt, 8), dead, np.int32)),
               u32(np.zeros((0, 8), np.int32)), u32(idx_cav))
    return np.asarray(out).view(np.int32)


def _cav_table(rng, nt: int, rows: int, k: int, dead: int) -> np.ndarray:
    """[rows, k] caveat rows: live sources scattered mid-row among dead
    slots (the holes a caveated delete leaves), every 7th row all dead,
    and one row of the two live rows around the dead row only."""
    idx = np.full((rows, k), dead, np.int32)
    live = rng.random((rows, k)) < 0.2
    idx[live] = rng.integers(0, nt, int(live.sum()))
    idx[::7] = dead
    idx[3, :3] = [dead - 1, dead, dead - 2]
    return idx


@pytest.mark.parametrize("form", ["full", "block"])
@pytest.mark.parametrize("half", [1, 2, 3, 4, 8, 16])
def test_cav_gather_or_twin_matches_the_reference_step(half, form):
    rng = np.random.default_rng(half * 10 + (form == "block"))
    nt, k = 1_200, 8
    dead = nt - 1
    x = _words(rng, (nt, 2 * half))
    x[dead] = 0                       # the invariant sweep_delta keeps
    x[dead - 1] = _words(rng, 2 * half)
    if form == "full":
        lo, rows = 0, nt
    else:
        lo, rows = 300, 400
    block = _cav_table(rng, nt, rows, k, dead)
    if lo + rows > dead:              # no caveat edge ends at the dead row
        block[dead - lo] = dead
    full = np.full((nt, k), dead, np.int32)
    full[lo: lo + rows] = block
    want = _reference_cav(x, full, half)
    cur = torch.zeros((nt, 2 * half), dtype=torch.int32)
    kernels.cav_gather_or(cur, torch.from_numpy(x), torch.from_numpy(block),
                          half, dst_lo=lo, dead=dead)
    assert np.array_equal(cur.numpy(), want)
    assert not want[:, :half].any() and want[lo: lo + rows, half:].any()
    assert not cur[:lo].any() and not cur[lo + rows:].any()


def test_cav_gather_or_twin_gathers_the_dead_row():
    """The twin does not skip `dead`: a non-zero dead row shows in its
    result, so holding the kernel (which skips it) against the twin also
    checks that the dead row is zero."""
    x = torch.zeros((10, 4), dtype=torch.int32)
    x[9] = torch.tensor([1, 2, -1, 5], dtype=torch.int32)
    idx = torch.full((10, 8), 9, dtype=torch.int32)
    cur = torch.zeros_like(x)
    twins.cav_gather_or(cur, x, idx, 2, dead=9)
    assert torch.equal(cur[:, 2:], x[9, 2:].expand(10, 2))
    assert not cur[:, :2].any()


@pytest.mark.parametrize("k", [3, 9])
def test_cav_gather_or_refuses_a_table_not_k_cav_wide(k):
    """The kernel reads K_CAV = 8 indices a row (two 16-byte loads); the
    wrapper refuses any other width, on the CPU as on a card."""
    assert kernels.K_CAV == ref_ell.K_CAV == 8
    x = torch.zeros((10, 4), dtype=torch.int32)
    with pytest.raises(kernels.KernelError):
        kernels.cav_gather_or(torch.zeros_like(x), x,
                              torch.zeros((10, k), dtype=torch.int32), 2)
