"""The plain-torch twins of `edge_or` and `word_cols_T`, and the `dead`
argument of the `edge_or` wrapper, held on the CPU against the JAX
reference's own functions.

`edge_or`'s twin must equal the edge pass of the reference's segment
step (`ops/spmv.py` `make_step`: `segment_sum(x[edge_src], edge_dst) > 0`
on float32 lanes, then `max` with the seed), packed into int32 words, on
sorted, unsorted, long-run and all-dead edge arrays.  Edges from the dead
row change nothing while that row is zero, which is the invariant the
kernel's skipping of them rests on; the twin gathers them all, so a
non-zero dead row shows.  `word_cols_T`'s twin must equal the reference's
plane word-column reads (`jax_endpoint.py`: `np.asarray(plane[:rows,
w])` for each word `w`).  The wrapper checks its shapes and `dead` on
every device, so bad arguments raise `KernelError` here too.  Inputs are
seeded numpy words with bit 31 live; tolerance 0 (int32 words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu.ops import spmv as ref_spmv
from spicedb_kubeapi_proxy_tpu.ops.graph_compile import GraphProgram
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops import spmv as port_spmv
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins

N = 900                 # state rows; the last one is the dead row
DEAD = N - 1


def _words(rng, shape) -> np.ndarray:
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _lanes(packed: np.ndarray) -> np.ndarray:
    """int32 [N, W] words -> float32 [N, 32 W] lanes, lane 32 w + b = bit
    b of word w."""
    bits = (packed.view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(packed.shape[0], -1).astype(np.float32)


def _pack(lanes: np.ndarray) -> np.ndarray:
    n, b = lanes.shape
    bits = (lanes.reshape(n, b // 32, 32) > 0).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(axis=2) \
        .astype(np.uint32).view(np.int32)


def _reference_edge_pass(x: np.ndarray, y: np.ndarray, src: np.ndarray,
                         dst: np.ndarray, sorted_: bool) -> np.ndarray:
    """The reference segment step on a program with no permission op and
    no wildcard, its seed `y`: (segment_sum(x[src], dst) > 0) | y, the dead
    row zeroed, packed back into words."""
    prog = GraphProgram(state_size=x.shape[0], edge_src=src, edge_dst=dst)
    step = ref_spmv.make_step(prog, indices_sorted=sorted_)
    out = step(jnp.asarray(_lanes(x)), jnp.asarray(_lanes(y)),
               jnp.asarray(src), jnp.asarray(dst))
    return _pack(np.asarray(out))


def _edges(kind: str, rng) -> tuple:
    """(src, dst, sorted) of one edge layout; padding is (dead, dead) and
    no live edge ends at the dead row."""
    if kind == "sorted":
        e = 3_000
        dst = np.sort(rng.integers(0, DEAD, e)).astype(np.int32)
        src = rng.integers(0, N, e).astype(np.int32)
        src[::4] = DEAD                     # dead sources inside live runs
        pad = np.full(e, DEAD, np.int32)    # capacity twice the edges
        return np.concatenate([src, pad]), np.concatenate([dst, pad]), True
    if kind == "unsorted":                  # inserts in free positions
        src, dst, _ = _edges("sorted", rng)
        tail = slice(len(src) - 400, len(src))
        src[tail] = rng.integers(0, DEAD, 400)
        dst[tail] = rng.integers(0, DEAD, 400)
        return src, dst, False
    if kind == "long_runs":                 # runs of 1 to 4,097 edges
        dst = np.concatenate([np.full(k, i, np.int32) for i, k in
                              enumerate([1, 31, 33, 4_097, 2, 129])])
        src = rng.integers(0, N, dst.size).astype(np.int32)
        return src, dst, True
    assert kind == "all_dead"
    return np.full(2_048, DEAD, np.int32), np.full(2_048, DEAD, np.int32), True


@pytest.mark.parametrize("w", [1, 3, 8])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "long_runs",
                                  "all_dead"])
def test_edge_or_twin_matches_the_reference_step(kind, w):
    rng = np.random.default_rng(w * 7 + len(kind))
    x = _words(rng, (N, w))
    x[DEAD] = 0                       # the invariant sweep_delta keeps
    y = _words(rng, (N, w))
    y[DEAD] = 0
    src, dst, sorted_ = _edges(kind, rng)
    want = _reference_edge_pass(x, y, src, dst, sorted_)
    got = torch.from_numpy(y.copy())
    kernels.edge_or(got, torch.from_numpy(x), torch.from_numpy(src),
                    torch.from_numpy(dst), dead=DEAD)
    assert np.array_equal(got.numpy(), want)
    assert (kind == "all_dead") == np.array_equal(want, y)
    if w > 1:
        assert (got.numpy() < 0).any()


@pytest.mark.parametrize("w", [1, 2, 8])
def test_edge_or_dead_edges_change_nothing(w):
    """Edges whose source is the dead row, to any destination, add nothing
    while that row is zero: the kernel may skip them."""
    rng = np.random.default_rng(100 + w)
    x = _words(rng, (N, w))
    x[DEAD] = 0
    y = _words(rng, (N, w))
    src, dst, _ = _edges("sorted", rng)
    extra_dst = rng.integers(0, N, 500).astype(np.int32)
    src2 = np.concatenate([src, np.full(500, DEAD, np.int32)])
    dst2 = np.concatenate([dst, extra_dst])
    a, b = torch.from_numpy(y.copy()), torch.from_numpy(y.copy())
    twins.edge_or(a, torch.from_numpy(x), torch.from_numpy(src),
                  torch.from_numpy(dst))
    twins.edge_or(b, torch.from_numpy(x), torch.from_numpy(src2),
                  torch.from_numpy(dst2), dead=DEAD)
    assert torch.equal(a, b)


def test_edge_or_twin_gathers_the_dead_row():
    """The twin does not skip `dead`: a non-zero dead row shows in its
    result, so holding the kernel (which skips it) against the twin also
    checks that the dead row is zero."""
    x = torch.zeros((10, 3), dtype=torch.int32)
    x[9] = torch.tensor([1, -1, 4], dtype=torch.int32)
    y = torch.zeros_like(x)
    src = torch.full((5,), 9, dtype=torch.int32)
    dst = torch.tensor([0, 0, 2, 3, 9], dtype=torch.int32)
    twins.edge_or(y, x, src, dst, dead=9)
    for r in (0, 2, 3, 9):
        assert torch.equal(y[r], x[9])
    assert not y[1].any()


def _bad_call(which: str):
    x = torch.zeros((10, 2), dtype=torch.int32)
    y = torch.zeros_like(x)
    e = torch.zeros(4, dtype=torch.int32)
    return {
        "dead_past_the_rows": lambda: kernels.edge_or(y, x, e, e, dead=10),
        "dead_negative": lambda: kernels.edge_or(y, x, e, e, dead=-1),
        "dead_not_an_integer": lambda: kernels.edge_or(y, x, e, e, dead=1.5),
        "y_is_x": lambda: kernels.edge_or(x, x, e, e),
        "shapes_differ": lambda: kernels.edge_or(
            torch.zeros((10, 3), dtype=torch.int32), x, e, e),
        "edge_lengths_differ": lambda: kernels.edge_or(
            y, x, e, torch.zeros(5, dtype=torch.int32)),
        "edges_not_1d": lambda: kernels.edge_or(
            y, x, e.view(2, 2), e.view(2, 2)),
    }[which]


@pytest.mark.parametrize("which", ["dead_past_the_rows", "dead_negative",
                                   "dead_not_an_integer", "y_is_x",
                                   "shapes_differ", "edge_lengths_differ",
                                   "edges_not_1d"])
def test_edge_or_wrapper_refuses_on_the_cpu(which):
    with pytest.raises(kernels.KernelError):
        _bad_call(which)()


def test_edge_or_wrapper_takes_a_numpy_integer_dead_row():
    x = torch.ones((4, 1), dtype=torch.int32)
    x[3] = 0
    y = torch.zeros_like(x)
    e = torch.tensor([0, 3], dtype=torch.int32)
    kernels.edge_or(y, x, e, torch.tensor([1, 2], dtype=torch.int32),
                    dead=np.int64(3))
    assert y.flatten().tolist() == [0, 1, 0, 0]


def test_segment_sweep_passes_the_dead_row_to_edge_or():
    """`KernelCache.sweep_steps` names the program's dead row in its
    edge step, and `run_step` hands it to `edge_or`."""
    prog = port_spmv.GraphProgram(state_size=6,
                                  edge_src=np.array([0, 1], np.int32),
                                  edge_dst=np.array([2, 3], np.int32))
    kc = port_spmv.KernelCache(prog, "cpu")
    src, dst = port_spmv.pad_edges(prog, 4)
    steps = list(kc.sweep_steps(torch.from_numpy(src),
                                torch.from_numpy(dst)))
    (edge,) = [s for s in steps if s[0] == "edge_or"]
    assert edge[3] == prog.dead_index == 5
    seen = []

    class Spy:
        @staticmethod
        def edge_or(y, x, s, d, dead=None):
            seen.append(dead)
            twins.edge_or(y, x, s, d, dead)

    x = torch.zeros((6, 1), dtype=torch.int32)
    x[0, 0] = 1
    y = torch.zeros_like(x)
    kc.run_step(edge, y, x, x, None, Spy)
    assert seen == [5] and y[2, 0] == 1 and not y[3].any()


@pytest.mark.parametrize("wc", [63, 64, 65])
@pytest.mark.parametrize("words", ["one", "seven", "all", "repeated"])
def test_word_cols_T_twin_matches_the_reference_reads(words, wc):
    """out[k] equals the reference's read of plane word column words[k]
    over the plane's first `rows` rows."""
    rng = np.random.default_rng(wc + len(words))
    rows = 1_013
    plane = _words(rng, (rows + 9, wc))
    ws = {"one": [wc - 1], "seven": list(range(3, 10)),
          "all": list(range(wc)),
          "repeated": [0, 5, 5, wc - 1, 0, 17, 17, 17]}[words]
    ref_plane = jnp.asarray(plane.view(np.uint32))
    want = np.stack([np.asarray(ref_plane[:rows, w]) for w in ws]) \
        .view(np.int32)
    got = kernels.word_cols_T(torch.from_numpy(plane), rows,
                              torch.tensor(ws, dtype=torch.int32))
    assert got.is_contiguous() and tuple(got.shape) == (len(ws), rows)
    assert np.array_equal(got.numpy(), want)


def test_word_cols_T_refuses_more_rows_than_the_plane():
    plane = torch.zeros((5, 3), dtype=torch.int32)
    words = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(kernels.KernelError):
        kernels.word_cols_T(plane, 6, words)
