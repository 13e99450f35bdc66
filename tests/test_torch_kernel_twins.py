"""The plain-torch twins of `lookup_T` and `scatter_rows` held against the
JAX reference's own operations, on the CPU, at the CUDA kernels' edge
shapes.

`reference.lookup_T` against `jax.lax.dynamic_slice(...).T` as the
reference's `run_lookup` computes it (ops/ell.py, both the definite and
the plane form), and `reference.scatter_rows` against `.at[rows].set` as
`_EllGraph.flush` runs it (jax_endpoint.py, rows padded by the
reference's own `pad_scatter`).  The shapes are those the card tests put
to the kernels: 1, 2, 8 and 32 words, row strides of one and two planes,
odd offsets, lengths around a tile; 1-, 2- and 32-word table rows,
empty, single and long row lists, duplicates, rows past the table.
Inputs come from numpy generators with fixed seeds; tolerance 0 (int32
words).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu.ops.spmv import pad_scatter
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins


def _lookup_tile(words: int) -> int:
    """Rows of one lookup_T tile (the launcher's arithmetic, ell_kernels.cu
    ell_lookup_T): the largest power of two with tile * words <= 2048,
    within [32, 1024]."""
    t = 1
    while 2 * t * words <= 2048:
        t *= 2
    return min(max(t, 32), 1024)


def _words(rng, shape) -> np.ndarray:
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("length", ["1", "3", "tile-1", "tile+1", "200003"])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("words", [1, 2, 8, 32])
def test_lookup_T_twin_matches_the_reference_slice(words, planes, length):
    tile = _lookup_tile(words)
    n = {"1": 1, "3": 3, "tile-1": tile - 1, "tile+1": tile + 1,
         "200003": 200_003}[length]
    offset = 3                        # odd: the rows start off 16 bytes
    rng = np.random.default_rng(words * 10 + planes)
    stride = 2 * words if planes else words
    x = _words(rng, (offset + n + 2, stride))
    got = twins.lookup_T(torch.from_numpy(x), offset, n,
                         words if planes else None)
    xj = jnp.asarray(x)
    if planes:
        want = jax.lax.dynamic_slice(xj, (offset, 0), (n, words)).T
    else:
        want = jax.lax.dynamic_slice_in_dim(xj, offset, n, axis=0).T
    assert got.shape == (words, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("b", [0, 1, 257, 5000])
@pytest.mark.parametrize("k", [1, 2, 32])
def test_scatter_rows_twin_matches_the_reference_scatter(k, b, misaligned):
    """Unsorted rows with duplicates (equal values, as pad_scatter pads)
    and rows at and past R, which the reference's scatter drops; `src`
    a view at a one-word offset when `misaligned`, left unchanged."""
    r = 12_347
    rng = np.random.default_rng(k * 1000 + b)
    flat = _words(rng, 1 + r * k)
    src_np = flat[int(misaligned): int(misaligned) + r * k].reshape(r, k)
    rows = rng.integers(0, r, b).astype(np.int32)
    if b > 1:
        rows[: b // 8] = rows[b // 2: b // 2 + b // 8]     # duplicates
        rows[-3:] = [r, r + 5, 2**31 - 1][: min(3, b)]     # past the table
    vals = _words(rng, (b, k))
    uniq, first = np.unique(rows, return_index=True)
    vals = vals[first[np.searchsorted(uniq, rows)]]        # equal per row
    if b:
        rows, vals = pad_scatter(rows, vals)
    src = torch.from_numpy(flat)[int(misaligned):][: r * k].view(r, k)
    src0 = src.clone()
    got = twins.scatter_rows(src, torch.from_numpy(rows),
                             torch.from_numpy(vals.reshape(-1, k)))
    want = jnp.asarray(src_np).at[jnp.asarray(rows)].set(
        jnp.asarray(vals.reshape(-1, k)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(src, src0)


def test_scatter_rows_twin_skips_negative_rows():
    """Negative rows are skipped (the port's contract; the reference's
    `.at[]` would wrap them, and its flush never produces one): the
    result equals the reference's scatter of the other rows."""
    rng = np.random.default_rng(7)
    src = _words(rng, (100, 2))
    rows = np.array([5, -1, 99, -100, 5], np.int32)
    vals = _words(rng, (5, 2))
    vals[4] = vals[0]
    got = twins.scatter_rows(torch.from_numpy(src), torch.from_numpy(rows),
                             torch.from_numpy(vals))
    keep = rows >= 0
    want = jnp.asarray(src).at[jnp.asarray(rows[keep])].set(
        jnp.asarray(vals[keep]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
