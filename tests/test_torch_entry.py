"""The port's entry points (spicedb_kubeapi_proxy_tpu_torch/entry.py)
held against the repository's `__graft_entry__.py` on the CPU.

`entry()`'s `fn` on `device="cpu"` (the segment kernel's plain twins)
gives the reference `fn`'s output, run under JAX on the CPU, value for
value; its graph is the reference's tuple for tuple; `dryrun_multichip`
runs its sharded kernels and a mesh endpoint with a delta on co-located
CPU shards, each held against the oracle.  Without a card the default
device raises rather than falling back to the CPU.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from spicedb_kubeapi_proxy_tpu_torch import entry
from spicedb_kubeapi_proxy_tpu_torch.device import DeviceUnavailableError


def test_demo_graph_is_the_reference_graph():
    prog, _, store = entry._build_program()
    ref_prog, _, ref_store = ref_entry._build_program()
    assert ({r.rel_string() for r in store.read(None)}
            == {r.rel_string() for r in ref_store.read(None)})
    assert prog.state_size == ref_prog.state_size
    assert prog.slot_range("pod", "view") == ref_prog.slot_range("pod",
                                                                "view")
    assert entry._DEMO_SCHEMA == ref_entry._DEMO_SCHEMA


def test_entry_fn_matches_the_reference():
    import jax

    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    ref_fn, ref_args = ref_entry.entry()
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a second call reuses the arena and answers the same
    np.testing.assert_array_equal(fn(*args).numpy(), want)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_shards(n):
    out = entry.dryrun_multichip(n, device="cpu")
    assert out["mesh"]["data"] * out["mesh"]["graph"] == n
    assert out["devices"] == ["cpu"] * n
    assert out["allowed_bits"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_entry_defaults_to_the_card():
    with pytest.raises(DeviceUnavailableError):
        entry.entry()
    with pytest.raises(DeviceUnavailableError):
        entry.dryrun_multichip(4)

