"""`kernels.LaunchGraph.capture` pauses Python's cyclic collector while a
capture is open.

A collection that runs on the capturing thread can free a dead graph
(`cudaGraphExecDestroy`), which CUDA refuses during a capture and
answers by invalidating it: a fuzz campaign of many short-lived
`torch://` endpoints on the card failed that way until the pause.  The
card leg (`tests/test_torch_kernels_cuda.py::
test_capture_survives_a_collection_of_dead_graphs`) reproduces the
failure itself; here, on the CPU, the pause's bookkeeping: nested and
concurrent captures, the collector's prior state restored, and the
capture's function run with the collector off (the CUDA pieces of the
capture replaced by stand-ins that record what they saw).
"""

import contextlib
import gc
import threading

import pytest
import torch

from spicedb_kubeapi_proxy_tpu_torch.ops import kernels


@pytest.fixture
def collector_on():
    was = gc.isenabled()
    gc.enable()
    yield
    (gc.enable if was else gc.disable)()


def test_pause_nests_and_restores_the_prior_state(collector_on):
    with kernels._collector_paused():
        assert not gc.isenabled()
        with kernels._collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    with kernels._collector_paused():
        assert not gc.isenabled()
    assert not gc.isenabled()     # off before: left off


def test_pause_holds_until_the_last_thread_closes_its_capture(collector_on):
    opened, release, done = (threading.Event() for _ in range(3))

    def capture_on_a_thread():
        with kernels._collector_paused():
            opened.set()
            release.wait(10)
        done.set()

    t = threading.Thread(target=capture_on_a_thread)
    t.start()
    try:
        assert opened.wait(10)
        with kernels._collector_paused():
            assert not gc.isenabled()
        # the other thread's capture is still open
        assert not gc.isenabled()
    finally:
        release.set()
        t.join(10)
    assert done.is_set() and not t.is_alive()
    assert gc.isenabled()


class _FakeGraph:
    seen: list = []

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.seen.append(("begin", gc.isenabled(), capture_error_mode))

    def capture_end(self):
        self.seen.append(("end", gc.isenabled()))


class _FakeEvent:
    def __init__(self, **kw):
        pass

    def record(self, stream=None):
        pass


def test_capture_runs_its_function_with_the_collector_paused(
        collector_on, monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    _FakeGraph.seen = []
    g = kernels.LaunchGraph("cuda")
    assert g.capture(lambda: gc.isenabled()) is False
    assert _FakeGraph.seen == [("begin", False, "thread_local"),
                               ("end", False)]
    assert gc.isenabled()

    def boom():
        raise RuntimeError("a launch failed during the capture")

    with pytest.raises(RuntimeError):
        kernels.LaunchGraph("cuda").capture(boom)
    assert gc.isenabled()
