"""`utils/cudagraph.Graph`, the port's one CUDA-graph mechanism.

On the CPU a call runs the body eagerly, copies its outputs into `into`,
returns them and counts nothing. On the card the first call captures the
body once after a warm-up that leaves `into` as it was; every call then
replays the graph, returns the same static output tensors, and gives the
body's eager result bit for bit.

The `-m cuda` cases run on the card (`tests/conftest.py` imports jax,
which the card lacks):
    python -m pytest tests/test_torch_cudagraph.py -q -m cuda --noconftest
"""

import pytest
import torch

from orbslam_mapsave_tpu_torch.utils import cudagraph, metrics


@pytest.fixture()
def counters():
    metrics.reset()
    metrics.enable()
    try:
        yield metrics.GLOBAL.counters
    finally:
        metrics.disable()
        metrics.reset()


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _step(device):
    """A body in the shape of local BA's: static inputs `a`, state `s` that
    the body reads and that its outputs are copied back into."""
    g = torch.Generator().manual_seed(7)
    a = torch.randn(64, 64, generator=g).to(device)
    s = (torch.randn(64, generator=g).to(device), torch.zeros((), dtype=torch.int32,
                                                               device=device))

    def fn():
        x, n = s
        y = torch.tanh(a @ x) + torch.sum(a * x[None, :], dim=1) * 1e-3
        return y, n + 1

    return a, s, fn


def _eager_steps(device, k):
    """The state after k eager runs of `_step`'s body."""
    _, s, fn = _step(device)
    for _ in range(k):
        for dst, src in zip(s, fn()):
            dst.copy_(src)
    return s


@pytest.mark.parametrize("calls", [1, 3])
def test_cpu_call_runs_the_body_and_counts_nothing(counters, calls):
    _, s, fn = _step("cpu")
    want = _eager_steps("cpu", calls)
    graph = cudagraph.Graph("test.graph", torch.device("cpu"), fn, into=s)
    for _ in range(calls):
        out = graph()
        # fn's own outputs, which `into` now holds
        assert all(o is not d and torch.equal(o, d) for o, d in zip(out, s))
    assert all(torch.equal(a, b) for a, b in zip(s, want))
    assert int(s[1]) == calls
    assert graph.graph is None and dict(counters) == {}


def test_cpu_call_without_into_returns_fresh_outputs(counters):
    x = torch.arange(6.0)
    graph = cudagraph.Graph("test.graph", torch.device("cpu"), lambda: {"y": x * 2})
    first = graph()
    x += 1  # the static input, written in place by its owner
    second = graph()
    assert torch.equal(first["y"], torch.arange(6.0) * 2)
    assert torch.equal(second["y"], (torch.arange(6.0) + 1) * 2)
    assert dict(counters) == {}


@pytest.mark.cuda
def test_one_capture_then_only_replays(dev, counters):
    _, s, fn = _step(dev)
    graph = cudagraph.Graph("test.graph", dev, fn, into=s)
    for _ in range(5):
        graph()
    torch.cuda.synchronize()
    assert counters == {"test.graph_captures": 1, "test.graph_replays": 5}
    assert int(s[1]) == 5


@pytest.mark.cuda
def test_warm_up_leaves_into_as_it_was(dev):
    _, s, fn = _step(dev)
    before = [x.clone() for x in s]
    graph = cudagraph.Graph("test.graph", dev, fn, into=s)
    graph()  # warm-up, capture, one replay: the state moves by one step
    torch.cuda.synchronize()
    assert int(s[1]) == 1
    want = _eager_steps(dev, 1)
    assert all(torch.equal(a, b) for a, b in zip(s, want))
    assert not torch.equal(s[0], before[0])


@pytest.mark.cuda
def test_outputs_are_the_same_static_tensors(dev):
    _, s, fn = _step(dev)
    graph = cudagraph.Graph("test.graph", dev, fn, into=s)
    first = graph()
    kept = [x.clone() for x in first]
    second = graph()
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(first, second))
    assert not torch.equal(second[1], kept[1])  # overwritten by the replay


@pytest.mark.cuda
def test_replay_is_bit_identical_to_eager(dev):
    _, s, fn = _step(dev)
    graph = cudagraph.Graph("test.graph", dev, fn, into=s)
    for _ in range(4):
        graph()
    want = _eager_steps(dev, 4)
    torch.cuda.synchronize()
    for a, b in zip(s, want):
        assert torch.equal(a, b)
