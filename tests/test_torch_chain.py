"""A compiled step split at its collectives (utils/cuda_graphs.GraphedStep
with ``collective`` split points), in one process on the CPU, on a toy
step whose "collective" is the identity: forward and backward reach a
split point, as a halo step's exchanges do across ranks.

On the CPU the chain runs without a capture, through the same split
points: the first call records them and makes their receive buffers,
every later call must issue the same ones and writes the same buffers;
a collective that is not a split point raises inside the step. The
steps are held bit for bit against the same step run eagerly."""

import pytest
import torch

from desco_tpu_torch.utils import cuda_graphs as graphed
from desco_tpu_torch.utils import distributed


def identity(src, out):
    out.copy_(src)


class Relay(torch.autograd.Function):
    """The identity through a split point, forward and backward."""

    @staticmethod
    def forward(ctx, x):
        return graphed.collective(("toy", (0,), None), x.detach(), x.shape,
                                  identity)

    @staticmethod
    def backward(ctx, grad):
        return graphed.collective(("toy_bwd", (0,), None), grad, grad.shape,
                                  identity)


def toy_step(w):
    """A train step on ``w`` [4, 3] in place: loss = sum(relay(tanh(x w))^2),
    one plain gradient step; returns the loss."""

    def step(b):
        leaf = w.detach().requires_grad_()
        y = Relay.apply(torch.tanh(b[0] @ leaf))
        loss = (y * y).sum()
        (grad,) = torch.autograd.grad(loss, leaf)
        w.sub_(0.1 * grad)
        return loss.detach()

    return step


def inputs(seed: int) -> torch.Tensor:
    return torch.randn(5, 4, generator=torch.Generator().manual_seed(seed))


def test_chained_toy_step_equals_eager():
    """Three calls of the chained step (split at the relay forward and
    its backward) against the same step eagerly: losses and weights bit
    for bit; the split points recorded once, their buffers kept."""
    w0 = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))
    w_eager, w_chain = w0.clone(), w0.clone()
    eager = toy_step(w_eager)
    step = graphed.GraphedStep(toy_step(w_chain), (inputs(0),),
                               capture=False, state=[w_chain])
    assert step.sequence is None and not step.graphs
    ptrs = None
    for seed in (2, 3, 4):
        want = eager((inputs(seed),))
        got = step((inputs(seed),))
        assert torch.equal(got, want)
        assert torch.equal(w_chain, w_eager)
        assert [k[0] for k in step.sequence] == ["toy", "toy_bwd"]
        now = [b.data_ptr() for b in step.buffers]
        assert ptrs is None or now == ptrs
        ptrs = now
    assert step.sequence[0][3:] == ((5, 3), "torch.float32", (5, 3))


def test_chained_step_raises_on_a_changed_sequence():
    """A call that issues another collective than the first call did
    (more, fewer, or another shape) raises before running it; the step
    then runs on as before."""
    n = {"relays": 2, "rows": 5}

    def body(b):
        x = b[0][:n["rows"]]
        for _ in range(n["relays"]):
            x = graphed.collective(("toy", (0,), None), x, x.shape,
                                   identity) + 1.0
        return x

    step = graphed.GraphedStep(body, (inputs(0),), capture=False)
    first = step((inputs(5),))
    assert torch.equal(first, (inputs(5) + 1.0) + 1.0)
    for change, match in (({"relays": 3}, "collective 2 of this call"),
                          ({"relays": 1}, "issued 1 collectives, the "
                                          "first 2"),
                          ({"rows": 4}, "collective 0 of this call")):
        n.update({"relays": 2, "rows": 5}, **change)
        with pytest.raises(RuntimeError, match=match):
            step((inputs(5),))
    n.update(relays=2, rows=5)
    assert torch.equal(step((inputs(5),)), first)


@pytest.mark.parametrize("stray", ["barrier", "check", "direct"])
def test_chained_step_raises_on_a_collective_off_its_split_points(stray):
    """Inside a chained step a collective that is not a split point (a
    barrier, the parameters' check, or any code that declares one)
    raises; outside it runs."""
    calls = {
        "barrier": distributed.barrier,
        "check": lambda: distributed.check_replicated(torch.ones(2),
                                                      "parameters"),
        "direct": lambda: graphed.unrecorded_collective("a broadcast")}

    def body(b):
        calls[stray]()
        return b[0] * 2.0

    step = graphed.GraphedStep(body, (torch.ones(3),), capture=False)
    with pytest.raises(RuntimeError, match="reached inside a chained "
                                           "step's piece"):
        step((torch.ones(3),))
    calls[stray]()  # outside a step it runs


def test_collective_outside_a_chain_runs_on_a_new_buffer():
    """Outside a chained step a split point runs its collective on a new
    receive buffer, every call."""
    x = inputs(6)
    a = graphed.collective(("toy", (0,), None), x, x.shape, identity)
    b = graphed.collective(("toy", (0,), None), x, x.shape, identity)
    assert torch.equal(a, x) and torch.equal(b, x)
    assert a.data_ptr() not in (b.data_ptr(), x.data_ptr())


def test_a_chained_step_does_not_nest():
    """A chained step called inside another's function raises: one chain
    runs at a time."""
    inner = graphed.GraphedStep(lambda b: b[0] + 1.0, (torch.ones(2),),
                                capture=False)
    outer = graphed.GraphedStep(lambda b: inner(b), (torch.ones(2),),
                                capture=False)
    with pytest.raises(RuntimeError, match="runs inside another"):
        outer((torch.ones(2),))
    assert torch.equal(inner((torch.ones(2),)), torch.full((2,), 2.0))
