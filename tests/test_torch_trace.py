"""The port's tracer (desco_tpu_torch/utils/trace.py) and its sites.

Off, a span site keeps nothing and reads no clock; on, spans nest by
thread, carry their request's id from the serving stream's producer
thread to the serving thread, and the counters count what the sites
copy. The spans' clock is the one ``torch.profiler`` stamps its events
with: a span around an operation contains the operation's interval. The
``cuda`` test holds a span around a kernel the same way on the card. This
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_trace.py -q -m cuda --noconftest
"""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.data.synthetic import generate_synthetic
from desco_tpu_torch.utils import trace
from desco_tpu_torch.utils.cuda_graphs import GraphedStep

NEIGH, GOSSIP = "release/r4/neigh.best", "release/r4/gossip.best"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch CPU ops on one intra-op thread (as the port's other CPU test
    files hold them, beside the Tier-1 run's test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Tracing on for the test, with nothing left from before; off and
    drained after."""
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


class _NoClock:
    """Stands in for the tracer's ``time`` module: reading it fails."""

    def time_ns(self):
        raise AssertionError("a span site read the clock while off")


def _off_sites(lock):
    with trace.span("a"):
        pass
    with trace.span("b", request=None, batches=3):
        pass
    trace.add("c", 5)
    trace.record("d", 0, 1)
    assert trace.now() is None and trace.new_request() is None
    with trace.lock(lock, "wait"):
        pass


def test_off_keeps_nothing_and_reads_no_clock(monkeypatch):
    trace.disable()
    trace.drain()
    assert trace.span("a") is trace.span("b", x=1)
    lock = threading.RLock()
    assert trace.lock(lock, "wait") is lock
    monkeypatch.setattr(trace, "time", _NoClock())
    _off_sites(lock)
    tracemalloc.start()
    try:
        for _ in range(20000):
            _off_sites(lock)
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current < 1024 and peak < 4096
    assert trace.drain() == ([], {})


def test_spans_nest_and_self_time(traced):
    with trace.span("outer", request=7, k=1) as a:
        with trace.span("mid") as b:
            with trace.span("inner") as c:
                time.sleep(0.002)
        with trace.span("mid") as d:
            pass
    with trace.span("after") as e:
        pass
    trace.add("n", 2)
    trace.add("n", 3)
    spans, counters = trace.drain()
    assert counters == {"n": 5}
    by = {s.id: s for s in spans}
    assert set(by) == {a.id, b.id, c.id, d.id, e.id}
    assert a.parent is None and e.parent is None
    assert b.parent == a.id and d.parent == a.id and c.parent == b.id
    # the request is the outermost span's, inherited inside it
    assert [s.request for s in (a, b, c, d)] == [7] * 4
    assert e.request is None and a.info == {"k": 1}
    assert a.t0 <= b.t0 <= c.t0 < c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1
    assert c.self_ns == c.t1 - c.t0
    assert b.self_ns == (b.t1 - b.t0) - (c.t1 - c.t0)
    assert a.self_ns == (a.t1 - a.t0) - (b.t1 - b.t0) - (d.t1 - d.t0)
    assert trace.drain() == ([], {})


def test_spans_of_other_threads_start_their_own_stack(traced):
    seen = {}

    def work():
        with trace.span("worker") as s:
            seen["span"] = s

    with trace.span("main") as m:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    w = seen["span"]
    assert w.parent is None and w.thread != m.thread
    assert m.thread == threading.get_ident()


def test_timed_lock_and_record(traced):
    lock = threading.RLock()
    with trace.lock(lock, "device_lock.wait"):
        assert lock._is_owned()
    assert not lock._is_owned()
    t0 = trace.now()
    trace.record("request.wait", t0, t0 + 5, request=3)
    spans, _ = trace.drain()
    assert [s.name for s in spans] == ["device_lock.wait", "request.wait"]
    assert spans[1].t1 - spans[1].t0 == 5 and spans[1].request == 3


def test_innermost_picks_the_latest_open_span():
    S = trace.Span
    spans = [S("a", 1, 0, 100, 1, None, None, {}),
             S("b", 1, 10, 40, 2, 1, None, {}),
             S("c", 1, 20, 30, 3, 2, None, {}),
             S("d", 1, 60, 70, 4, 1, None, {}),
             S("x", 2, 0, 200, 5, None, None, {})]
    times = [150, 25, 5, 35, 65, 45, 100]
    got = trace.innermost(spans, times, {1})
    assert [s.name if s else None for s in got] == \
        [None, "c", "a", "b", "d", "a", None]
    assert trace.innermost(spans, [150])[0].name == "x"


def test_h2d_bytes_count_the_fields_copied(traced):
    from desco_tpu_torch.batch.build import query_sample

    gs = generate_synthetic(5, min_size=8, max_size=14, seed=3)
    samples = [query_sample(g) for g in gs]
    for s in samples:
        s.y = np.zeros(3, np.float32)
    batch = pack_samples(samples, *auto_capacities(samples, g_cap=8),
                         n_queries=3)[0]
    batch.to("cpu")
    dropped = ("y", "node_y", "edge_bwd_perm")
    want = sum(v.nbytes for n, v in batch.fields() if n not in dropped)
    assert trace.drain()[1] == {"h2d_bytes": want}
    batch.to("cpu", training=True)
    assert trace.drain()[1] == {
        "h2d_bytes": sum(v.nbytes for _, v in batch.fields())}
    assert want < sum(v.nbytes for _, v in batch.fields())


def test_graphed_step_copy_in_and_replays(traced):
    acc = torch.zeros(4)

    def fn(b):
        acc.add_(b[0].sum() * b[1])

    example = (torch.ones(4, 3), torch.ones(4))
    step = GraphedStep(fn, example, capture=False, state=[acc])
    for i in range(3):
        step((torch.full((4, 3), float(i)), torch.ones(4)))
    spans, counters = trace.drain()
    assert counters == {"replays": 3, "copy_in_bytes": 3 * (48 + 16)}
    names = [s.name for s in spans]
    assert names.count("step.copy_in") == 3
    assert names.count("step.replay") == 3
    copies = [s for s in spans if s.name == "step.copy_in"]
    replays = [s for s in spans if s.name == "step.replay"]
    assert all(c.t1 <= r.t0 for c, r in zip(copies, replays))
    assert torch.equal(acc, torch.full((4,), 3.0 * 12))


def test_chained_step_collectives_name_their_step(traced):
    """Each split point's collective is a ``step.collective`` span inside
    its call's replay, carrying the id of the step that issued it."""
    from desco_tpu_torch.utils import cuda_graphs

    def identity(src, out):
        out.copy_(src)

    acc = torch.zeros(3)

    def fn(b):
        mid = cuda_graphs.collective(("toy", (0,), None), b[0] * 2,
                                     b[0].shape, identity)
        acc.add_(cuda_graphs.collective(("toy2", (0,), None), mid + 1,
                                        mid.shape, identity))

    steps = [GraphedStep(fn, (torch.ones(3),), capture=False, state=[acc])
             for _ in range(2)]
    for step in steps:
        step((torch.ones(3),))
        step((torch.full((3,), 2.0),))
    spans, counters = trace.drain()
    assert counters["replays"] == 4
    coll = [s for s in spans if s.name == "step.collective"]
    assert [s.info["step"] for s in coll] == (
        [id(steps[0])] * 4 + [id(steps[1])] * 4)
    by = {s.id: s for s in spans}
    assert all(by[s.parent].name == "step.replay" for s in coll)
    assert torch.equal(acc, torch.full((3,), 2 * (3.0 + 5.0)))


@pytest.fixture(scope="module")
def service():
    from desco_tpu_torch.serving import CountingService

    return CountingService(NEIGH, GOSSIP, device="cpu")


def _descendants(spans, root):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out, todo = [], [root]
    while todo:
        for k in kids.get(todo.pop().id, ()):
            out.append(k)
            todo.append(k)
    return out


def test_count_stream_spans_carry_their_request(service, traced):
    gs = generate_synthetic(9, min_size=10, max_size=24, seed=5)
    reqs = [gs[i:i + 3] for i in range(0, 9, 3)]
    results = list(service.count_stream(iter(reqs)))
    assert len(results) == 3
    spans, counters = trace.drain()
    assert counters["requests"] == 3 and counters["graphs"] == 9
    main = threading.get_ident()
    prepare = [s for s in spans if s.name == "request.prepare"]
    serve = [s for s in spans if s.name == "request.serve"]
    wait = [s for s in spans if s.name == "request.wait"]
    rids = [s.request for s in prepare]
    assert len(set(rids)) == 3 and None not in rids
    # served in order, each after its preparation and its wait
    assert [s.request for s in serve] == rids
    assert [s.request for s in wait] == rids
    for p, w, s in zip(prepare, wait, serve):
        assert p.thread != main and s.thread == main
        assert w.thread == p.thread
        assert p.t1 <= w.t1 <= s.t0
        for root in (p, s):
            inner = _descendants(spans, root)
            assert inner and {k.request for k in inner} == {p.request}
        names = {k.name for k in _descendants(spans, s)}
        assert {"stage1.stage", "stage1.replay", "stage1.readback",
                "bounds.host", "bounds.stage", "bounds.replay",
                "bounds.readback", "gossip.pack", "gossip.stage",
                "gossip.replay", "gossip.readback", "guards",
                "device_lock.wait", "step.copy_in",
                "step.replay"} <= names
        assert {k.name for k in _descendants(spans, p)} == {
            "prepare.decompose", "prepare.pack"}
    starved = [s for s in spans if s.name == "stream.starved"]
    assert all(s.thread == main for s in starved)
    assert {s.request for s in starved} >= set(rids)


def test_count_gives_its_request_an_id(service, traced):
    gs = generate_synthetic(2, min_size=10, max_size=16, seed=9)
    service.count(gs)
    spans, counters = trace.drain()
    assert counters["requests"] == 1 and counters["graphs"] == 2
    rids = {s.request for s in spans}
    assert len(rids) == 1 and None not in rids


def test_serving_off_reads_no_clock(service, monkeypatch):
    trace.disable()
    trace.drain()
    gs = generate_synthetic(4, min_size=10, max_size=16, seed=9)
    reqs = [gs[:2], gs[2:]]
    want = [service.count(r).graphlet_counts for r in reqs]
    monkeypatch.setattr(trace, "time", _NoClock())
    got = [r.graphlet_counts for r in service.count_stream(iter(reqs))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert trace.drain() == ([], {})


def _events(prof, kind: str):
    return [(ev.name(), ev.start_ns(), ev.end_ns())
            for ev in prof.profiler.kineto_results.events()
            if str(ev.device_type()) == kind
            and not ev.is_user_annotation()]


def test_span_contains_the_profiled_cpu_op(traced):
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("mm") as s:
            torch.mm(a, b)
    ops = [e for e in _events(prof, "DeviceType.CPU") if e[0] == "aten::mm"]
    assert len(ops) == 1
    _, t0, t1 = ops[0]
    assert s.t0 <= t0 <= t1 <= s.t1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device trace of a kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_contains_the_profiled_kernel(cuda_device, traced):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(1024, 1024, device=cuda_device)
    torch.mm(a, a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.span("mm") as s:
            torch.mm(a, a)
            torch.cuda.synchronize()
    kernels = _events(prof, "DeviceType.CUDA")
    assert kernels
    for _, t0, t1 in kernels:
        assert s.t0 <= t0 <= t1 <= s.t1
