"""The port's spans (utils/profiling.py `span`) inside the SAGA epoch, the
benchmark's readers of them, and fit()'s operator accounting, on the CPU.

  * with no profile running a span site costs one
    `torch.autograd._profiler_enabled()` check: no `record_function` is
    entered and nothing is recorded, through a whole epoch too;
  * under torch.profiler a span keeps its name, its parent's name and the
    epoch (its own or its parent's), and starts within 1 ms of the
    profile's event of the same name; the buffer stops at MAX_SPANS;
  * an epoch of `_make_epoch` under the profiler records one
    `sgdnet.epoch`, a `sgdnet.step` a block with its phases (K2's step:
    tail_forward, head, tail_outer, finish; the plain step: finish) and
    a `sgdnet.refresh` exactly on the refresh cadence's epochs; its state
    has the same bits as with the profiler off;
  * perfbench's readers `epoch_host_ms`, `refresh_ms` and their
    `.multiclass` twins give None outside an epochs loop and without
    records, and the exact value on synthetic records;
  * `fit().stats["epochs_by_attempt"]` is the epochs the path drew block
    orders for (perfbench/adapter.py's count), every attempt included,
    and `stats["host_syncs"]` the reads fit_path makes.
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import sgdnet_tpu_torch as tst
from perfbench import adapter, manifest
from perfbench.data import zipf_sparse
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import saga
from sgdnet_tpu_torch.utils import profiling
from sgdnet_tpu_torch.utils.profiling import SpanRecord

torch.set_num_threads(1)

PHASES = ("sgdnet.step.tail_forward", "sgdnet.step.head", "sgdnet.step.tail_outer", "sgdnet.step.finish")
READERS = ("epoch_host_ms", "epoch_host_ms.multiclass", "refresh_ms", "refresh_ms.multiclass")


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@contextlib.contextmanager
def _profiled():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def _k2_epoch(every=2, n=1024, p=300, B=128, seed=3):
    """The benchmark's epoch (perfbench/adapter.py: K2's step over a bf16
    head, the BlockCOO tail, block sampling) on a tiny design."""
    xd, y = zipf_sparse.padded_design(n, p, 10, seed)
    layout = dict(batch_size=B, head_dtype="bfloat16", max_head=64, coverage=0.9, g_sum_refresh_every=every,
                  intercept_decay=0.01)
    solver = dict(family="binomial", alpha=1.0, gamma=0.01, **{"lambda": 1e-3}, intercept_decay=0.01)
    prog = adapter.Epochs(zipf_sparse.to_csr(xd), y[:, 0], 1, layout, solver, torch.device("cpu"))
    orders = [torch.randperm(prog.n_blocks, generator=torch.Generator().manual_seed(seed + e)) for e in range(4)]
    return prog, orders


def _plain_epoch(every=3, n=96, p=6, B=16):
    """`_make_epoch` with the plain step on a dense design."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(n, p)))
    y = torch.as_tensor(rng.normal(size=(n, 1)))
    fam, pen = get_family("gaussian"), select_penalty(1.0, "gaussian")
    config = saga.SolverConfig(batch_size=B, sampling="block", g_sum_refresh_every=every)
    epoch = saga._make_epoch(x, y, torch.ones(n, dtype=x.dtype), float(n), fam, pen, config)
    state0 = saga.init_state(n, p, 1, x.dtype)
    return epoch, state0, n // B


def _run(prog, orders, state=None):
    state = prog.init_state() if state is None else state
    for i, order in enumerate(orders):
        state = prog.epoch(state, order, i)
    return state


# ---------------------------------------------------------------------------
# the span helper
# ---------------------------------------------------------------------------


def test_off_a_span_is_one_check_and_records_nothing(monkeypatch):
    entered, checks = [], []
    real_check = torch.autograd._profiler_enabled

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def check():
        checks.append(1)
        return real_check()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", check)
    assert profiling.span("a") is profiling.span("b", epoch=1, device=torch.device("cpu"))
    with profiling.span("a", epoch=0):
        with profiling.span("b"):
            pass
    assert len(checks) == 4
    prog, orders = _k2_epoch()
    checks.clear()
    _run(prog, orders)
    # an epoch's span sites: the epoch, a step and its four phases a block,
    # the refresh on epochs 1 and 3 of refresh every 2
    assert len(checks) == 4 * (1 + 5 * prog.n_blocks) + 2
    assert entered == [] and profiling.span_records() == []


def test_names_parents_nesting_and_the_epoch():
    with _profiled():
        with profiling.span("a", epoch=7):
            with profiling.span("b"):
                with profiling.span("c", epoch=8):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    recs = profiling.span_records()
    assert [(r.name, r.parent, r.epoch) for r in recs] == [
        ("a", None, 7), ("b", "a", 7), ("c", "b", 8), ("d", "a", 7), ("e", None, None)]
    a, b, c, d, e = recs
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns <= d.end_ns <= a.end_ns
    assert a.end_ns <= e.start_ns
    assert all(r.device_ms is None for r in recs)  # no CUDA device given
    profiling.reset_spans()
    assert profiling.span_records() == []


def test_a_record_starts_with_the_profiles_event():
    with _profiled() as prof:
        for i in range(5):
            with profiling.span(f"sgdnet.test{i}"):
                torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("sgdnet.test")}
    recs = profiling.span_records()
    assert len(recs) == 5
    for r in recs:
        assert abs(events[r.name].start_ns() - r.start_ns) < 1_000_000, r.name


def test_the_buffer_stops_at_its_cap(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with _profiled() as prof:
        for i in range(8):
            with profiling.span(f"s{i}"):
                pass
    assert [r.name for r in profiling.span_records()] == [f"s{i}" for i in range(5)]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {f"s{i}" for i in range(8)} <= names  # the profile still sees every span


# ---------------------------------------------------------------------------
# the epoch's spans
# ---------------------------------------------------------------------------


def _check_epoch_spans(recs, n_epochs, n_blocks, every, phases):
    assert [r.epoch for r in recs if r.name == "sgdnet.epoch"] == list(range(n_epochs))
    for it in range(n_epochs):
        mine = [r for r in recs if r.epoch == it]
        assert mine[0].name == "sgdnet.epoch" and mine[0].parent is None
        steps = [j for j, r in enumerate(mine) if r.name == "sgdnet.step"]
        assert len(steps) == n_blocks
        for j in steps:
            assert mine[j].parent == "sgdnet.epoch"
            kids = mine[j + 1 : j + 1 + len(phases)]
            assert [r.name for r in kids] == list(phases)
            assert all(r.parent == "sgdnet.step" and mine[j].start_ns <= r.start_ns <= r.end_ns <= mine[j].end_ns
                       for r in kids)
        refresh = [r for r in mine if r.name == "sgdnet.refresh"]
        assert len(refresh) == ((it + 1) % every == 0)
        assert all(r.parent == "sgdnet.epoch" and r.start_ns >= mine[steps[-1]].end_ns for r in refresh)
        assert len(mine) == 1 + n_blocks * (1 + len(phases)) + len(refresh)


def test_a_k2_epoch_records_its_layers_and_keeps_its_bits():
    prog, orders = _k2_epoch(every=2)
    off = _run(prog, orders)
    with _profiled():
        on = _run(prog, orders)
    _check_epoch_spans(profiling.span_records(), len(orders), prog.n_blocks, 2, PHASES)
    for name in saga.SagaState._fields:
        assert torch.equal(getattr(off, name), getattr(on, name)), name


def test_a_plain_step_epoch_records_its_layers_and_keeps_its_bits():
    epoch, state0, n_blocks = _plain_epoch(every=3)
    orders = [torch.randperm(n_blocks, generator=torch.Generator().manual_seed(e)) for e in range(6)]

    def run():
        s = state0
        for i, o in enumerate(orders):
            s = epoch(s, o, 0.01, 0.05, 0.0, it=i)
        return s

    off = run()
    with _profiled():
        on = run()
    _check_epoch_spans(profiling.span_records(), len(orders), n_blocks, 3, ("sgdnet.step.finish",))
    for name in saga.SagaState._fields:
        assert torch.equal(getattr(off, name), getattr(on, name)), name


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------


def _rec(name, parent, epoch, start_ms, end_ms, device_ms=None):
    return SpanRecord(name, parent, epoch, int(start_ms * 1e6), int(end_ms * 1e6), device_ms)


SYNTHETIC = [
    _rec("sgdnet.epoch", None, 4, 0, 40),
    _rec("sgdnet.step", "sgdnet.epoch", 4, 1, 2),
    _rec("sgdnet.epoch", None, 5, 50, 110),
    _rec("sgdnet.refresh", "sgdnet.epoch", 5, 90, 105, 31.5),  # 60 - 15 = 45
    _rec("sgdnet.epoch", None, 6, 120, 150),
    _rec("sgdnet.epoch", None, 7, 160, 230),
    _rec("sgdnet.refresh", "sgdnet.epoch", 7, 200, 228, 36.5),  # 70 - 28 = 42
    _rec("sgdnet.refresh", None, None, 300, 310, 99.0),  # outside an epoch: no epoch's
]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_outside_an_epochs_loop_or_without_records(name, monkeypatch):
    read = manifest.reader(name)
    monkeypatch.setattr(profiling, "span_records", lambda: SYNTHETIC)
    assert read({"kind": "fits", "fits": [{}]}) is None
    assert read({}) is None
    monkeypatch.setattr(profiling, "span_records", lambda: [])
    assert read({"kind": "epochs", "epochs": 12}) is None
    monkeypatch.delattr(profiling, "span_records")  # a port that records no spans
    assert read({"kind": "epochs", "epochs": 12}) is None


@pytest.mark.parametrize("name, value", [("epoch_host_ms", 41.0), ("epoch_host_ms.multiclass", 41.0),
                                         ("refresh_ms", (31.5 + 36.5 + 99.0) / 3),
                                         ("refresh_ms.multiclass", (31.5 + 36.5 + 99.0) / 3)])
def test_a_reader_reads_synthetic_records_exactly(name, value, monkeypatch):
    monkeypatch.setattr(profiling, "span_records", lambda: SYNTHETIC)
    # epochs 40, 45 (60 less its refresh's 15), 30, 42 (70 less 28): median 41
    assert manifest.reader(name)({"kind": "epochs", "epochs": 4}) == pytest.approx(value, rel=1e-12)


def test_the_readers_read_an_epochs_records():
    prog, orders = _k2_epoch(every=2)
    with _profiled():
        _run(prog, orders)
    recs = profiling.span_records()
    ctx = {"kind": "epochs", "epochs": len(orders)}
    host = manifest.reader("epoch_host_ms")(ctx)
    epochs = sorted((r.end_ns - r.start_ns) * 1e-6 for r in recs if r.name == "sgdnet.epoch")
    assert 0.0 < host <= epochs[-1]
    assert manifest.reader("refresh_ms")(ctx) is None  # no card: no device time


# ---------------------------------------------------------------------------
# fit()'s operator accounting
# ---------------------------------------------------------------------------


def _binomial(n=300, p=40, seed=0):
    rng = np.random.default_rng(seed)
    x = sp.random(n, p, density=0.2, random_state=seed, format="csr")
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-3.0 * x[:, :4].sum(axis=1).A1))).astype(float)
    return x, y


@pytest.mark.parametrize("maxit", [1000, 4])
def test_epochs_by_attempt_is_the_paths_order_draws(maxit):
    x, y = _binomial()
    with adapter._epoch_log() as log:
        f = tst.fit(x, y, family="binomial", nlambda=5, maxit=maxit, device="cpu", seed=2)
    e = f.stats["epochs_by_attempt"]
    assert e == log
    assert sum(e.values()) == f.stats["epochs"]
    assert {i for i, _ in e} == set(range(5))
    assert (max(a for _, a in e) > 0) == (maxit == 4)  # a lambda at maxit is retried at half the step
    # a read a step total, an epoch, an attempt, a lambda's deviance, and
    # the path's two copies
    assert f.stats["host_syncs"] == 1 + f.stats["epochs"] + len(e) + 5 + 2


@pytest.mark.parametrize("kw", [dict(lambda_chunk=2), dict(screen=True), dict(use_epoch_kernel=True,
                                                                               sampling="block", batch_size=16)])
def test_epochs_by_attempt_covers_every_call_of_the_path(kw):
    x, y = _binomial()
    if kw.get("use_epoch_kernel"):
        x = x.toarray()
    f = tst.fit(x, y, family="binomial", nlambda=5, device="cpu", seed=2, **kw)
    e = f.stats["epochs_by_attempt"]
    assert sum(e.values()) == f.stats["epochs"] and {i for i, _ in e} == set(range(5))
    assert f.stats["host_syncs"] >= 3 + len(e) + 5
