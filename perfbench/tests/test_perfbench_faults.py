"""A run whose timed path is broken underneath comes out not correct, once
for each fault a cell can have: a step that returns its state unchanged;
half of each batch left out, the mean taken over the rest; an answer
altered where it is produced.  (One chip: no exchange between chips.)"""

import time

import pytest
import torch

from conftest import CELLS

from perfbench import check, workload



def _unchanged(saga, monkeypatch):
    make = saga._make_step

    def broken(*a, **kw):
        step = make(*a, **kw)

        def same(state, scal, sel):
            return state

        same.tail_forward = step.tail_forward
        return same

    monkeypatch.setattr(saga, "_make_step", broken)


def _half_batch(saga, monkeypatch):
    make = saga._make_step

    def broken(x, y, weights, w_total, family, penalty, config, *a, **kw):
        B = config.batch_size
        w = weights.clone().reshape(-1, B)
        w[:, B // 2 :] = 0.0
        return make(x, y, w.reshape(-1), w_total, family, penalty, config, *a, **kw)

    monkeypatch.setattr(saga, "_make_step", broken)


def _altered(saga, monkeypatch):
    make = saga._make_epoch

    def broken(*a, **kw):
        epoch = make(*a, **kw)

        def flipped(state, *ea, **ekw):
            state = epoch(state, *ea, **ekw)
            w = state.w.clone().reshape(-1)
            j = int(torch.argmax(torch.abs(w)))
            w[j] = -w[j]
            return state._replace(w=w.reshape(state.w.shape))

        return flipped

    monkeypatch.setattr(saga, "_make_epoch", broken)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, tiny_cell, monkeypatch):
    from sgdnet_tpu_torch.solver import saga

    cell = tiny_cell(name)
    fault(saga, monkeypatch)
    out = workload.run(cell, 5, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert not check.judge(out.readings, cell.limits)[0], out.readings
