"""The port's multi-process layer on the CPU: `init_multihost` from the
environment in spawned ranks, the fold mesh of cross-validation, the
scaling harness, `graft_entry.dryrun_multichip`, and `run_ranks` failing a
group whose rank fails or hangs (twin of tests/test_multihost.py's claim,
on torch.distributed's gloo instead of jax.distributed).

Fold-mesh scores are the unmeshed fold-parallel scores (within 1e-12
relative, lambda_min and lambda_1se the same path points): fold fits take
no rank in their orders, so a fold scores the same on whichever rank
fits it.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import sgdnet_tpu_torch as tst
import torch_dist_cases
from helpers import random_data
from sgdnet_tpu_torch.parallel.multihost import run_ranks

torch.set_num_threads(1)


def test_init_multihost_from_env():
    out = run_ranks(torch_dist_cases.group_facts, 2, timeout=120.0)
    for r, facts in enumerate(out):
        assert facts["rank"] == r and facts["world"] == 2
        assert facts["again"] == (r, 2) and facts["env"] == (str(r), "2")
        assert facts["backend"] == "gloo"  # no card: gloo for every tensor
        assert facts["mesh"] == ("data", 2, r, "gloo", "cpu")


def test_fold_mesh_scores_equal_unmeshed():
    """3 folds over 2 ranks: rank 0 fits folds 0-1, rank 1 fold 2 and a
    padded fold it does not fit."""
    x, y = random_data(n=90, p=5, seed=12)
    kw = dict(nfolds=3, nlambda=5, thresh=1e-4, dtype=np.float64)
    out = run_ranks(torch_dist_cases.fold_mesh_cv, 2, args=(x, y, kw), timeout=180.0)
    plain = tst.cv_fit(x, y, parallel=True, device="cpu", **kw)
    for r, m in enumerate(out):
        assert m["mesh"] == ("folds", 2, r, "gloo")
        assert m["cv_raw"].shape == (3, 5)
        np.testing.assert_allclose(m["cv_raw"], plain.cv_raw[0], rtol=1e-12, atol=0)
        np.testing.assert_array_equal(m["lambda"], plain.lambda_[0])
        assert m["lambda_min"] == plain.lambda_min and m["lambda_1se"] == plain.lambda_1se
    from sgdnet_tpu_torch.parallel.cv import parallel_fold_scores

    ref = parallel_fold_scores(x, y, np.arange(len(y)) % 3, 3, 1.0, plain.lambda_[0], device="cpu")
    for m in out:
        np.testing.assert_allclose(m["scores"], ref, rtol=1e-12, atol=0)


def test_measure_scaling_two_ranks():
    out = run_ranks(torch_dist_cases.scaling, 2, args=(dict(n=512, p=16, batch_per_device=16, epochs=1),),
                    timeout=180.0)
    for r in out:
        assert set(r) == {1, 2, "efficiency", "shared_device"}
        assert r[1] > 0 and r[2] > 0
        assert r["efficiency"][1] == 1.0 and r["efficiency"][2] == pytest.approx(r[2] / (2 * r[1]))
        assert r["shared_device"] is True  # gloo ranks on the CPU: not a scaling measurement
    assert out[0] == out[1]


def test_dryrun_multichip_two_ranks():
    from sgdnet_tpu_torch.graft_entry import dryrun_multichip, entry

    rec = dryrun_multichip(2, device="cpu")
    assert rec["same_on_every_rank"] and rec["max_diff"] <= 1e-4 * rec["scale"]
    assert rec["mesh"] == {"axis": "data", "size": 2, "rank": 0, "backend": "gloo"}
    fn, (state, order) = entry("cpu")
    out = fn(state, order)
    assert out.w.shape == (1, 256) and torch.isfinite(out.w).all() and not torch.equal(out.w, state.w)


def test_run_ranks_fails_on_a_failed_rank():
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed:.*rank one fails"):
        run_ranks(torch_dist_cases.fail_on_rank_one, 2, timeout=120.0)


def test_run_ranks_fails_on_its_timeout():
    with pytest.raises(RuntimeError, match="did not finish within 3"):
        run_ranks(torch_dist_cases.sleep, 2, args=(60.0,), timeout=3.0)


def test_make_mesh_needs_a_process_group_and_a_device():
    from sgdnet_tpu_torch.parallel.dist import make_mesh
    from sgdnet_tpu_torch.parallel.multihost import free_port, init_multihost

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        make_mesh(device="cpu")
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_mesh()
        mesh = make_mesh(device="cpu")
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        assert hash(mesh) == hash(make_mesh(device="cpu"))
        x, y = random_data(n=40, p=3, seed=5)
        with pytest.raises(ValueError, match="not the mesh's device"):
            tst.fit(x, y, mesh=mesh, device="meta")
    finally:
        dist.destroy_process_group()
