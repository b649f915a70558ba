"""The port's bench leg (sgdnet_tpu_torch/tools: bench, validate_bf16,
bench_layout_sweep, bench_path_e2e, and the profile tool's generator)
against bench.py and the JAX tools, on the CPU at small sizes.

  * `make_sparse_binomial` gives bench.py's arrays bit for bit, and the
    profile tool's CSR is the one its own copy of the generator made;
  * `build_hybrid_device` gives bench.py's layout exactly (head, scales,
    tail, BlockCOO arrays) for int8 and bf16 heads, from the padded-CSR
    dict and from the scipy matrix;
  * `run_epochs` walks in lockstep with bench.py's `_make_epoch` scan on
    each of the three configs (the bf16 config through K2's twin against
    the Pallas kernel in interpret mode), given the JAX epochs' block
    orders: w, intercept and g_sum within 1e-5 x scale in f32 after 8
    epochs (the sums differ only in order; measured 1.3e-7 to 3.8e-7);
  * `bench_dense_multinomial`'s epochs in lockstep with the JAX dense
    epoch on the same numpy data (1e-5 x scale; measured 3.3e-7), TF32
    restored after "default";
  * the sweep's `tail_entries_for` equals the JAX tool's, and the
    synthesized layout has the shapes of its arithmetic;
  * `validate_bf16.objective` and `run` agree with the JAX tool's (f32,
    bf16 and int8 heads: w within 1e-5 x scale, measured 6.3e-7; the
    objective within 1e-6 relative, measured 8e-10);
  * `bench_path_e2e.run_one` meets `sgdnet_tpu.fit` under the JAX fits'
    batch orders (the `jax_sampling` fixture) by penalized objective per
    lambda (5e-4 relative, measured 5.4e-5: the workload's minimizers are
    not unique, and each lambda stops at thresh 1e-3); the tool's exit
    code says whether its paths are finite, never its printed verdicts;
  * the bench's CLI prints a well-formed metric line on the CPU, exits
    non-zero without a card, and prints no value for a failed config.
"""

import json
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgdnet_tpu as jst
from sgdnet_tpu_torch.solver import saga as tsaga
from sgdnet_tpu_torch.tools import bench, bench_layout_sweep, bench_path_e2e, profile_sparse_slices, validate_bf16
from test_torch_cv import jax_sampling  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

import bench as jbench  # noqa: E402
import bench_layout_sweep as jsweep  # noqa: E402
import validate_bf16 as jvalidate  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _eq(a, b, what):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(jnp.asarray(b, jnp.float32) if getattr(b, "dtype", None) == jnp.bfloat16 else b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _close(a, b, tol, what):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-12)
    assert float(np.abs(a - b).max()) <= tol * scale, (what, float(np.abs(a - b).max()) / scale)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_make_sparse_binomial_is_bench_pys(seed):
    (xt, yt), (xj, yj) = bench.make_sparse_binomial(512, 300, seed=seed), jbench.make_sparse_binomial(512, 300,
                                                                                                      seed=seed)
    for k in ("indices", "values", "nnz"):
        assert xt[k].dtype == xj[k].dtype
        np.testing.assert_array_equal(xt[k], xj[k])
    assert (xt["n"], xt["p"]) == (xj["n"], xj["p"])
    np.testing.assert_array_equal(yt, yj)
    assert yt.shape == (512, 1)
    st, sj = bench._to_scipy(xt), jbench._to_scipy(xj)
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(st, k), getattr(sj, k))


def _profile_generator_before(n, p, nnz_per_row=76, seed=0):
    """The profile tool's own copy of the generator, as it stood before it
    became a wrapper of the bench's."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    weights = (np.arange(p) + 10.0) ** -1.15
    cdf = np.cumsum(weights) / weights.sum()
    cols = np.searchsorted(cdf, rng.random((n, nnz_per_row))).astype(np.int32).clip(0, p - 1)
    vals = rng.normal(size=(n, nnz_per_row)).astype(np.float32)
    w_true = rng.normal(size=p) * (rng.random(p) < 0.05) * 3.0
    lp = (vals * w_true[cols]).sum(axis=1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-lp))).astype(np.float32)
    x = sp.csr_matrix((vals.ravel(), cols.ravel(), np.arange(0, n * nnz_per_row + 1, nnz_per_row)), shape=(n, p))
    x.sum_duplicates()
    return x, y


@pytest.mark.parametrize("seed", [0, 3])
def test_profile_generator_gives_the_same_csr(seed):
    x, y = profile_sparse_slices.make_sparse_binomial(600, 300, seed=seed)
    x0, y0 = _profile_generator_before(600, 300, seed=seed)
    assert x.has_canonical_format and x.shape == x0.shape and x.dtype == x0.dtype
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(x, k), getattr(x0, k))
    np.testing.assert_array_equal(y, y0)
    assert y.shape == (600,)


# ---------------------------------------------------------------------------
# the layout builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", ["int8", "bfloat16"])
@pytest.mark.parametrize("given", ["dict", "scipy"])
def test_build_hybrid_device_matches_bench_py(head, given):
    data, _ = bench.make_sparse_binomial(600, 300, seed=1)
    n_pad, B = 1024, 256
    src = data if given == "dict" else bench._to_scipy(data)
    t, perm = bench.build_hybrid_device(src, n_pad, max_head=128, coverage=0.9, head_dtype=head, batch_size=B,
                                        device=CPU)
    j = jbench.build_hybrid_device(data, n_pad, max_head=128, coverage=0.9, head_dtype=getattr(jnp, head),
                                   batch_size=B)
    assert t.shape == tuple(j.shape) and t.head.dtype == getattr(torch, head)
    _eq(t.head, j.head, "head")
    if head == "int8":
        _eq(t.head_scale, j.head_scale, "head_scale")
    else:
        assert t.head_scale is None and j.head_scale is None
    for f in ("indices", "values", "nnz"):
        _eq(getattr(t.tail, f), getattr(j.tail, f), f"tail {f}")
    for f in ("rows", "cols", "vals"):
        _eq(getattr(t.blk_tail, f), getattr(j.blk_tail, f), f"BlockCOO {f}")
    assert t.blk_tail.batch == B and t.blk_tail.device == CPU
    # perm maps the layout's columns back: its first D are the head's columns
    xs = bench._to_scipy(data)
    col_nnz = np.bincount(xs.indices, minlength=xs.shape[1])
    assert sorted(perm) == list(range(xs.shape[1]))
    assert col_nnz[perm[: t.n_head]].min() >= col_nnz[perm[t.n_head:]].max()


def test_block_coo_to_keeps_the_packing():
    data, _ = bench.make_sparse_binomial(600, 300, seed=2)
    t, _ = bench.build_hybrid_device(data, 768, max_head=128, coverage=0.9, head_dtype="int8", batch_size=256,
                                     device=CPU)
    moved = t.blk_tail.to(CPU)
    assert moved.lanes == t.blk_tail.lanes and len(moved.addr) == t.blk_tail.n_blocks
    for f in ("rows", "cols", "vals", "counts", "row_ptr", "rows_by_col", "vals_by_col", "col_seg", "heavy_cols"):
        assert torch.equal(getattr(moved, f), getattr(t.blk_tail, f)), f


# ---------------------------------------------------------------------------
# the epochs in lockstep with bench.py's scan
# ---------------------------------------------------------------------------


def _jax_bench_epochs(x, y, weights, n, config, epochs, key, family, penalty, gamma, l1, it=True):
    """bench.py's run_epochs (bench.py:384-394): a scan of `epochs` epochs
    from a zero state, epoch i on fold_in(key, i)."""
    from sgdnet_tpu.solver.saga import _make_epoch, init_state

    @partial(jax.jit, static_argnames=("family", "penalty", "config", "epochs"))
    def run(x, y, weights, state, key, family, penalty, config, epochs):
        with jax.default_matmul_precision("highest"):
            epoch = _make_epoch(x, y, weights, None, jnp.float32(n), family, penalty, config)

            def body(state, i):
                kw = dict(it=i) if it else {}
                return epoch(state, jax.random.fold_in(key, i), jnp.float32(gamma), jnp.float32(l1),
                             jnp.float32(0.0), **kw), None

            return jax.lax.scan(body, state, jnp.arange(epochs))[0]

    state = init_state(y.shape[0], x.shape[1], y.shape[1], jnp.float32)
    return run(x, y, weights, state, key, family, penalty, config, epochs)


def _jax_order(key, count, i):
    """The JAX epoch's block order: permutation(fold_in(key, i), count)."""
    return torch.as_tensor(np.array(jax.random.permutation(jax.random.fold_in(key, i), count)))


def _jax_orders(key, count, epochs):
    return [_jax_order(key, count, i) for i in range(epochs)]


@pytest.mark.parametrize("cfg", [0, 1, 2, "padded"])
def test_run_epochs_lockstep_with_bench_py(cfg):
    """Each bench config, and bench_sparse_epoch's default PaddedCSR
    layout (`as_padded`, permutation sampling, gather)."""
    from sgdnet_tpu.families import get_family
    from sgdnet_tpu.penalties import select_penalty
    from sgdnet_tpu.solver.saga import SolverConfig

    n, B, epochs = 2048, 256, 8
    data, y = bench.make_sparse_binomial(n, 300, seed=4)
    key = jax.random.PRNGKey(0)
    if cfg == "padded":
        kw = dict(g_sum_refresh_every=1, sampling="permutation")
        tx, jx = bench.as_padded(data, CPU), jbench.as_padded(data)
        orders = _jax_orders(key, n, epochs)
    else:
        kw = dict(bench.SPARSE_CONFIGS[cfg])
        hd = kw["head_dtype"]
        tx, _ = bench.build_hybrid_device(data, n, max_head=128, coverage=kw["coverage"], head_dtype=hd,
                                          batch_size=B, device=CPU)
        jx = jbench.build_hybrid_device(data, n, max_head=128, coverage=kw["coverage"], head_dtype=getattr(jnp, hd),
                                        batch_size=B)
        orders = _jax_orders(key, n // B, epochs)
    pallas = kw.get("use_pallas", False)
    config = bench.solver_config(B, kw["sampling"], kw["g_sum_refresh_every"], pallas)
    assert tsaga.uses_head_kernel(tx, bench._family_penalty("binomial", 1)[0], config) is pallas
    ts = tsaga.init_state(n, 300, 1, torch.float32, CPU)
    ts = bench.run_epochs(tx, torch.as_tensor(y), torch.ones(n), ts, orders, config, n)
    jconfig = SolverConfig(batch_size=B, fit_intercept=True, sparse_mode="gather", intercept_decay=0.01,
                           use_pallas=pallas, sampling=kw["sampling"], g_sum_refresh_every=kw["g_sum_refresh_every"])
    js = _jax_bench_epochs(jx, jnp.asarray(y), jnp.ones((n,), jnp.float32), n, jconfig, epochs, key,
                           get_family("binomial"), select_penalty(1.0, "binomial"), 3e-3, 1.0 / n)
    assert float(torch.abs(ts.w).max()) > 0
    for f in ("w", "intercept", "g_sum", "g_sum_intercept"):
        _close(getattr(ts, f), getattr(js, f), 1e-5, f)


def test_dense_multinomial_lockstep_and_tf32():
    from sgdnet_tpu.families import get_family
    from sgdnet_tpu.penalties import select_penalty
    from sgdnet_tpu.solver.saga import SolverConfig

    n, p, k, B, epochs = 512, 16, 3, 128, 3
    rng = np.random.default_rng(5)
    xn, yi = rng.standard_normal((n, p)).astype(np.float32), rng.integers(0, k, n)
    x, y, wts = bench.dense_multinomial_problem(n, p, k, CPU, data=(xn, yi))
    key = jax.random.PRNGKey(1)
    ts = bench.run_epochs(x, y, wts, tsaga.init_state(n, p, k, torch.float32, CPU), _jax_orders(key, n // B, epochs),
                          bench.solver_config(B, "block", intercept_decay=1.0), n, gamma=1e-3, l1=1e-4,
                          family="multinomial")
    jconfig = SolverConfig(batch_size=B, fit_intercept=True, sampling="block")
    js = _jax_bench_epochs(jnp.asarray(xn), jax.nn.one_hot(jnp.asarray(yi), k, dtype=jnp.float32),
                           jnp.ones((n,), jnp.float32), n, jconfig, epochs, key,
                           get_family("multinomial", n_classes=k), select_penalty(1.0, "multinomial"), 1e-3, 1e-4,
                           it=False)
    for f in ("w", "intercept", "g_sum"):
        _close(getattr(ts, f), getattr(js, f), 1e-5, f)

    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with bench.precision_scope("default"):
            assert torch.backends.cuda.matmul.allow_tf32
        out = bench.bench_dense_multinomial(batch_size=128, epochs=2, matmul_precision="default", device=CPU,
                                            data=(xn, yi), k=k)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert out["finite"] and out["samples_per_s"] > 0 and out["matmul_precision"] == "default"
        with pytest.raises(ValueError):
            with bench.precision_scope("high"):
                pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# the layout sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [128, 1024, 2560])
def test_sweep_tail_entries_and_shapes(D):
    n, p, B = 3000, 4000, 1024
    e = bench_layout_sweep.tail_entries_for(D, n, p)
    assert e == jsweep.tail_entries_for(D, n, p)
    n_pad, blocks = -(-n // B) * B, -(-n // B)
    assert bench_layout_sweep.synth_shapes(D, B, n, p) == (
        n_pad, blocks, e, ((e // blocks + 127) // 128) * 128, ((max(e // n, 1) + 7) // 8) * 8)
    _, _, _, E, L = bench_layout_sweep.synth_shapes(D, B, n, p)
    for hd in ("int8", "bfloat16"):
        x, y, w, n_pad_ = bench_layout_sweep.build_synth(D, B, hd, n, p, device=CPU)
        assert n_pad_ == n_pad and tuple(x.head.shape) == (n_pad, D) and x.head.dtype == getattr(torch, hd)
        assert tuple(x.blk_tail.rows.shape) == (blocks, E) and x.tail.row_width == L
        assert int(x.blk_tail.counts.min()) == E and bool((x.blk_tail.cols >= D).all())
        assert bool((torch.diff(x.blk_tail.rows, dim=1) >= 0).all())
        assert (x.head_scale is not None) == (hd == "int8")
        assert float(w.sum()) == n and tuple(y.shape) == (n_pad, 1)


def test_sweep_config_runs_its_epochs():
    r = bench_layout_sweep.bench_config(256, 512, "bfloat16", use_pallas=True, refresh=2, epochs=2, n=1500, p=2000,
                                        device=CPU)
    assert r["nnz_per_s"] > 0 and r["ms_per_epoch"] > 0
    assert (r["k2_per_epoch"], r["k3_per_epoch"], r["k4_per_epoch"]) == (0, 0, 0)  # twins: no launch counted


# ---------------------------------------------------------------------------
# validate_bf16
# ---------------------------------------------------------------------------


def test_validate_objective_matches():
    data, y = bench.make_sparse_binomial(400, 200, seed=6)
    xs = bench._to_scipy(data)
    w = np.random.default_rng(6).standard_normal(200) * 0.1
    assert validate_bf16.objective(w, 0.3, xs, y, 1e-3) == jvalidate.objective(w, 0.3, xs, y, 1e-3)


@pytest.mark.parametrize("head", [None, "bfloat16", "int8"])
def test_validate_run_matches_jax_tool(head, monkeypatch, capsys):
    data = bench.make_sparse_binomial(3000, 2000, seed=0)
    key = jax.random.PRNGKey(0)
    # the JAX tool's orders (fold_in(PRNGKey(0), i)); one block here, as B is 8192
    monkeypatch.setattr(tsaga, "default_order_fn", lambda seed, n: lambda lam, att, e: _jax_order(key, n, e))
    wt, bt, ot = validate_bf16.run(head, data, 4, device=CPU)
    wj, bj, oj = jvalidate.run(None if head is None else getattr(jnp, head), data, 4)
    _close(wt, wj, 1e-5, "w")
    assert abs(bt - bj) <= 1e-5 * max(abs(bj), 1e-3)
    assert abs(ot - oj) <= 1e-6 * abs(oj)
    assert "objective=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# bench_path_e2e
# ---------------------------------------------------------------------------


def test_path_e2e_run_one_matches_jax_fit(jax_sampling):
    # p 3000: every lambda below lambda_max converges in both packages (at
    # p 600 two hit maxit, where f32 noise alone moves the objective ~1e-3)
    data, y = bench.make_sparse_binomial(2000, 3000, seed=3)
    xs, yv = bench._to_scipy(data), y.ravel()
    out = bench_path_e2e.run_one(xs, yv, xs.nnz, 128, screen_modes=(True,), nlambda=5, device=CPU)
    jf = jst.fit(xs, yv, **bench_path_e2e.path_kwargs(128, 5))
    np.testing.assert_allclose(out["lambda_"], jf.lambda_, rtol=1e-10)
    oj = bench_path_e2e.path_objective(jf, xs, yv)
    # each lambda stops where its relative change falls under thresh 1e-3, a
    # point that f32 sums in another order can move by an epoch: measured
    # 5.4e-5 at the last lambda
    np.testing.assert_allclose(out["objective"], oj, rtol=5e-4)
    assert out["finite"] and out["scr_objective_pass"] and out["scr_objective_rel"] <= bench_path_e2e.OBJECTIVE_BOUND
    assert out["scr_coef_pass"] and out["scr_diff"] <= bench_path_e2e.SCREEN_CONTRACT
    np.testing.assert_allclose(out["scr_objective"], out["objective"], rtol=1e-4)
    assert out["head_width"] == 128 and out["tail_kernel"] is True and out["ep_warm"] == out["ep_full"]


@pytest.mark.parametrize("finite", [True, False])
def test_path_e2e_exit_code_follows_finiteness(finite, monkeypatch, capsys):
    # both verdicts fail in both cases: they are printed, never the exit code
    def fake_run_one(xs, yv, nnz, D, screen_modes=(True, "auto"), nlambda=50, device=None):
        out = {"D": D, "finite": finite or D == 128}
        for key in ("scr", "auto")[: len(screen_modes)]:
            out.update({f"{key}_objective_pass": False, f"{key}_coef_pass": False})
        return out

    monkeypatch.setattr(bench_path_e2e, "run_one", fake_run_one)
    rc = bench_path_e2e.main(["quick", "128", "256", "--device", "cpu"])
    assert rc == (0 if finite else 1)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["D"] for r in line["widths"]] == [128, 256] and line["n"] == 20_000


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--n", "1500", "--p", "400", "--epochs", "2", "--no-secondary"]


def _lines(out):
    return [json.loads(s) for s in out.strip().splitlines() if s.strip()]


def test_bench_cli_prints_the_metric_line(capsys):
    assert bench.main(TINY) == 0
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 3
    last = lines[-1]
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "card", "power_limit_w"}
    assert last["metric"] == "torch_sparse_saga_nnz_per_s" and last["unit"] == "nnz/s"
    assert last["value"] == max(s["value"] for s in lines) > 0
    assert last["vs_baseline"] == pytest.approx(last["value"] / 4.50e5)
    assert last["card"] == "cpu" and last["power_limit_w"] is None


def test_bench_cli_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--n", "1500", "--p", "400"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_bench_cli_failed_config_prints_no_value(monkeypatch, capsys):
    real = bench.bench_sparse_epoch

    def flaky(**kw):
        if kw["head_dtype"] == "int8" and kw["max_head"] == 24576:
            raise RuntimeError("config 2 broke")
        return real(**kw)

    monkeypatch.setattr(bench, "bench_sparse_epoch", flaky)
    assert bench.main(TINY) == 1
    out = capsys.readouterr()
    lines = _lines(out.out)
    assert len(lines) == 2 and all(s["value"] > 0 for s in lines)
    assert "config 2 " in out.err and "config 2 broke" in out.err
