"""Check that the reduced heads (bf16, int8) reach the f32 head's solution
on the bench workload, the counterpart of tools/validate_bf16.py.

    python -m sgdnet_tpu_torch.tools.validate_bf16 [epochs] [head dtypes ...] [--n 100000]
        [--device cuda|cpu] [--seed 0]

The bench's sparse binomial problem (tools/bench.py `make_sparse_binomial`)
runs the same epochs under an f32 head and each reduced head: rows padded
on the host to B 8192, a head of D 16384 at coverage 0.98, block sampling,
refresh every 4 epochs, the plain head step (as the JAX tool, which does
not set `use_pallas`) and K3 / K4 on the BlockCOO tail, gamma 3e-3, lambda
1/n, the same block orders for every head.  The final regularized
objective (float64 on the host, the columns un-permuted) and the
coefficients are compared with the f32 head's.  The bench admits a
reduced-head config because this check passes: objectives within 1e-4
relative, coefficients within 1e-2 x max|w| (the JAX tool's docstring).
Prints one line a head and one JSON line; exits non-zero when a head
misses a bound.  Defaults: 40 epochs, bfloat16, n 100000; `--device`
defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: the batch and the bounds the bench's reduced heads are held to
B = 8192
OBJECTIVE_BOUND, COEF_BOUND = 1e-4, 1e-2


def objective(w, b, xs, y, lam):
    """(1/n) logistic loss + lam * ||w||_1 in float64 on the host."""
    lp = xs @ w + b
    y1 = y.ravel()
    # log(1 + exp(-|lp|)) + max(lp, 0) - y*lp  (stable logistic loss)
    loss = np.log1p(np.exp(-np.abs(lp))) + np.maximum(lp, 0.0) - y1 * lp
    return float(loss.mean() + lam * np.abs(w).sum())


def run(head_dtype, data, epochs, max_head=16384, coverage=0.98, device=None, seed=0):
    """`epochs` epochs of the bench's step on a `head_dtype` head (None:
    f32) from a zero state, orders from `default_order_fn(seed)`; returns
    (w in the original column order, intercept, objective)."""
    from sgdnet_tpu_torch.solver import saga
    from sgdnet_tpu_torch.tools import bench
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    csr_np, y = data
    n, p = csr_np["n"], csr_np["p"]
    n_pad = ((n + B - 1) // B) * B
    # the rows are padded on the host, before the head is built: padding a
    # built head would hold two heads at once
    x, perm = bench.build_hybrid_device(csr_np, n_pad, max_head=max_head, coverage=coverage, head_dtype=head_dtype,
                                        batch_size=B, device=dev)
    pad = n_pad - n
    yd = torch.cat([torch.as_tensor(np.asarray(y, np.float32).reshape(-1, 1), device=dev),
                    torch.zeros((pad, 1), device=dev)])
    wts = torch.cat([torch.ones((n,), device=dev), torch.zeros((pad,), device=dev)])
    config = bench.solver_config(B, "block", g_sum_refresh_every=4)
    order_fn = saga.default_order_fn(seed, saga.order_count(config, n_pad))
    state = saga.init_state(n_pad, p, 1, torch.float32, dev)

    t0 = time.perf_counter()
    with saga._fp32_matmul():
        state = bench.run_epochs(x, yd, wts, state, [order_fn(0, 0, i) for i in range(epochs)], config, n)
    w = state.w.to(torch.float64).cpu().numpy()[0]
    b = float(state.intercept[0])
    dt = time.perf_counter() - t0
    w_orig = np.empty_like(w)
    w_orig[perm] = w
    obj = objective(w_orig, b, bench._to_scipy(csr_np), y, 1.0 / n)
    print(f"head={head_dtype}: {epochs} epochs in {dt:.2f}s, objective={obj:.8f}, nnz(w)={int((w != 0).sum())}",
          flush=True)
    return w_orig, b, obj


def validate(heads, data, epochs, device=None, seed=0) -> dict:
    """Each head of `heads` (names) against the f32 head: the objective's
    relative difference, the coefficients' max difference over max|w|, the
    intercept's difference, and whether both bounds hold."""
    w32, b32, o32 = run(None, data, epochs, device=device, seed=seed)
    scale = max(np.abs(w32).max(), 1e-12)
    out = {"epochs": epochs, "objective_f32": o32}
    for name in heads:
        wq, bq, oq = run(name, data, epochs, device=device, seed=seed)
        r = {"objective": oq, "objective_rel_diff": abs(oq - o32) / max(abs(o32), 1e-12),
             "coef_max_abs_diff": float(np.abs(wq - w32).max()), "intercept_diff": abs(bq - b32)}
        r["coef_rel_diff"] = r["coef_max_abs_diff"] / scale
        r["passed"] = bool(r["objective_rel_diff"] <= OBJECTIVE_BOUND and r["coef_rel_diff"] <= COEF_BOUND)
        print(f"[{name}] objective rel diff: {r['objective_rel_diff']:.2e} (bound {OBJECTIVE_BOUND:g})")
        print(f"[{name}] coef max abs diff:  {r['coef_max_abs_diff']:.3e}  (rel to max|w|={scale:.3e}: "
              f"{r['coef_rel_diff']:.2e}, bound {COEF_BOUND:g})")
        print(f"[{name}] intercept diff:     {r['intercept_diff']:.3e}", flush=True)
        out[name] = r
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("epochs", nargs="?", type=int, default=40)
    ap.add_argument("heads", nargs="*", default=["bfloat16"], help="reduced head dtypes (bfloat16, int8)")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the block orders (the data's is 0)")
    a = ap.parse_args(argv)
    from sgdnet_tpu_torch.tools.bench import make_sparse_binomial
    from sgdnet_tpu_torch.utils.device import describe, resolve_device

    dev = resolve_device(a.device)
    out = validate(a.heads, make_sparse_binomial(n=a.n, p=47_000, nnz_per_row=76), a.epochs, dev, a.seed)
    print(json.dumps({"device": describe(dev), "n": a.n, **out}))
    return 0 if all(out[h]["passed"] for h in a.heads) else 1


if __name__ == "__main__":
    sys.exit(main())
