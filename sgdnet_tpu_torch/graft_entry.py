"""Entry points of the port (twin of the repository's __graft_entry__.py).

entry()             -> (fn, example_args): one batched SAGA epoch of the
                       binomial family at n 1024, p 256, B 64, on the card
                       (or `device`).
dryrun_multichip(n) -> n ranks (spawned processes: NCCL between n cards,
                       or gloo on the CPU with device="cpu") fit one tiny
                       problem data-parallel and the same problem on one
                       device at the matched global batch, and assert that
                       the coefficients agree within 1e-4 x scale and are
                       the same on every rank.

    python -m sgdnet_tpu_torch.graft_entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def entry(device=None):
    """(fn, (state, order)): fn(state, order) runs one epoch of the
    binomial elastic net over the blocks in `order`."""
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver.saga import SolverConfig, _make_epoch, init_state
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n, p, B = 1024, 256, 64
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(n, p)), dtype=torch.float32, device=dev)
    y = torch.as_tensor((rng.random((n, 1)) < 0.5).astype(np.float32), device=dev)
    weights = torch.ones((n,), dtype=torch.float32, device=dev)

    family = get_family("binomial")
    penalty = select_penalty(0.5, "binomial")
    config = SolverConfig(batch_size=B, max_iter=10, fit_intercept=True, sampling="block")
    state = init_state(n, p, 1, torch.float32, dev)
    epoch = _make_epoch(x, y, weights, float(n), family, penalty, config)

    def fn(state, order):
        return epoch(state, order, 1e-2, 1e-4, 1e-4)

    return fn, (state, torch.randperm(n // B, generator=torch.Generator().manual_seed(0)))


def _dryrun_rank(device) -> dict:
    """One rank of dryrun_multichip: the sharded fit, the single-device fit
    at the same global batch, and every rank's coefficients."""
    import torch.distributed as dist

    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.parallel.multihost import global_data_mesh

    torch.set_num_threads(1)
    mesh = global_data_mesh(device)
    rng = np.random.default_rng(0)
    # 32 rows a rank (the JAX dry run's 8 leave 2 ranks' 16 x 16 problem
    # separable: its last lambda never converges, sharded or not)
    n, p = 32 * mesh.size, 16
    x = rng.normal(size=(n, p))
    y = (rng.random(n) < 0.5).astype(float)
    # fitted to convergence both ways: the same problem at the same global
    # batch (4 a rank x ranks), differing only by trajectory
    kw = dict(family="binomial", nlambda=2, maxit=2000, thresh=1e-6, dtype=np.float32)
    fit = st.fit(x, y, mesh=mesh, batch_size=4, **kw)
    ref = st.fit(x, y, batch_size=4 * mesh.size, lambda_path=fit.lambda_, device=mesh.device, **kw)
    betas = [None] * mesh.size
    dist.all_gather_object(betas, fit.beta)
    return {"max_diff": float(np.max(np.abs(fit.beta - ref.beta))),
            "scale": max(float(np.max(np.abs(ref.beta))), 1.0),
            "same_on_every_rank": all(np.array_equal(b, fit.beta) for b in betas),
            "dev_ratio": float(fit.dev_ratio[-1]), "allreduces": fit.stats["allreduces"], "mesh": fit.stats["mesh"]}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the data-parallel dry run on `n_devices` ranks (device None: one
    card a rank, NCCL, and RuntimeError with fewer cards; "cpu": gloo
    processes) and return rank 0's record; raises AssertionError when the
    sharded and single-device coefficients differ by more than 1e-4 x
    scale or the ranks' coefficients differ at all."""
    from sgdnet_tpu_torch.parallel.multihost import run_ranks

    if device is None and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, "
                           f"found {torch.cuda.device_count()}; pass device='cpu' for gloo ranks on the CPU")
    out = run_ranks(_dryrun_rank, n_devices, args=(device,), timeout=600.0)
    for r in out:
        if not r["same_on_every_rank"]:
            raise AssertionError("the ranks' coefficients differ")
        if r["max_diff"] > 1e-4 * r["scale"]:
            raise AssertionError(f"sharded vs single-device coefficients differ: {r['max_diff']:.3e} "
                                 f"(scale {r['scale']:.3e})")
    rec = out[0]
    print(f"dryrun_multichip({n_devices}): OK, {rec['mesh']['backend']} ranks on "
          f"{'the CPU' if device == 'cpu' else 'the cards'}, dev_ratio={rec['dev_ratio']:.4f}, sharded-vs-single "
          f"max|diff|={rec['max_diff']:.3e} (scale {rec['scale']:.3e}, bound 1e-4*scale), "
          f"{rec['allreduces']['total']} all-reduces")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--ranks", type=int, default=None, help="ranks of the dry run (default: the cards, or 2)")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    state = fn(*example)
    print("entry(): one epoch OK;", {k: tuple(v.shape) for k, v in state._asdict().items()})
    ranks = args.ranks or (2 if args.device == "cpu" else max(torch.cuda.device_count(), 1))
    dryrun_multichip(ranks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
