"""What the ranks of the port's data-parallel tests run (imported by the
spawned gloo processes of tests/test_torch_dist.py and
tests/test_torch_multihost.py, through sgdnet_tpu_torch.parallel.multihost
`run_ranks`).

`run_cases(cases)` runs several fits in one group of ranks, one after
another, and returns each case's results as numpy arrays.  A case may
replay the JAX package's per-shard batch orders (`jax_orders`): the JAX
sharded epoch draws permutation(fold_in(fold_in(akey, epoch), shard)) of
the shard's blocks or rows, akey = fold_in(PRNGKey(seed), lambda), folded
with the attempt on a retry, and its power iteration starts from
normal(PRNGKey(0), (p,)).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class ShardOrders:
    """The JAX sharded fit's orders for shard `rank`, CHUNK epochs at a
    time from one compiled program a shape."""

    CHUNK = 64

    def __init__(self, seed: int, n: int, rank: int):
        import jax
        import jax.numpy as jnp

        self.jax, self.key, self.n, self.rank, self.cache = jax, jax.random.PRNGKey(seed), n, rank, {}
        self.perms = jax.jit(lambda akey, e0: jax.vmap(lambda e: jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(akey, e), rank), n))(e0 + jnp.arange(self.CHUNK)))

    def __call__(self, lam_idx, attempt, epoch):
        c = (lam_idx, attempt, epoch // self.CHUNK)
        if c not in self.cache:
            fold_in = self.jax.random.fold_in
            lam_key = fold_in(self.key, lam_idx)
            akey = lam_key if attempt == 0 else fold_in(lam_key, attempt)
            self.cache[c] = np.asarray(self.perms(akey, c[2] * self.CHUNK))
        return torch.tensor(self.cache[c][epoch % self.CHUNK])


def _install_jax_sampling():
    """The port's meshed fits draw the JAX sharded fit's orders and start
    their power iterations from the JAX package's vector."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from sgdnet_tpu_torch.api import fit as tfit
    from sgdnet_tpu_torch.solver import saga as tsaga
    from sgdnet_tpu_torch.solver import stepsize as tss

    def order_fn(seed, n, salt=None, rank=None):
        if salt is not None or rank is None:
            raise AssertionError("a meshed fit draws its orders with its rank and no salt")
        return ShardOrders(seed, n, rank)

    def power_iteration(x, seed=0, x_center_scaled=None, **kw):
        v0 = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (x.shape[1],), jnp.float64)))
        return tss.power_iteration_sq_norm(x, v0=v0, x_center_scaled=x_center_scaled)

    tsaga.default_order_fn = order_fn
    tfit.power_iteration_sq_norm = power_iteration


def as_input(x, kind: str):
    """The design as a case gives it to fit: dense numpy or scipy CSR."""
    if kind == "dense":
        return x
    import scipy.sparse as sp

    return sp.csr_matrix(x)


class CountedAllReduce:
    """Counts the calls of torch.distributed.all_reduce while installed."""

    def __enter__(self):
        self.real, self.calls = dist.all_reduce, 0

        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self.real


def run_cases(cases: dict, jax_orders: bool = False) -> dict:
    """Each case {"x", "y", "kind", "kw"} fitted on this rank's mesh (the
    CPU, gloo): its path, the final state's w, the fit's mesh stats and the
    all_reduce calls torch.distributed saw."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.parallel.dist import make_mesh

    torch.set_num_threads(1)
    if jax_orders:
        _install_jax_sampling()
    mesh = make_mesh(device="cpu")
    out = {}
    for name, c in cases.items():
        with CountedAllReduce() as counted:
            f = st.fit(as_input(c["x"], c["kind"]), c["y"], mesh=mesh, device="cpu", **c["kw"])
        out[name] = {"beta": f.beta, "a0": f.a0, "dev_ratio": f.dev_ratio, "lambda": f.lambda_,
                     "npasses": f.npasses, "return_codes": f.return_codes, "w": f.final_state.w.numpy(),
                     "g_mem_rows": f.final_state.g_mem.shape[0], "stats": {k: f.stats[k] for k in
                                                                            ("mesh", "allreduces", "layout",
                                                                             "head_kernel", "tail_kernel",
                                                                             "epoch_kernel")},
                     "all_reduce_calls": counted.calls}
    return out


def fold_mesh_cv(x, y, kw) -> dict:
    """cv_fit over a fold mesh of this group's ranks (the CPU), and
    parallel_fold_scores over it with the folds given."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.parallel.cv import parallel_fold_scores
    from sgdnet_tpu_torch.parallel.dist import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(axis="folds", device="cpu")
    cv = st.cv_fit(x, y, parallel=True, cv_mesh=mesh, device="cpu", **kw)
    foldid = np.arange(len(y)) % 3
    scores = parallel_fold_scores(x, y, foldid, 3, 1.0, cv.lambda_[0], mesh=mesh, device="cpu")
    return {"cv_raw": cv.cv_raw[0], "lambda_min": cv.lambda_min, "lambda_1se": cv.lambda_1se,
            "lambda": cv.lambda_[0], "scores": scores, "mesh": (mesh.axis, mesh.size, mesh.rank, mesh.backend)}


def group_facts() -> dict:
    """What init_multihost made of the environment on this rank."""
    import os

    from sgdnet_tpu_torch.parallel.multihost import global_data_mesh, init_multihost

    again = init_multihost()  # a no-op once initialized
    mesh = global_data_mesh("cpu")
    return {"rank": dist.get_rank(), "world": dist.get_world_size(), "again": again,
            "env": (os.environ["RANK"], os.environ["WORLD_SIZE"]), "backend": dist.get_backend(),
            "mesh": (mesh.axis, mesh.size, mesh.rank, mesh.backend, str(mesh.device))}


def scaling(kw) -> dict:
    from sgdnet_tpu_torch.parallel.scaling import measure_scaling

    torch.set_num_threads(1)
    return measure_scaling(device="cpu", **kw)


def fail_on_rank_one():
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    # rank 0 waits in a collective that rank 1 never joins
    dist.all_reduce(torch.zeros(1))
    return "unreachable"


def sleep(seconds: float):
    import time

    time.sleep(seconds)
