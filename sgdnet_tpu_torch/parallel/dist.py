"""Data-parallel sharded SAGA over a process group (twin of
sgdnet_tpu/parallel/dist.py).

The design matrix, response, sample weights and per-sample gradient
memory are **row-sharded** over the ranks of a 1-D mesh (one rank a
process, one process a device), while the coefficients `w`, the
intercept and the gradient average `g_sum` are **replicated**.  Every rank
calls the same entry point with the same global inputs, as every process
does under `jax.distributed`; each keeps its contiguous range of rows.

A batched SAGA step is SPMD: each rank draws a local minibatch from its
own rows, computes its rank-B statistics, and ONE all-reduce a step (the
packed [sum wb, sum gc, corr] buffer, solver/saga.py) forms the global
batch update, which every rank then applies identically to its copy of
the state.  That is a single-device minibatch SAGA with global batch
B_local * n_ranks drawn stratified by shard, so the fixed point is the
single-device one.

Collectives go through `torch.distributed`: NCCL between cards, gloo on
the CPU, and gloo (staged through the host) for CUDA tensors of ranks
that share one card, where NCCL refuses to run.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch
import torch.distributed as dist

from sgdnet_tpu_torch.core.sparse import HybridCSR, PaddedCSR
from sgdnet_tpu_torch.solver.saga import SagaState, SolverConfig, fit_path

AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the ranks of a process group, this process's rank and
    the device its tensors live on.  Hashable (a SolverConfig field); the
    group and the collective counts take no part in its identity.
    `counts` tallies the all-reduces by what they reduce ("step",
    "refresh", "loss", "setup")."""

    axis: str
    size: int
    rank: int
    device: torch.device
    backend: str  # the backend the device's tensors go through: "nccl" or "gloo"
    group: object = field(default=None, compare=False, repr=False)
    counts: dict = field(default_factory=dict, compare=False, repr=False)

    def _host_staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def all_reduce(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """Sum `t` over the ranks in place (and return it).  NCCL runs on
        its own stream ordered after the current one, with no host sync;
        gloo on a CUDA tensor copies it down and back up."""
        self.counts[what] = self.counts.get(what, 0) + 1
        if self._host_staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` stacked along a new first axis, in rank order."""
        src = t.cpu() if self._host_staged(t) else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(t.device)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank (in place, and returned)."""
        src = dist.get_global_rank(self.group, 0) if self.group is not None else 0
        if self._host_staged(t):
            host = t.cpu()
            dist.broadcast(host, src=src, group=self.group)
            t.copy_(host)
        else:
            dist.broadcast(t, src=src, group=self.group)
        return t


def _backend_for(device: torch.device, group) -> str:
    """The backend that carries `device`'s tensors in `group`: NCCL where
    the group has it and the tensors are on a card, else gloo."""
    name = dist.get_backend(group)
    return "nccl" if device.type == "cuda" and "nccl" in name else "gloo"


def make_mesh(n_devices: int | None = None, group=None, axis: str = AXIS, device=None) -> Mesh | None:
    """1-D mesh over the ranks of `group` (default: the whole process
    group, or its first `n_devices` ranks), on `device` (default: this
    process's current CUDA device; raises without one).  Pass axis="folds"
    for fold-parallel CV.  A smaller `n_devices` makes a new group, which
    every rank must call; the ranks outside it get None.  Raises
    RuntimeError when no process group is initialized (see
    parallel.multihost.init_multihost)."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call sgdnet_tpu_torch.parallel.multihost."
                           "init_multihost() (or torch.distributed.init_process_group) first")
    if group is None and n_devices is not None and n_devices != dist.get_world_size():
        if not 0 < n_devices <= dist.get_world_size():
            raise ValueError(f"n_devices must be in [1, {dist.get_world_size()}]; got {n_devices}")
        group = dist.new_group(list(range(n_devices)))
        if dist.get_rank() >= n_devices:
            return None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a mesh's device=None means this process's card; pass device='cpu' "
                               "to run the mesh on the CPU (gloo)")
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axis, dist.get_world_size(group), dist.get_rank(group), dev, _backend_for(dev, group), group)


def pad_to_shards(n: int, n_shards: int, batch_size: int) -> int:
    """Rows per shard must be a multiple of batch_size; total rows a multiple
    of shards * batch_size."""
    per = n_shards * batch_size
    return ((n + per - 1) // per) * per


def shard_rows(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mesh rank's contiguous share of `a`'s rows, its own storage (so
    the rest can be freed) unless it is all of them."""
    n = a.shape[0]
    if n % mesh.size != 0:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} ranks (see pad_to_shards)")
    if mesh.size == 1:
        return a
    per = n // mesh.size
    return a[mesh.rank * per : (mesh.rank + 1) * per].clone()


def _shard_csr(csr: PaddedCSR, mesh: Mesh) -> PaddedCSR:
    return PaddedCSR(shard_rows(csr.indices, mesh), shard_rows(csr.values, mesh), shard_rows(csr.nnz, mesh),
                     csr.n_rows // mesh.size, csr.n_cols)


def shard_inputs(mesh: Mesh, x, y, weights):
    """The mesh rank's rows of x (dense, PaddedCSR or HybridCSR), y and the
    weights.  A HybridCSR's packed BlockCOO tail is sharded over its
    blocks: pad_to_shards makes a rank's rows a whole number of blocks, so
    rank r keeps blocks [r nb/R, (r+1) nb/R) with their block-local row
    indices as they are; the int8 head's column scales are replicated."""
    y, weights = shard_rows(y, mesh), shard_rows(weights, mesh)
    if isinstance(x, HybridCSR):
        blk = x.blk_tail
        if blk is not None:
            if blk.n_blocks % mesh.size != 0:
                raise ValueError(f"{blk.n_blocks} tail blocks do not split evenly over {mesh.size} ranks")
            views = ("rows", "counts") + blk.ADDRESSED
            blk = replace(blk, **{f: shard_rows(getattr(blk, f), mesh) for f in views})
        x = HybridCSR(shard_rows(x.head, mesh), _shard_csr(x.tail, mesh), x.n_rows // mesh.size, x.n_cols,
                      blk_tail=blk, head_scale=x.head_scale)
    elif isinstance(x, PaddedCSR):
        x = _shard_csr(x, mesh)
    else:
        x = shard_rows(x, mesh)
    return x, y, weights


def shard_path_inputs(mesh: Mesh, x, y, weights, offs, state0: SagaState):
    """The rank's rows of everything fit_path reads by row: x, y, the
    weights, the offsets (or None) and the state's g_mem."""
    x, y, weights = shard_inputs(mesh, x, y, weights)
    offs = None if offs is None else shard_rows(offs, mesh)
    return x, y, weights, offs, state0._replace(g_mem=shard_rows(state0.g_mem, mesh))


def fit_path_sharded(x, y, weights, gammas, l1s, l2s, tol, state0: SagaState, family, penalty,
                     config: SolverConfig, mesh: Mesh, offs=None, pf=None, box=None, seed: int = 0, order_fn=None,
                     xc=None):
    """solver.saga.fit_path over the mesh: the global inputs (every rank
    passes the same) are sharded by rows (x, y, weights, offs, g_mem), the
    rest replicated, and the warm-started path runs SPMD with one
    all-reduce a step.  Returns fit_path's (state with the rank's g_mem
    shard, total epochs, PathResults), the same on every rank."""
    x, y, weights, offs, state0 = shard_path_inputs(mesh, x, y, weights, offs, state0)
    return fit_path(x, y, weights, gammas, l1s, l2s, tol, state0, family, penalty, replace(config, mesh=mesh),
                    offs=offs, pf=pf, box=box, seed=seed, order_fn=order_fn, xc=xc)
