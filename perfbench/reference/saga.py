"""Batched SAGA for an elastic-net GLM on a hybrid sparse design, written
plainly in float64.

The semantics are those the configurations state for the port's fit:

- The design's columns are split by use: the D most used columns (the
  fewest that cover `coverage` of the nonzeros, capped at `max_head` and
  by the memory budget, rounded up to 128) form a dense head stored in
  bfloat16 (or, for the control, int8 with a scale a column); the rest
  are a sparse tail.  Columns are permuted so that the head comes first,
  the tail's columns in ascending order.
- A product with the bfloat16 head takes bfloat16 operands: the
  coefficients, the gradient change and any vector are rounded to
  bfloat16 before they meet the head.  The tail is not rounded.
- A step over the rows [s, s + B) of the padded design:

      lp   = X_b w^T + intercept - w . xc
      g    = gradient(lp, y_b) * weight_b
      gc   = g - g_mem_b;   g_mem_b = g
      corr = gc^T X_b - (sum gc) xc
      w    = soft_threshold(w (1 - gamma l2) - gamma (corr / sum weight_b + g_sum), gamma l1)
      g_sum += corr / W
      intercept -= gamma decay (sum gc / sum weight_b + g_sum_intercept)
      g_sum_intercept += sum gc / W

  and an epoch takes the blocks in the order given, then recomputes
  g_sum = X^T g_mem / W exactly every `refresh_every` epochs.
- `fit_path` follows `fit()` on a scipy design: column statistics (the
  head's from its bfloat16 values), the head centred and scaled and
  rounded to bfloat16 again, the tail scaled with the centring carried as
  xc, the lambda sequence from lambda_max, the step sizes from the
  largest row norm and a 30-step power iteration, the rows shuffled once
  by the fit's seed, warm-started lambdas each run to max|dw| <= thresh
  max|w| with the halved-step retries, and the coefficients put back in
  the original units and column order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

F64 = torch.float64
#: binomial: the clamp of the null model's mean before the logit
P_MIN = 1e-9


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (through float32), back in float64."""
    return t.to(torch.float32).to(torch.bfloat16).to(F64)


def split_columns(x, coverage: float, max_head: int, memory_budget: float | None = None, itemsize: int = 2):
    """(perm, D): the head's width and the column order (head columns by
    use, most used first; then the tail's in ascending order)."""
    n, p = x.shape
    col_nnz = np.bincount(x.indices, minlength=p)
    order = np.argsort(-col_nnz, kind="stable")
    covered = np.cumsum(col_nnz[order])
    total = max(int(covered[-1]) if len(covered) else 0, 1)
    d = int(np.searchsorted(covered, coverage * total) + 1)
    if memory_budget is not None:
        d = min(d, max(int(memory_budget // (n * itemsize)), 1))
    d = max(min(d, max_head, p), 1)
    d = min(round_up(d, 128) if d < p else p, p)
    return np.concatenate([order[:d], np.sort(order[d:])]).astype(np.int64), d


@dataclass
class Design:
    """A design as the reference holds it: rows in the order the solver
    sees them, padded with zero rows to n_pad; columns in split order."""

    head: torch.Tensor  # (n_pad, D) bfloat16, or int8 with `scale`
    scale: torch.Tensor | None  # (D,) float64: an int8 head's value of one level
    tail: list  # per block of B rows: (rows within the block, columns, values float64)
    xc: torch.Tensor | None  # (p,) centring term, zero on the head's columns
    n: int  # real rows (the first n)
    p: int
    B: int

    @property
    def D(self) -> int:
        return self.head.shape[1]

    @property
    def n_pad(self) -> int:
        return self.head.shape[0]

    def block(self, s: int) -> torch.Tensor:
        x = self.head[s : s + self.B].to(F64)
        return x if self.scale is None else x * self.scale


def _chunks(n: int, D: int):
    step = max(1, (1 << 26) // max(D, 1))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def build_design(x, perm, D: int, B: int, device, precision: str = "bfloat16", standardize: bool = False,
                 row_perm=None):
    """The design of a canonical scipy CSR x (n, p) under the column split
    (perm, D): rows reordered by `row_perm` (row i is x's row_perm[i]),
    padded with zero rows to a multiple of B.  `precision` is the head's
    storage, "bfloat16" or "int8" (a symmetric scale a column, max / 127).
    With `standardize`, returns the column means and SDs (split order)
    beside the design; the head's real rows are centred and scaled, the
    tail scaled, and xc = mean / sd on the tail's columns.  A bfloat16
    head's statistics are those of the values it stores; an int8 head is
    made from the standardized raw values, and without `standardize`
    straight from the nonzeros.  Head-wide passes run over row chunks on
    the device."""
    if precision not in ("bfloat16", "int8"):
        raise ValueError(f"head precision must be bfloat16 or int8, got {precision!r}")
    n, p = x.shape
    n_pad = round_up(n, B)
    new_col = np.empty(p, np.int64)
    new_col[perm] = np.arange(p)
    rows = np.repeat(np.arange(n), np.diff(x.indptr))
    if row_perm is not None:
        inv = np.empty(n, np.int64)
        inv[np.asarray(row_perm)] = np.arange(n)
        rows = inv[rows]
    cols = new_col[x.indices]
    vals = x.data.astype(np.float32)
    is_head = cols < D
    hr, hc, hv = rows[is_head], cols[is_head], vals[is_head]
    tr, tc, tv = rows[~is_head], cols[~is_head], vals[~is_head].astype(np.float64)

    at = (torch.as_tensor(hr, device=device), torch.as_tensor(hc, device=device))
    scale = None
    if precision == "int8" and not standardize:  # quantized from the nonzeros: no float head
        hvd = torch.as_tensor(hv, dtype=F64, device=device)
        colmax = torch.zeros(D, dtype=F64, device=device).scatter_reduce_(0, at[1], torch.abs(hvd), "amax")
        scale = torch.where(colmax == 0.0, torch.ones_like(colmax), colmax / 127.0)
        head = torch.zeros((n_pad, D), dtype=torch.int8, device=device)
        head[at] = torch.clamp(torch.round(hvd / scale[at[1]]), -127, 127).to(torch.int8)
    else:
        store = torch.bfloat16 if precision == "bfloat16" else torch.float32
        head = torch.zeros((n_pad, D), dtype=store, device=device)
        head[at] = torch.as_tensor(hv, device=device).to(store)
    mean = sd = xc = None
    if standardize:
        tcd = torch.as_tensor(tc, device=device)
        tvd = torch.as_tensor(tv, dtype=F64, device=device)
        mean = torch.zeros(p, dtype=F64, device=device).index_add_(0, tcd, tvd) / n
        var = torch.clamp(torch.zeros(p, dtype=F64, device=device).index_add_(0, tcd, tvd * tvd) / n - mean**2,
                          min=0.0)
        if precision == "bfloat16":  # two passes over the stored head's rows
            h_mean = sum(torch.sum(head[s:e].to(F64), dim=0) for s, e in _chunks(n, D)) / n
            var[:D] = sum(torch.sum((head[s:e].to(F64) - h_mean) ** 2, dim=0) for s, e in _chunks(n, D)) / n
            mean[:D] = h_mean
        else:  # the int8 ingestion's one pass over the raw nonzeros
            hcd = torch.as_tensor(hc, device=device)
            hvd = torch.as_tensor(hv, dtype=F64, device=device)
            m1 = torch.zeros(p, dtype=F64, device=device).index_add_(0, hcd, hvd)[:D] / n
            var[:D] = torch.clamp(torch.zeros(p, dtype=F64, device=device).index_add_(0, hcd, hvd * hvd)[:D] / n
                                  - m1**2, min=0.0)
            mean[:D] = m1
        sd = torch.where(var == 0.0, torch.ones_like(var), torch.sqrt(var))
        tv = tv / sd.cpu().numpy()[tc]
        xc = mean / sd
        xc[:D] = 0.0

    def real_rows(s, e):
        z = head[s:e].to(F64)
        return z if mean is None else (z - mean[:D]) / sd[:D]

    if precision == "bfloat16":
        if standardize:
            for s, e in _chunks(n, D):
                head[s:e] = real_rows(s, e).to(torch.float32).to(torch.bfloat16)
    elif scale is None:
        colmax = torch.zeros(D, dtype=F64, device=device)
        for s, e in _chunks(n, D):
            colmax = torch.maximum(colmax, torch.amax(torch.abs(real_rows(s, e)), dim=0))
        scale = torch.where(colmax == 0.0, torch.ones_like(colmax), colmax / 127.0)
        q = torch.zeros((n_pad, D), dtype=torch.int8, device=device)
        for s, e in _chunks(n, D):
            q[s:e] = torch.clamp(torch.round(real_rows(s, e) / scale), -127, 127).to(torch.int8)
        head = q
    blocks = []
    blk = tr // B
    order = np.argsort(blk, kind="stable")
    bounds = np.searchsorted(blk[order], np.arange(n_pad // B + 1))
    for b in range(n_pad // B):
        sl = order[bounds[b] : bounds[b + 1]]
        blocks.append(tuple(torch.as_tensor(a, device=device) for a in (tr[sl] - b * B, tc[sl], tv[sl])))
    design = Design(head, scale, blocks, xc, n, p, B)
    return (design, mean, sd) if standardize else design


# ---------------------------------------------------------------------------
# the products
# ---------------------------------------------------------------------------


def tail_forward(design: Design, blk: int, w: torch.Tensor) -> torch.Tensor:
    """(B, k): the block's tail rows times w (k, p)."""
    r, c, v = design.tail[blk]
    return torch.zeros((design.B, w.shape[0]), dtype=F64, device=w.device).index_add_(0, r, v[:, None] * w.T[c])


def tail_outer(design: Design, blk: int, g: torch.Tensor) -> torch.Tensor:
    """(k, p): g (B, k) times the block's tail rows."""
    r, c, v = design.tail[blk]
    out = torch.zeros((design.p, g.shape[1]), dtype=F64, device=g.device).index_add_(0, c, v[:, None] * g[r])
    return out.T


def forward(design: Design, s: int, w: torch.Tensor, xb=None) -> torch.Tensor:
    """(B, k): X_b w^T - w . xc for the block starting at row s."""
    xb = design.block(s) if xb is None else xb
    lp = xb @ bf16(w[:, : design.D]).T + tail_forward(design, s // design.B, w)
    if design.xc is not None:
        lp = lp - w @ design.xc
    return lp


def backward(design: Design, s: int, g: torch.Tensor, xb=None) -> torch.Tensor:
    """(k, p): g^T X_b - (sum g) xc for the block starting at row s."""
    xb = design.block(s) if xb is None else xb
    corr = tail_outer(design, s // design.B, g)
    corr[:, : design.D] += bf16(g).T @ xb
    if design.xc is not None:
        corr = corr - torch.outer(torch.sum(g, dim=0), design.xc)
    return corr


def gradient(family: str, lp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if family == "binomial":
        return torch.sigmoid(lp) - y
    if family == "multinomial":
        return torch.softmax(lp, dim=1) - y
    raise ValueError(f"the reference has no family {family!r}")


def loss(family: str, lp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per row: the negative log-likelihood the solver minimizes."""
    if family == "binomial":
        z = lp[:, 0]
        return torch.logaddexp(torch.zeros_like(z), z) - y[:, 0] * z
    if family == "multinomial":
        return torch.logsumexp(lp, dim=1) - torch.sum(lp * y, dim=1)
    raise ValueError(f"the reference has no family {family!r}")


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


class State(NamedTuple):
    w: torch.Tensor  # (k, p)
    intercept: torch.Tensor  # (k,)
    g_mem: torch.Tensor  # (n_pad, k)
    g_sum: torch.Tensor  # (k, p)
    g_sum_intercept: torch.Tensor  # (k,)


def init_state(design: Design, k: int, intercept=None) -> State:
    dev = design.head.device
    z = dict(dtype=F64, device=dev)
    b = torch.zeros(k, **z) if intercept is None else torch.as_tensor(intercept, **z).reshape(k)
    return State(torch.zeros((k, design.p), **z), b, torch.zeros((design.n_pad, k), **z),
                 torch.zeros((k, design.p), **z), torch.zeros(k, **z))


@dataclass
class Problem:
    """What an epoch needs besides the state: the design, the response
    (n_pad, k) and row weights (n_pad,) in the design's row order, and the
    solver's settings."""

    design: Design
    y: torch.Tensor
    weights: torch.Tensor
    family: str
    intercept_decay: float
    refresh_every: int

    @property
    def w_total(self) -> float:
        return float(torch.clamp(torch.sum(self.weights), min=1e-12))


def step(pr: Problem, st: State, s: int, gamma: float, l1: float, l2: float) -> State:
    """One batched SAGA step over rows [s, s + B); updates st.g_mem in place."""
    d, B = pr.design, pr.design.B
    xb = d.block(s)
    lp = forward(d, s, st.w, xb) + st.intercept
    wb = pr.weights[s : s + B]
    g = gradient(pr.family, lp, pr.y[s : s + B]) * wb[:, None]
    gc = g - st.g_mem[s : s + B]
    st.g_mem[s : s + B] = g
    corr = backward(d, s, gc, xb)
    bw = torch.clamp(torch.sum(wb), min=1e-12)
    sum_gc = torch.sum(gc, dim=0)
    w_half = st.w * (1.0 - gamma * l2) - gamma * (corr / bw + st.g_sum)
    w_new = torch.sign(w_half) * torch.clamp(torch.abs(w_half) - gamma * l1, min=0.0)
    w_total = pr.w_total
    intercept = st.intercept - gamma * pr.intercept_decay * (sum_gc / bw + st.g_sum_intercept)
    return State(w_new, intercept, st.g_mem, st.g_sum + corr / w_total, st.g_sum_intercept + sum_gc / w_total)


def refresh(pr: Problem, st: State) -> State:
    """g_sum recomputed exactly from g_mem: X^T g_mem / W."""
    d = pr.design
    g_sum = torch.zeros_like(st.g_sum)
    for s in range(0, d.n_pad, d.B):
        g_sum += backward(d, s, st.g_mem[s : s + d.B])
    w_total = pr.w_total
    return st._replace(g_sum=g_sum / w_total, g_sum_intercept=torch.sum(st.g_mem, dim=0) / w_total)


def epoch(pr: Problem, st: State, order, gamma: float, l1: float, l2: float, it: int) -> State:
    """The blocks in `order` (block indices), then the refresh where epoch
    `it` (counted from 0) closes a period of `refresh_every`."""
    st = st._replace(g_mem=st.g_mem.clone())
    for b in np.asarray(order).tolist():
        st = step(pr, st, int(b) * pr.design.B, gamma, l1, l2)
    if pr.refresh_every <= 1 or (it + 1) % pr.refresh_every == 0:
        st = refresh(pr, st)
    return st


def mean_loss(pr: Problem, st: State) -> float:
    d = pr.design
    total = 0.0
    for s in range(0, d.n_pad, d.B):
        lp = forward(d, s, st.w) + st.intercept
        total += float(torch.sum(loss(pr.family, lp, pr.y[s : s + d.B]) * pr.weights[s : s + d.B]))
    return total / pr.w_total


# ---------------------------------------------------------------------------
# the path, as fit() runs it on a scipy design
# ---------------------------------------------------------------------------


def block_order(seed: int, lam: int, attempt: int, epoch_: int, n_blocks: int) -> torch.Tensor:
    """The fit's order of the blocks for one epoch: a permutation drawn from
    a generator seeded by (seed, lambda index, attempt, epoch)."""
    s = np.random.SeedSequence([seed, lam, attempt, epoch_]).generate_state(1, np.uint64)[0]
    return torch.randperm(n_blocks, generator=torch.Generator().manual_seed(int(s)))


def _stop(max_change, max_size, finite: bool, t_conv):
    """(done, rel) of an epoch, in float32 as the fit decides it."""
    f = np.float32
    max_change, max_size = f(max_change), f(max_size)
    finite = bool(finite and np.isfinite(max_size) and np.isfinite(max_change))
    still = max_size == 0.0 and max_change == 0.0
    done = still or not finite or (max_size != 0.0 and max_change <= f(t_conv) * max_size)
    rel = (max_change / max(max_size, f(1e-30))) if finite and max_size > 0.0 else (f(0.0) if finite else f(np.inf))
    return bool(done), rel


def _power_sq_norm(d: Design, real: torch.Tensor, seed: int, n_iter: int = 30) -> float:
    """lambda_max(Xc^T Xc) over the real rows by 30 power steps from the
    fit's seeded normal start (in split column order)."""
    v = torch.randn(d.p, generator=torch.Generator().manual_seed(seed), dtype=F64).to(d.head.device)
    v = v / torch.linalg.vector_norm(v)

    def matvec(v):
        u = torch.cat([forward(d, s, v[None, :])[:, 0] for s in range(0, d.n_pad, d.B)]) * real
        return sum(backward(d, s, u[s : s + d.B, None])[0] for s in range(0, d.n_pad, d.B))

    for _ in range(n_iter):
        u = matvec(v)
        v = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-30)
    return float(torch.dot(matvec(v), v))


def _row_sq_max(d: Design, real: torch.Tensor) -> float:
    best = 0.0
    for s in range(0, d.n_pad, d.B):
        xb = d.block(s)
        r = torch.sum(xb * xb, dim=1)
        rr, c, v = d.tail[s // d.B]
        sq = v * v
        if d.xc is not None:
            sq = sq - 2.0 * v * d.xc[c]
        r = r.index_add(0, rr, sq)
        if d.xc is not None:
            r = r + torch.sum(d.xc**2)
        best = max(best, float(torch.max(r * real[s : s + d.B])))
    return best


def step_sizes(max_sq: float, top_sq: float, l2s, n: float, B: int, L_scaling: float) -> np.ndarray:
    """Minibatch SAGA steps (expected smoothness, Gazagnadou et al. 2019),
    with an intercept."""
    l2s = np.asarray(l2s, np.float64)
    L_max = (max_sq + 1.0) * L_scaling + l2s
    L_full = (top_sq + 1.0) * L_scaling + l2s
    denom = max(B * (n - 1.0), 1.0)
    L_B = np.maximum((n * (B - 1.0)) / denom * L_full + max(n - B, 0.0) / denom * L_max, L_full)
    return 1.0 / (2.0 * L_B + np.minimum(L_B, 2.0 * n * l2s / B))


def fit_path(x, y, settings: dict, seed: int, device, precision: str = "bfloat16", follow: dict | None = None) -> dict:
    """The binomial elastic-net path of `fit(x, y, **settings, seed=seed)` on
    a canonical scipy CSR x and 0/1 labels y (n,).  Returns the lambdas,
    beta (n_lambda, 1, p) and a0 (n_lambda,) in the original units and
    column order, the epochs of each lambda, and `epoch_log`: the epochs of
    each attempt, {(lambda index, attempt): epochs}.

    The stop and retry tests compare a relative change with a threshold,
    and float32 iterates drift from float64 ones by about as much as an
    epoch near thresh 1e-3 changes them, so two sound paths stop apart.
    With `follow` (another path's `epoch_log`), each stop or retry that
    path decided is decided as it did; a decision it never met is the
    reference's own.  `followed` lists where that went against the
    reference's own test: (lambda index, attempt, epoch, the reference's
    change over the threshold)."""
    f32 = np.float32
    n, p = x.shape
    B = settings["batch_size"]
    alpha = settings["alpha"]
    perm, D = split_columns(x, settings["hybrid_coverage"], settings["hybrid_max_head"],
                            settings["hybrid_memory_budget"], 1 if precision == "int8" else 2)
    row_perm = np.random.default_rng(seed + 0x5EED).permutation(n)
    d, mean, sd = build_design(x, perm, D, B, device, precision, standardize=True, row_perm=row_perm)
    real = torch.zeros(d.n_pad, dtype=F64, device=device)
    real[:n] = 1.0
    yv = torch.zeros((d.n_pad, 1), dtype=F64, device=device)
    yv[:n, 0] = torch.as_tensor(np.asarray(y, np.float64)[row_perm], device=device)
    pr = Problem(d, yv, real, "binomial", 0.01, settings["g_sum_refresh_every"])

    # lambda_max from the null gradient of the standardized design
    ybar = float(torch.sum(yv) / n)
    ystd = float(np.sqrt(float(torch.sum(((yv[:n] - ybar) ** 2))) / n))
    ymap = (yv - ybar) / ystd * real[:, None]
    inner = sum(backward(Design(d.head, d.scale, d.tail, None, n, p, B), s, ymap[s : s + B])[0]
                for s in range(0, d.n_pad, B))
    lam_max = ystd * float(torch.max(torch.abs(inner))) / n / max(alpha, 0.001)
    lambdas = np.exp(np.linspace(np.log(lam_max), np.log(lam_max * settings["lambda_min_ratio"]),
                                 settings["nlambda"]))
    l1s, l2s = alpha * lambdas, (1.0 - alpha) * lambdas
    gammas = step_sizes(_row_sq_max(d, real), _power_sq_norm(d, real, seed) / n, l2s, n, B, 0.25)

    pm = min(max(ybar, P_MIN), 1.0 - P_MIN)
    st = init_state(d, 1, np.log(pm / (1.0 - pm)))
    tol, maxit, T = f32(settings["thresh"]), settings["maxit"], d.n_pad // B
    log, followed = {}, []

    def go_on(own: bool, rel, threshold, where, theirs) -> bool:
        """A decision to go on (another epoch, another attempt): `follow`'s
        where it made one, else the reference's own."""
        if theirs is None:
            return own
        if theirs != own:
            followed.append((*where, float(rel) / float(threshold)))
        return theirs

    def fit_one(st, gamma, l1, l2, lam, attempt, t_conv):
        it, done, rel, w_prev = 0, False, f32(0.0), st.w
        ran = None if follow is None else follow.get((lam, attempt))
        while not done and it < maxit:
            st = epoch(pr, st, block_order(seed, lam, attempt, it, T), gamma, l1, l2, it)
            done, rel = _stop(float(torch.max(torch.abs(st.w - w_prev))), float(torch.max(torch.abs(st.w))),
                              bool(torch.all(torch.isfinite(st.intercept))), t_conv)
            # the path's decision after this epoch: none past its last epoch, nor where maxit ends it
            theirs = None if ran is None or it >= ran or it + 1 >= maxit else ran > it + 1
            done = not go_on(not done, rel, t_conv, (lam, attempt, it), theirs)
            w_prev, it = st.w, it + 1
        log[(lam, attempt)] = it
        return st, (maxit if np.isinf(rel) else it), rel

    betas, a0s, epochs, bk = [], [], [], f32(1.0)
    for i in range(len(lambdas)):
        gamma, l1, l2 = f32(gammas[i]), f32(l1s[i]), f32(l2s[i])
        best = dict(state=st, obj=f32(np.inf))
        attempt, stop, bk_out, tot = 0, False, bk, 0
        while not stop and attempt < 3:
            gmul = f32(bk * f32(0.5) ** attempt)
            new, it_new, rel_new = fit_one(st, float(f32(gamma * gmul)), float(l1), float(l2), i, attempt,
                                           tol * max(gmul, f32(0.25)))
            code = it_new >= maxit
            obj = f32(mean_loss(pr, new) + float(l1) * float(torch.sum(torch.abs(new.w)))
                      + 0.5 * float(l2) * float(torch.sum(new.w**2)))
            obj = obj if np.isfinite(obj) else f32(np.inf)
            better = obj < best["obj"]
            if better:
                best = dict(state=new, obj=obj)
            if attempt > 0 and better and not code:
                bk_out = gmul
            retry = code if attempt == 0 else (code and go_on(
                bool(rel_new > 10.0 * tol), rel_new, 10.0 * tol, (i, attempt, it_new),
                None if follow is None or follow.get((i, attempt)) != it_new else (i, attempt + 1) in follow))
            attempt, stop, tot = attempt + 1, not retry, tot + it_new
        st, bk = best["state"], bk_out
        epochs.append(tot)
        betas.append(st.w.cpu().numpy().copy())
        a0s.append(st.intercept.cpu().numpy().copy())

    x_scale, x_center = sd.cpu().numpy(), mean.cpu().numpy()
    beta = np.stack(betas) / x_scale[None, None, :]
    tiny = 10 * np.finfo(np.float32).eps * max(1.0, np.abs(beta).max())
    beta[np.abs(beta) < tiny] = 0.0
    a0 = np.stack(a0s)[:, 0] - np.einsum("j,lj->l", x_center, beta[:, 0, :])
    out = np.empty_like(beta)
    out[:, :, perm] = beta
    scale = np.empty_like(x_scale)
    scale[perm] = x_scale
    return {"lambda": lambdas, "beta": out, "a0": a0, "epochs": np.asarray(epochs), "x_scale": scale,
            "epoch_log": log, "followed": followed}
