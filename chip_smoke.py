#!/usr/bin/env python3
"""Drive the PyTorch port (sgdnet_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card (nvidia-smi name and power limit), torch, CUDA and nvcc;
  2. build both hand-written kernels from csrc/ and report the seconds;
  3. K2 (fused head step) against its plain torch twin at the dense
     multinomial shape n_pad=65536, D=784, B=4096, f32 and bf16;
  4. K1 (whole-epoch kernel) against its twin, one epoch on the bundled
     datasets and a seeded poisson set;
  5. slice A: fit(abalone, gaussian, alpha=0.8) through K1, held against
     the plain step path on the card, predict/score, and a golden path;
  6. slice B: a 65536 x 784, 10-class dense multinomial fit through K2
     (10 lambdas), held against the plain step path on the card, with
     wall times and samples/s.
Then one JSON line per kernel and, last, {"ok": true, "device": {...}}.
The script needs the repository checkout and a CUDA device; it has no CPU
path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over `reps` calls (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: K2 against its twin
# ---------------------------------------------------------------------------


def phase_k2(rng, dev):
    from sgdnet_tpu_torch.solver import head_kernel as hk

    n_pad, B, start = 65536, 4096, 8192
    cases = [("gaussian", 784, 1), ("binomial", 784, 1), ("multinomial", 784, 10),
             ("mgaussian", 784, 10), ("binomial", 4096, 1)]
    worst_f32 = 0.0
    for family, D, k in cases:
        head32 = torch.as_tensor(rng.standard_normal((n_pad, D), dtype=np.float32), device=dev)
        # w scaled so lp is O(1), as on a fitted path
        w = torch.as_tensor(rng.standard_normal((k, D), dtype=np.float32) / np.sqrt(D), device=dev)
        lpe = torch.as_tensor(0.1 * rng.standard_normal((B, k), dtype=np.float32), device=dev)
        if family == "binomial":
            yb = (rng.random((B, k)) < 0.5).astype(np.float32)
        elif family == "multinomial":
            yb = np.eye(k, dtype=np.float32)[rng.integers(0, k, B)]
        else:
            yb = rng.standard_normal((B, k), dtype=np.float32)
        yb = torch.as_tensor(yb, device=dev)
        gm = torch.as_tensor(0.1 * rng.standard_normal((B, k), dtype=np.float32), device=dev)
        wb = torch.as_tensor((rng.random(B) < 0.9).astype(np.float32), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            head = head32.to(dtype)
            args = (head, start, w, lpe, yb, gm, wb, family)
            g, corr = hk.fused_head_step_at(*args)
            g_ref, corr_ref = hk.fused_head_step_reference(*args)
            torch.cuda.synchronize()
            eg = float((g - g_ref).abs().max())
            ec = float((corr - corr_ref).abs().max())
            cmax = float(corr_ref.abs().max())
            if dtype == torch.float32:
                ok = eg <= 1e-5 and ec <= 2e-3
                worst_f32 = max(worst_f32, eg, ec)
                bound = "g 1e-5, corr 2e-3"
            else:
                ok = eg <= 3e-2 and ec <= 2e-2 * max(cmax, 1.0)
                bound = "g 3e-2, corr 2e-2*max|corr|"
            print(f"  K2 {family:11s} D={D} k={k:2d} {str(dtype)[6:]:8s}: max|dg|={eg:.3e} "
                  f"max|dcorr|={ec:.3e} (max|corr|={cmax:.3e}; bound {bound}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K2 disagrees with its twin: {family} D={D} k={k} {dtype}")
    # time at the main path's shape: f32 multinomial k=10
    head = torch.as_tensor(rng.standard_normal((n_pad, 784), dtype=np.float32), device=dev)
    k = 10
    w = torch.as_tensor(rng.standard_normal((k, 784), dtype=np.float32) / 28.0, device=dev)
    lpe = torch.zeros((B, k), device=dev)
    yb = torch.as_tensor(np.eye(k, dtype=np.float32)[rng.integers(0, k, B)], device=dev)
    gm = torch.zeros((B, k), device=dev)
    wb = torch.ones((B,), device=dev)
    args = (head, start, w, lpe, yb, gm, wb, "multinomial")
    ms = cuda_ms(lambda: hk.fused_head_step_at(*args), 50)
    plain_ms = cuda_ms(lambda: hk.fused_head_step_reference(*args), 50)
    print(f"  K2 time at n_pad=65536 D=784 k=10 B=4096 f32: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms")
    return {"max_abs_err": worst_f32, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# phase 4: K1 against its twin
# ---------------------------------------------------------------------------


def _standardize(x):
    sd = x.std(0)
    sd[sd == 0] = 1.0
    return (x - x.mean(0)) / sd


def _k1_case(rng, dev, name, x, y, family_name, alpha, grouped=False, offs=None, pf=None):
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver import epoch_kernel as ek
    from sgdnet_tpu_torch.solver.stepsize import saga_step_sizes

    B = 32
    fam = get_family(family_name, smoothness=float(2 ** np.ceil(np.log2(max(2 * y.max(), 2.0))))
                     if family_name == "poisson" else 1.0)
    y_enc, _ = fam.encode(y)
    if family_name in ("gaussian", "mgaussian"):
        y_enc = _standardize(y_enc)
    pen = select_penalty(alpha, family_name, "grouped" if grouped else "ungrouped")
    x = _standardize(np.asarray(x, np.float64))
    n, p = x.shape
    k = y_enc.shape[1]
    n_pad = -(-n // B) * B
    T = n_pad // B

    def padrows(a):
        return np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:])]).astype(np.float32)

    t = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
    wts = padrows(np.ones(n))
    data = ek.pad_data(t(padrows(x)), t(padrows(y_enc)), t(wts),
                       None if offs is None else t(padrows(offs.reshape(n, -1))),
                       None if pf is None else t(pf.astype(np.float32)))
    P = data.x.shape[1]
    ps = ek.PadState(
        w=np.zeros((ek.KP, P), np.float32), ivec=np.zeros((2, ek.KP), np.float32),
        g_mem=np.zeros((n_pad, ek.KP), np.float32), g_sum=np.zeros((ek.KP, P), np.float32),
    )
    ps.w[:k, :p] = 0.1 * rng.standard_normal((k, p))
    ps.ivec[:, :k] = 0.1 * rng.standard_normal((2, k))
    ps.g_mem[:n, :k] = 0.1 * rng.standard_normal((n, k))
    ps.g_sum[:k, :p] = 0.01 * rng.standard_normal((k, p))
    ps = ek.PadState(*(t(a) for a in ps))
    max_sq = float((x**2).sum(1).max())
    top = float(np.linalg.eigvalsh(x.T @ x)[-1]) / n
    lam = 0.05
    gamma = float(saga_step_sizes(max_sq, top, [(1 - alpha) * lam], n, B, True, fam.L_scaling)[0])
    starts = torch.as_tensor(rng.permutation(T) * B, dtype=torch.int32, device=dev)
    args = (data, ps, starts, B, fam, pen, gamma, alpha * lam, (1 - alpha) * lam, float(n))
    out = ek.saga_epoch(*args)
    ref = ek.epoch_reference(*args)
    torch.cuda.synchronize()
    rel = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(out, ref))
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    pads_zero = float(out.w[k:].abs().max() if k < ek.KP else 0.0) == 0.0 and float(out.w[:, p:].abs().max()) == 0.0
    ok = rel <= 1e-4 and pads_zero
    extras = "+offs" if offs is not None else ""
    extras += "+pf" if pf is not None else ""
    print(f"  K1 {name:8s} {family_name:11s} {pen.name:11s}{extras:8s} n_pad={n_pad} P={P} k={k}: "
          f"rel err {rel:.3e} (bound 1e-4), pads zero: {pads_zero} {'ok' if ok else 'FAIL'}")
    check(ok, f"K1 disagrees with its twin on {name}")
    return err, args


def phase_k1(rng, dev):
    from sgdnet_tpu_torch import data as d
    from sgdnet_tpu_torch.solver import epoch_kernel as ek

    worst = 0.0
    xa, ya = d.load_abalone()
    err, timing_args = _k1_case(rng, dev, "abalone", xa, ya, "gaussian", 0.8)
    worst = max(worst, err)
    xh, yh = d.load_heart()
    pf = np.ones(xh.shape[1])
    pf[0], pf[3] = 0.0, 3.0
    err, _ = _k1_case(rng, dev, "heart", xh, yh, "binomial", 0.0,
                      offs=0.2 * rng.standard_normal(len(yh)), pf=pf)
    worst = max(worst, err)
    xw, yw = d.load_wine()
    err, _ = _k1_case(rng, dev, "wine", xw, yw, "multinomial", 0.9, grouped=True)
    worst = max(worst, err)
    xs, ys = d.load_student()
    err, _ = _k1_case(rng, dev, "student", xs, ys, "mgaussian", 0.5)
    worst = max(worst, err)
    xp = rng.standard_normal((600, 12))
    yp = rng.poisson(np.exp(0.3 + xp @ (0.3 * rng.standard_normal(12)))).astype(np.float64)
    err, _ = _k1_case(rng, dev, "poisson", xp, yp, "poisson", 0.5)
    worst = max(worst, err)
    ms = cuda_ms(lambda: ek.saga_epoch(*timing_args), 50)
    plain_ms = cuda_ms(lambda: ek.epoch_reference(*timing_args), 5)
    print(f"  K1 time, one abalone epoch (n_pad=4192, P=128, B=32, 131 steps): kernel {ms:.4f} ms, "
          f"plain torch {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# phases 5 and 6: the fit path
# ---------------------------------------------------------------------------


def _rel_diff(a, b) -> float:
    """max |a - b| / max(1, max |b|)"""
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def run_slice_a(dev):
    import sgdnet_tpu_torch as st

    x, y = st.load_abalone()
    t0 = time.perf_counter()
    f = st.fit(x, y, family="gaussian", alpha=0.8, device=dev)
    return f, time.perf_counter() - t0


def check_slice_a(f, wall, launches, dev, card):
    import sgdnet_tpu_torch as st

    x, y = st.load_abalone()
    print(f"  slice A (abalone gaussian alpha=0.8, 100 lambdas, K1): {wall:.3f} s wall, {f.npasses} epochs, "
          f"{launches} K1 launches, epoch_kernel={f.stats['epoch_kernel']} [{card}]")
    check(f.stats["epoch_kernel"] is True, "slice A did not run through K1")
    check(launches > 0, "slice A launched K1 no time")
    dr = f.dev_ratio
    check(np.isfinite(dr).all() and np.isfinite(f.beta).all(), "slice A: non-finite path")
    check(np.all(np.diff(dr) >= -1e-6), f"slice A: dev_ratio decreases along the path: {np.diff(dr).min()}")
    t0 = time.perf_counter()
    f_plain = st.fit(x, y, family="gaussian", alpha=0.8, device=dev, use_epoch_kernel=False,
                     sampling="block")
    wall_plain = time.perf_counter() - t0
    check(f_plain.stats["epoch_kernel"] is False, "plain slice A ran the kernel")
    rel = _rel_diff(f.beta, f_plain.beta)
    print(f"  slice A plain step path: {wall_plain:.3f} s wall, {f_plain.npasses} epochs; "
          f"K1 vs plain max|dbeta|/scale = {rel:.3e} (bound 1e-3) [{card}]")
    check(rel <= 1e-3, "slice A: K1 fit disagrees with the plain step path")
    pred = f.predict(x, type="response")
    sc = f.score(x, y)
    check(pred.shape == (x.shape[0], f.n_lambda) and np.isfinite(pred).all(), "slice A: bad predictions")
    check(sc.shape == (f.n_lambda,) and np.isfinite(sc).all() and sc[-1] < sc[0], "slice A: bad scores")
    print(f"  slice A predict {pred.shape} finite; score (mse) {sc[0]:.4f} -> {sc[-1]:.4f}")
    # the golden path (sklearn coordinate descent, f64), as tests/test_golden.py
    g = np.load(os.path.join(ROOT, "tests", "golden", "abalone.npz"))
    fg = st.fit(x, y, alpha=1.0, nlambda=10, thresh=1e-6, maxit=5000, device=dev)
    check(fg.stats["epoch_kernel"] is True, "golden fit did not run through K1")
    np.testing.assert_allclose(fg.lambda_, g["a1.0_s1_lambda"], rtol=1e-6)
    rel_g = _rel_diff(fg.beta[:, 0, :], g["a1.0_s1_beta"])
    print(f"  slice A golden path (alpha=1, f32 through K1): max|dbeta|/scale = {rel_g:.3e} (bound 2e-3)")
    check(rel_g <= 2e-3, "slice A: K1 fit misses the golden path")
    return {"wall_s": wall, "epochs": f.npasses, "plain_wall_s": wall_plain, "plain_epochs": f_plain.npasses}


def _multinomial_data(seed: int, n=65536, p=784, k=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p), dtype=np.float32)
    beta = np.zeros((p, k), np.float32)
    active = rng.choice(p, 60, replace=False)
    beta[active] = rng.standard_normal((60, k), dtype=np.float32) / np.sqrt(15.0)
    logits = x @ beta + rng.gumbel(size=(n, k)).astype(np.float32)
    return x, logits.argmax(1)


SLICE_B = dict(family="multinomial", alpha=0.9, nlambda=10, lambda_min_ratio=0.01, maxit=100,
               batch_size=4096, sampling="block")


def run_slice_b(dev, seed):
    import sgdnet_tpu_torch as st

    x, y = _multinomial_data(seed)
    xt = torch.as_tensor(x, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = st.fit(xt, y, use_pallas=True, device=dev, seed=seed, **SLICE_B)
    return f, time.perf_counter() - t0, xt, y


def check_slice_b(f, wall, launches, xt, y, dev, card, seed):
    import sgdnet_tpu_torch as st

    n = xt.shape[0]
    check(f.stats["head_kernel"] is True and launches > 0, "slice B did not run through K2")
    check(np.isfinite(f.beta).all() and np.isfinite(f.dev_ratio).all(), "slice B: non-finite path")
    t0 = time.perf_counter()
    f_plain = st.fit(xt, y, use_pallas=False, device=dev, seed=seed,
                     **{**SLICE_B, "nlambda": None, "lambda_path": f.lambda_})
    wall_plain = time.perf_counter() - t0
    check(f_plain.stats["head_kernel"] is False, "plain slice B ran the kernel")
    rel = _rel_diff(f.beta, f_plain.beta)
    # samples/s over the whole fit() call and over the lambda path alone
    sps, sps_plain = f.npasses * n / wall, f_plain.npasses * n / wall_plain
    path_sps = f.npasses * n / f.stats["wall_time_s"]
    path_sps_plain = f_plain.npasses * n / f_plain.stats["wall_time_s"]
    print(f"  slice B (65536 x 784, k=10, B=4096, block, 10 lambdas) through K2: {wall:.3f} s fit wall "
          f"({f.stats['wall_time_s']:.3f} s path), {f.npasses} epochs, {sps:.4g} samples/s "
          f"({path_sps:.4g} on the path), {launches} K2 launches [{card}]")
    print(f"  slice B plain step path: {wall_plain:.3f} s fit wall ({f_plain.stats['wall_time_s']:.3f} s path), "
          f"{f_plain.npasses} epochs, {sps_plain:.4g} samples/s ({path_sps_plain:.4g} on the path) [{card}]")
    print(f"  slice B K2 vs plain max|dbeta|/scale = {rel:.3e} (bound 1e-3); dev_ratio {f.dev_ratio.round(4)}")
    check(rel <= 1e-3, "slice B: K2 fit disagrees with the plain step path")
    return {"wall_s": wall, "path_s": f.stats["wall_time_s"], "epochs": f.npasses, "samples_per_s": sps,
            "path_samples_per_s": path_sps, "plain_wall_s": wall_plain,
            "plain_path_s": f_plain.stats["wall_time_s"], "plain_epochs": f_plain.npasses,
            "plain_samples_per_s": sps_plain, "plain_path_samples_per_s": path_sps_plain}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sgdnet_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is enabled globally")
    rng = np.random.default_rng(args.seed)

    print("phase 1: card")
    card = card_line()
    print(card)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}; {torch.cuda.get_device_name(0)}")

    print("phase 2: build")
    build.load_library()
    info = build.build_info()
    print(f"  {'built' if info['built'] else 'loaded'} {os.path.relpath(info['path'], ROOT)} "
          f"in {info['seconds']:.2f} s")

    print("phase 3: K2 vs twin")
    k2 = phase_k2(rng, dev)
    print("phase 4: K1 vs twin")
    k1 = phase_k1(rng, dev)

    print("phases 5-6: the main path (slice A through K1, slice B through K2)")
    from sgdnet_tpu_torch.solver import epoch_kernel as ek
    from sgdnet_tpu_torch.solver import head_kernel as hk

    ek.saga_epoch.launches = 0
    hk.fused_head_step_at.launches = 0
    fit_a, wall_a = run_slice_a(dev)
    fit_b, wall_b, xt, y = run_slice_b(dev, args.seed)
    k1_launches, k2_launches = ek.saga_epoch.launches, hk.fused_head_step_at.launches
    print(f"  launches in the main path: K1 {k1_launches}, K2 {k2_launches}")
    print("phase 5: slice A")
    slice_a = check_slice_a(fit_a, wall_a, k1_launches, dev, card)
    print("phase 6: slice B")
    slice_b = check_slice_b(fit_b, wall_b, k2_launches, xt, y, dev, card, args.seed)
    print(json.dumps({"card": card, "build_s": info["seconds"], "slice_a": slice_a, "slice_b": slice_b}))

    print(json.dumps({"kernels": [
        {"name": "saga_epoch (K1)", "route": "cuda", "source": "sgdnet_tpu_torch/csrc/epoch_kernel.cu",
         "replaces": "sgdnet_tpu/solver/epoch_kernel.py:290", "launches": k1_launches, **k1},
        {"name": "fused_head_step_at (K2)", "route": "cuda", "source": "sgdnet_tpu_torch/csrc/head_step.cu",
         "replaces": "sgdnet_tpu/solver/pallas_kernels.py:265", "launches": k2_launches, **k2},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
