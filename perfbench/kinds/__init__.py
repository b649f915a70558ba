"""Traffic kinds that are not built in: one file a kind, `<kind>.py`.

A traffic file's `kind` names the loop that runs it.  `workload.kind`
takes "epochs" and "fits" from `workload.KINDS`; any other kind is the
function `run` of this directory's `<kind>.py`, loaded by its path, so a
later cell brings its loop as a new file and edits none.

    run(cell, seed, seconds, traced, device, t0) -> workload.Outcome

receives:
- `cell`, the `manifest.Cell`: its name, `chips`, the configuration's
  file (`config`), the traffic file (`traffic`, its `kind` and the
  loop's parameters), `limits`, and the `end_to_end` and `per_layer`
  entries it reports;
- `seed`, the run's `--seed`, from which it makes its inputs and
  weights; `seconds`, the window's length (`--seconds`); `traced`,
  whether it runs the traced window (`--trace 1`, `trace.traced`);
- `device`, this process's card (`torch.device("cuda", rank)`);
- `t0`, the run's start on `time.perf_counter()`, from which `setup_s`
  counts (on several ranks: the parent's start, on CLOCK_MONOTONIC,
  which every process of the host reads alike).

It returns an `Outcome`:
- `end_to_end`: each end-to-end quantity of the cell by its name before
  the first dot (`nnz_per_s` for `nnz_per_s.multiclass`), `setup_s`
  among them;
- `attempted` and `failed`: the work the window attempted, and how much
  of it failed;
- `readings`: every number the cell's limits name, after the window has
  closed, the peak been read and the program's state freed;
- `peak_bytes`: `torch.cuda.max_memory_allocated` of its card;
- `ctx` and `summary`: what the cell's per-layer readers read, and the
  traced window's `trace.Summary` (None untraced).

On several ranks (`chips` above 1, `ranks.py`) every rank runs `run` in
a process of its own, card r for rank r, the default process group
already formed ("cpu:gloo,cuda:nccl"; the port's `init_multihost()`
finds it).  The kind then makes global what must be global itself:
- its window opens and closes at a `torch.distributed.barrier()` after
  a `torch.cuda.synchronize()` on every rank;
- rank 0's `end_to_end` is the whole group's: the work of every rank
  over rank 0's window, and `setup_s` to its window's opening; rank 0's
  `attempted` counts the whole group's work;
- each rank returns its own `failed` (summed over the ranks), its own
  `readings` (the worst of each over the ranks is judged; a rank may
  leave out a number that another compares), its own `peak_bytes` (the
  fullest card's is reported), and under `--trace 1` the Summary of its
  own card's trace (busy and window times averaged over the ranks);
- rank 0's `ctx` and Summary are what the per-layer readers and the
  breakdown read.
What a rank returns crosses to the parent as plain data: numbers,
strings, None, and lists, tuples and dicts of them; no tensor or array.
Everything a rank prints goes to standard error.

A kind imports triton and builds its kernels inside its functions, and
imports neither JAX nor the JAX package.
"""
