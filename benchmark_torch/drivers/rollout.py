"""Driver of the traffic kind "rollout": the redshift chain forward only,
through ``train/rollout.make_rollout`` with the lattice margin monitor on
every hop's input, as ``cli/rollout`` runs it after training its pairs.

Set-up (counted in ``setup_s``): a pool of the traffic's cubes from the
seed, the model of the configuration, a seeded parameter set for every
hop (yardstick/weights.py, the last layer's weights scaled by the
traffic's ``last_scale`` so that a hop moves particles by about the size
of the truth's residual, as a trained pair does), stacked on a hop axis
as stack_params stacks them, and the traffic's ``warm_chains`` chains.

The window: chains one after another, a closed loop, each from ``batch``
cubes of the pool in a seeded order (``[grid - box/2, ZA displacement]``,
the first pair's input); each chain ends with the host's read of its
per-hop margin counts, which waits for the card.  Particle-hops per
second are all the hops of the chains the window completed times the
particles of a batch, over the window's time on the host clock.  A hop
whose margin count is not 0 (the lattice window may miss neighbors
there), or whose displacement is not finite, counts as failed.  With
``--trace 1`` a profiler covers ``trace_chains`` chains instead.

The check (after the window, the program's state freed): in a seeded
sample of the window's chains (the first, and one drawn from the seed),
each hop's reference is run on the program's own input to that hop (the
chain's first input the benchmark's own features of the same cubes,
yardstick/features.py), and compare.rollout_checks sets the program's
residuals beside its.
"""

from __future__ import annotations

import time
import types

import numpy as np

from benchmark_torch import compare
from benchmark_torch.harness import Result, Run, TraceView, derive_seed, profiler, reduce_profile
from benchmark_torch.reference import common
from benchmark_torch.yardstick import features
from benchmark_torch.yardstick.synthetic import synthetic_raw_cubes
from benchmark_torch.yardstick.weights import make_layers


def build(run: Run):
    """(rollout fn, stacked params, the program's pool x_in (P, N, 6) on
    the card, the reference's pool of the same cubes on the host, per-hop
    layer params for the reference)."""
    import torch
    from nbody_tpu_torch import config as C
    from nbody_tpu_torch.cli.rollout import margin_monitor
    from nbody_tpu_torch.data.dataset import features_from_raw
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.train.rollout import make_rollout

    cfg, tr = run.cell.config, run.cell.traffic
    cells = cfg["cells"]
    box = 4.0 * cells
    mcfg = C.ModelConfig(family=cfg["family"], channels=tuple(cfg["channels"]),
                         k_neighbors=cfg["k_neighbors"], dtype=cfg["dtype"],
                         knn_window=tr["knn_window"])
    model = build_model(mcfg, box=box, device=run.device)
    raw = synthetic_raw_cubes(cfg["num_samples"], cells, seed=derive_seed(run.seed, 1),
                              za_rms=tr["za_rms"])
    pool = torch.as_tensor(features_from_raw(raw)[..., :6], device=run.device)
    ref_pool = features.features(raw)[..., :6]
    ref = run.cell.reference
    hops = tr["hops"]
    layers = make_layers(cfg["channels"], ref.NUM_WEIGHTS, ref.NUM_BIASES,
                         derive_seed(run.seed, 3), run.device, copies=hops,
                         last_scale=tr["last_scale"])
    names = [n for n, _ in model.named_parameters()]
    nl = len(layers)
    stacked = dict(zip(names, [l["W"] for l in layers] + [l["B"] for l in layers]))
    if len(names) != 2 * nl:
        raise RuntimeError(f"unexpected parameters {names}")
    geometry = types.SimpleNamespace(cells=cells, box=box, num_particles=cells ** 3)
    rollout = make_rollout(model, coverage_fn=margin_monitor(mcfg, geometry))
    if run.tamper is not None:
        rollout = run.tamper(rollout)
    return rollout, stacked, pool, ref_pool, layers


def run(run: Run) -> Result:
    import torch
    tr = run.cell.traffic
    b, hops = tr["batch"], tr["hops"]
    rollout, stacked, pool, ref_pool, layers = build(run)
    order = np.random.default_rng(derive_seed(run.seed, 2))
    sample_at = {0, int(np.random.default_rng(derive_seed(run.seed, 4)).integers(
        1, tr["sample_range"]))}
    cuda = run.device.type == "cuda"

    from torch.profiler import record_function

    def one_chain():
        rows = order.choice(pool.shape[0], b, replace=False)
        x0 = pool.index_select(0, torch.as_tensor(rows, device=run.device))
        with record_function("bench: rollout chain"):
            disp, (traj, counts) = rollout(stacked, x0)
        with record_function("bench: margin counts read"):
            counts = counts.cpu().numpy()
        bad = int(np.sum(counts != 0)) + int(
            (~torch.isfinite(disp)).any().cpu()) * hops
        return rows, traj, min(bad, hops)

    for _ in range(tr["warm_chains"]):
        one_chain()
    if cuda:
        torch.cuda.synchronize(run.device)
    t_setup = time.perf_counter()
    run.spans.append(("setup", run.t0, t_setup))
    prof = None
    if run.trace:
        prof = profiler()
        prof.start()
    start = time.perf_counter()
    chains, failed, kept, last = 0, 0, {}, None
    while True:
        t_c = time.perf_counter()
        rows, traj, bad = one_chain()
        now = time.perf_counter()
        run.spans.append(("chain", t_c, now))
        failed += bad
        if chains in sample_at:
            kept[chains] = (rows, traj)
        last = (rows, traj)
        chains += 1
        if (run.trace and chains >= tr["trace_chains"]) or (
                not run.trace and now - start >= run.seconds):
            break
    secs = now - start
    if prof is not None:
        torch.cuda.synchronize(run.device)
        prof.stop()
    if len(kept) < len(sample_at):
        kept[chains - 1] = last
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    n = run.cell.config["cells"] ** 3 * b
    run.log(f"window: {chains} chains, {chains * hops} hops in {secs:.3f} s; "
            f"peak {peak} B; checking chains {sorted(kept)}")
    view = None
    if prof is not None:
        kernels, host = reduce_profile(prof)
        view = TraceView(kernels, host, chains * hops, secs, run.cell)
    del rollout, stacked, last
    if cuda:
        torch.cuda.empty_cache()
    gaps = reference_gaps(run, kept, ref_pool, layers)
    e2e = {"setup_s": t_setup - run.t0,
           "rollout_particle_hops_per_s": chains * hops * n / secs}
    return Result(e2e, chains * hops, failed, compare.rollout_checks(gaps, run.cell.limits),
                  peak, view)


def reference_gaps(run: Run, kept: dict, ref_pool, layers, cast=common.identity):
    """(relative L2, max over rms) of every hop of the kept chains {i:
    (pool rows, (hops, b, N, 3) displacements after each hop)}: each hop's
    reference on the program's input to that hop, the first hop's on the
    reference's pool."""
    import torch
    common.strict_f32()
    forward = run.cell.reference.make_forward(run.cell.config,
                                              run.cell.traffic["knn_window"])
    gaps = []
    with torch.no_grad():
        for rows, traj in kept.values():
            x0 = torch.as_tensor(ref_pool[rows], device=traj.device)
            q, disp = x0[..., :3], x0[..., 3:6]
            for t in range(traj.shape[0]):
                hop = [{"W": l["W"][t], "B": l["B"][t]} for l in layers]
                ref = torch.cat([forward(hop, torch.cat([q[j:j + 1], disp[j:j + 1]], -1),
                                         cast) for j in range(q.shape[0])])
                gaps.append(compare.hop_gaps(traj[t] - disp, ref))
                disp = traj[t]
    return gaps
