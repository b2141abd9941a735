"""Redshift-chain CLI (port of nbody_tpu/cli/rollout.py): train one model
per redshift pair, then evaluate the chained rollout.

    python -m nbody_tpu_torch.cli.rollout --steps 4 -i 200 -b 4 --cells 32 \\
        --synthetic -t 8 --dtype bfloat16
    python -m nbody_tpu_torch.cli.rollout --platform cpu --model set \\
        --steps 2 -i 8 -b 2 -t 2 --cells 8 --synthetic -c 6 8 3

  1. one Trainer per adjacent redshift pair (z_t -> z_t+1), all of one
     architecture, so their parameters stack (``fit``, or ``fit_scan``
     with --scan T); each pair's Trainer runs the refusing coverage guard;
  2. one rollout over the whole chain (train/rollout.py) from the first
     pair's test inputs, with the conservative lattice margin monitor
     (ops/knn.lattice_violations) on every hop's input for the graph
     families, which warns and records as the JAX CLI does;
  3. per-hop position MSE against the truth chain, and per-hop median L2
     of the model, the truth-reset linear baseline and the
     autoregressive linear baseline (physics/baseline.py); the truth and
     prediction trajectories go to the run's Results as one cube, the
     record to metrics.jsonl, and the last line is a JSON summary.

With synthetic data, pair t's cubes are generated with ZA amplitude
0.6 + 0.15 t, so that the hops are correlated and displacements grow
along the chain.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import Dataset, split_batch
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.io_.saver import Saver
from nbody_tpu_torch.models.registry import resolve_device
from nbody_tpu_torch.ops.knn import lattice_violations
from nbody_tpu_torch.physics.baseline import calculate_timestep, l2_dist
from nbody_tpu_torch.physics.losses import loss_za
from nbody_tpu_torch.train.rollout import (check_chain_family, make_rollout,
                                           stack_params)
from nbody_tpu_torch.train.trainer import Trainer


def build_chain_parser():
    p = C.build_parser()
    p.add_argument("--steps", type=int, default=4,
                   help="Number of redshift pairs in the chain (max 19)")
    return p


def synthetic_chain_raw(num_samples: int, cells: int, steps: int, seed: int):
    """Per-pair raw cubes with growth-scaled ZA amplitude 0.6 + 0.15 t."""
    return [synthetic_raw_cubes(num_samples=num_samples, cells=cells,
                                seed=seed, za_rms=0.6 + 0.15 * t)
            for t in range(steps)]


def margin_monitor(mcfg: C.ModelConfig, dataset: Dataset):
    """The graph families' in-chain coverage monitor: x_in (b, N, 6) ->
    the count of particles displaced beyond the lattice window's
    conservative margin (ops/knn.lattice_violations), on the device.
    Displacements grow along the chain, so the window that covered the
    first hop can stop covering later ones.  None for set and attn, and
    where the graph does not come from the lattice search (knn_method
    other than "lattice", or not a full cells^3 cube; cli/rollout.py:80-100)."""
    cells, box = dataset.cells, dataset.box
    if (mcfg.family in C.GRAPHLESS_FAMILIES or mcfg.knn_method != "lattice"
            or dataset.num_particles != cells ** 3):
        return None

    def monitor(x_in):
        pos = x_in[..., :3] + box / 2.0 + x_in[..., 3:6]
        return lattice_violations(pos, cells, box=box, window=mcfg.knn_window)

    return monitor


def truth_chain(datasets):
    """(x0 (n, N, 6), truth (T, n, N, 3), hop_za (T, n, N, 3)), numpy:
    the first pair's test inputs, the true displacement after each hop,
    accumulated the way the rollout accumulates its predictions, and each
    hop's ZA field (the linear baselines' velocity proxy)."""
    ntest = datasets[0].X_test.shape[0]
    x0, _ = split_batch(datasets[0].X_test)
    truth, hop_za = [], []
    disp = x0[..., 3:6]
    for ds in datasets:
        xt, y = split_batch(ds.X_test[:ntest])
        disp = disp + y[..., :3]
        truth.append(disp)
        hop_za.append(xt[..., 3:6])
    return x0, np.stack(truth), np.stack(hop_za)


def linear_baselines(x0_disp: np.ndarray, truth: np.ndarray,
                     hop_za: np.ndarray):
    """Per-hop median L2 of the truth-reset linear baseline (hop t starts
    from the true state at t-1 and moves by a least-squares multiple of
    the hop's ZA field; reference plot_multiStep_comp,
    visualization/plot_eval.py:210-246) and of the autoregressive one,
    which carries its own state hop to hop like the model.  truth and
    hop_za (T, b, N, 3)."""
    med_lin, med_chain = [], []
    lin_chain = x0_disp
    for t in range(truth.shape[0]):
        in_disp = x0_disp if t == 0 else truth[t - 1]
        t_fit = calculate_timestep(np.concatenate([in_disp, hop_za[t]], -1),
                                   truth[t])
        med_lin.append(float(np.median(l2_dist(in_disp + t_fit * hop_za[t],
                                               truth[t]))))
        lin_chain = lin_chain + t_fit * hop_za[t]
        med_chain.append(float(np.median(l2_dist(lin_chain, truth[t]))))
    return med_lin, med_chain


def main(argv=None) -> int:
    args = build_chain_parser().parse_args(argv)
    cfg = C.config_from_args(args)
    check_chain_family(cfg.model.family)
    device = resolve_device(args.platform)
    steps = min(args.steps, len(C.REDSHIFTS) - 1)

    saver = Saver(cfg.data.data_idx, model_tag=cfg.train.name or "chain",
                  experiments_dir=cfg.train.experiments_dir)
    datasets = [Dataset(cfg.data, raw=raw) for raw in synthetic_chain_raw(
        cfg.data.synthetic_num_samples, cfg.data.cells_per_side, steps,
        cfg.data.seed)]

    params_seq, model = [], None
    for t in range(steps):
        print(f"\n=== pair {t}: z {C.REDSHIFTS[t]} -> {C.REDSHIFTS[t + 1]} ===")
        trainer = Trainer(cfg, device, dataset=datasets[t])
        if cfg.train.scan_chunk > 0:
            trainer.fit_scan(scan_chunk=cfg.train.scan_chunk, verbose=True)
        else:
            trainer.fit(verbose=True)
        params_seq.append(dict(trainer.model.named_parameters()))
        model = trainer.model

    cov_fn = margin_monitor(cfg.model, datasets[0])
    x0, truth_np, hop_za = truth_chain(datasets)
    _, traj = make_rollout(model, coverage_fn=cov_fn)(
        stack_params(params_seq), torch.as_tensor(x0, device=device))
    cov_counts = None
    if cov_fn is not None:
        traj, cov_counts = traj
        cov_counts = cov_counts.cpu().numpy()
        if cov_counts.any():
            print(f"WARNING: lattice coverage margin violated mid-chain "
                  f"(per-step counts {cov_counts.tolist()}) — displacement "
                  "growth exceeds the search window; increase knn_window.")
    truth_dev = torch.as_tensor(truth_np, device=device)
    per_step_mse = np.asarray([float(loss_za(a, b))
                               for a, b in zip(traj, truth_dev)])
    traj_np = traj.cpu().numpy()
    med_model = [float(np.median(l2_dist(traj_np[t], truth_np[t])))
                 for t in range(steps)]
    med_lin, med_lin_chain = linear_baselines(x0[..., 3:6], truth_np, hop_za)
    print("\nRollout per chain step: position MSE, median L2 "
          "(model | truth-reset linear | autoregressive linear):")
    for t, m in enumerate(per_step_mse):
        beat = ("BEATS" if med_model[t] < med_lin_chain[t]
                else "does NOT beat")
        print(f"  step {t} (z {C.REDSHIFTS[t]:.3f} -> {C.REDSHIFTS[t+1]:.3f})"
              f" : mse {m:.6f} | med {med_model[t]:.6f} vs lin-reset "
              f"{med_lin[t]:.6f} vs lin-chain {med_lin_chain[t]:.6f} "
              f"({beat} the like-for-like baseline)")
    saver.save_cube(np.stack([truth_np, traj_np]))
    rec = {"rollout_mse": per_step_mse.tolist(), "steps": steps,
           "rollout_model_median_l2": med_model,
           "rollout_linear_median_l2": med_lin,
           "rollout_linear_chain_median_l2": med_lin_chain}
    if cov_counts is not None:
        rec["coverage_margin_violations"] = cov_counts.tolist()
    saver.append_metrics(rec)
    print(json.dumps({"rollout_final_mse": float(per_step_mse[-1]),
                      "rollout_model_median_l2": med_model,
                      "rollout_linear_median_l2": med_lin,
                      "rollout_linear_chain_median_l2": med_lin_chain}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
