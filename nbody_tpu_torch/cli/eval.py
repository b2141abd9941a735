"""Evaluation CLI (port of nbody_tpu/cli/eval.py): restore a run's latest
checkpoint, evaluate, and judge the model against the linear-velocity
baseline.

    python -m nbody_tpu_torch.cli.eval -n myrun [the run's training flags]

Restores the latest checkpoint of the named run, runs the test sweep,
saves the result cube and the test errors in the reference layout, and
runs the quality leg: the model's median per-particle L2 distance to the
truth against that of the least-squares linear-velocity baseline
(physics/baseline.py), printed and appended to metrics.jsonl.  Pass the
run's data and model flags, so that the held-out split and the network
match.  Plots are nbody_tpu/viz's job over the Results directory:
``--plot`` is refused.
"""

from __future__ import annotations

import numpy as np

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import make_dataset
from nbody_tpu_torch.io_.saver import Saver
from nbody_tpu_torch.models.registry import resolve_device
from nbody_tpu_torch.physics.baseline import (calculate_timestep,
                                              get_linear_vel_pred, l2_dist)
from nbody_tpu_torch.train.trainer import Trainer


def quality_leg(x_test: np.ndarray, cube: np.ndarray, box: float) -> dict:
    """The model against the linear-velocity baseline (the JAX eval CLI's
    quality leg; reference visualization/plot_eval.py:85-93,130-147).

    x_test (n, N, C) test features, cube (2, n, N, out) the evaluate cube
    (slot 0 truth, slot 1 prediction).  The input snapshot is the ZA
    state (position = grid + za_disp; velocity proportional to za_disp in
    linear theory), so the baseline is amplitude-refitted ZA.  Positions
    are assembled in position space; the grid term cancels inside each L2
    series."""
    pos_in = x_test[..., :3] + box / 2.0 + x_test[..., 3:6]   # ZA positions
    x_input = np.concatenate([pos_in, x_test[..., 3:6]], axis=-1)
    truth = pos_in + cube[0][..., :3]                          # FastPM truth
    pred = pos_in + cube[1][..., :3]
    t_fit = calculate_timestep(x_input, truth)
    lin = get_linear_vel_pred(x_input, t_fit)
    med_model = float(np.median(l2_dist(pred, truth)))
    med_linear = float(np.median(l2_dist(lin, truth)))
    return {"quality_model_median_l2": med_model,
            "quality_linear_median_l2": med_linear,
            "linear_timestep_fit": t_fit,
            "quality_beats_baseline": med_model < med_linear}


def main(argv=None) -> int:
    p = C.build_parser()
    p.add_argument("--plot", type=str, default="",
                   help="Refused: plot the run's Results directory with "
                        "nbody_tpu.viz.plot_eval.plot_results_dir")
    args = p.parse_args(argv)
    if args.plot:
        raise NotImplementedError(
            "--plot is not ported: plot the run's Results directory with "
            "nbody_tpu.viz.plot_eval.plot_results_dir (matplotlib is not a "
            "dependency of nbody_tpu_torch)")
    cfg = C.config_from_args(args)
    if not args.name:
        p.error("-n/--name is required to locate the experiment")
    device = resolve_device(args.platform)

    saver = Saver(cfg.data.data_idx, model_tag=cfg.train.name,
                  experiments_dir=cfg.train.experiments_dir)
    dataset = make_dataset(cfg.data)
    trainer = Trainer(cfg, device, dataset=dataset, saver=saver)
    saver.restore_checkpoint(trainer)
    print(f"Restored checkpoint at step {trainer.step}")

    test_error, test_predictions = trainer.evaluate("test")
    saver.save_cube(test_predictions)
    saver.save_error(test_error)
    saver.print_evaluation_results(test_error)

    q = quality_leg(np.asarray(dataset.X_test[:test_predictions.shape[1]]),
                    test_predictions, trainer.box)
    beats = q["quality_beats_baseline"]
    print(f"L2 median: model {q['quality_model_median_l2']:.6f} vs "
          f"linear-velocity baseline {q['quality_linear_median_l2']:.6f} "
          f"(timestep fit {q['linear_timestep_fit']:+.5f}) — "
          f"{'model BEATS baseline' if beats else 'model does NOT beat baseline'}")
    saver.append_metrics(q)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
