"""Export the slim policy file from a full checkpoint (port of
``gym_puzzles_tpu/train/export.py``).

A full checkpoint carries the whole TrainState, the env batch included (what
makes exact resume possible, and too heavy to commit).  Evaluation needs only
the policy: params, the obs/ret normalizer moments and ``timesteps`` (the
reference's model zip + VecNormalize pickle, train/train.py:148-149).  This
writes exactly that, as an ``.npz`` in the layout of
``convert.policy_to_npz`` (params as the flax ``ActorCritic`` names them), and
``checkpoint.restore_policy`` / ``convert.policy_from_npz`` read it:

    python -m gym_puzzles_tpu_torch.train.export \\
        --checkpoint models/MultiRobotPuzzle-v0 --out policy.npz

A pixel policy's file also records the image pipeline its checkpoint
recorded (``TrainState.image_pipeline``) and its obs shape.
"""

from __future__ import annotations

import argparse

from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.train import checkpoint as ckpt


def export(checkpoint_path, out_path, step: int | None = None) -> int:
    """Write the policy of the checkpoint at ``step`` (default: the latest)
    to ``out_path``; returns the step."""
    step = ckpt.latest_step(checkpoint_path) if step is None else step
    tree = ckpt.load(checkpoint_path, step)
    norm = {r: {k: v.numpy() for k, v in tree["normalizer"][r].items()}
            for r in ("obs_rms", "ret_rms")}
    pipeline = tree["image_pipeline"]
    obs_shape = None if pipeline is None else tuple(tree["last_obs"].shape[1:])
    convert.policy_to_npz(out_path, convert.params_to_numpy(tree["params"]), norm,
                          int(tree["timesteps"]), pipeline, obs_shape)
    return int(step)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint directory written by the trainer")
    p.add_argument("--out", required=True, help="policy file to write (.npz)")
    p.add_argument("--step", default=None, type=int)
    args = p.parse_args(argv)
    step = export(args.checkpoint, args.out, args.step)
    print(f"exported the policy of {args.checkpoint} (step {step}) -> {args.out}")


if __name__ == "__main__":
    main()
