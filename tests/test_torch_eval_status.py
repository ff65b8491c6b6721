"""The eval CLI counts as completions only the episodes that end in success
(``done_status`` 3): on v2 an episode also ends when an agent leaves the
bounds (status 1), and that is no completion.  The row records the engine
that ran (``'plain'`` on the CPU)."""

import json

import torch

from gym_puzzles_tpu_torch.envs import common as cm
from gym_puzzles_tpu_torch.envs import config as C
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import evaluate
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig

torch.set_num_threads(1)

ENV_ID = "MultiRobotPuzzle-v2"


def test_out_of_bounds_end_is_not_a_completion(monkeypatch, tmp_path, capsys):
    """Three v2 lanes from reset: lane 0 with an agent moved past the bounds
    (ends at step 1, status 1), lane 1 with its goal moved onto the block
    (ends at step 1, status 3), lane 2 left running."""
    algo = PPO(PPOConfig(env_id=ENV_ID, n_envs=1, n_steps=2, batch_size=2, n_epochs=1,
                         velocity_iters=8, position_iters=4), device="cpu")
    path = tmp_path / ENV_ID
    ckpt.save(path, algo.init_state(), 0)

    make_eval_env = evaluate.make_eval_env

    def injected(*args, **kw):
        env = make_eval_env(*args, **kw)
        reset = env.reset

        def reset_and_inject(seed=0, params=None):
            state, obs = reset(seed, params)
            lay = env.logic.layout
            pos = state.bodies.pos.clone()
            pos[int(lay.agent_slots[0]), 0, 0] = -1.0  # beyond 0.1 m, clear of the wall
            goal = state.goal_pos.clone()
            goal[:2, 1] = cm.centers(lay, state.bodies)[0][:, 1] * C.V2_RATIO
            return state.replace(bodies=state.bodies.replace(pos=pos), goal_pos=goal), obs

        env.reset = reset_and_inject
        return env

    monkeypatch.setattr(evaluate, "make_eval_env", injected)
    evaluate.main(["--checkpoint", str(path), "--env", ENV_ID, "--device", "cpu", "--batched",
                   "--n_episodes", "3", "--max_steps", "2", "--velocity_iters", "8",
                   "--position_iters", "4"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["lengths"] == [1, 1, 2]
    assert row["done_status"] == [1, 3, 0]
    assert row["completions"] == 1
    assert row["eval_backend"] == "plain"
