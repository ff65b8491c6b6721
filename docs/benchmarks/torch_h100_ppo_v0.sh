#!/bin/sh
# PPO on MultiRobotPuzzle-v0 with the PyTorch package on one GPU, by the JAX
# package's two-leg recipe (the config headers of ppo_v0_leg{1,2}_r4.jsonl),
# then the eval CLI on the result at seeds 0, 1 and 2 (128 deterministic
# episodes each).  Run from the repo root:
#
#     sh docs/benchmarks/torch_h100_ppo_v0.sh OUT_DIR
#
# OUT_DIR gets card.txt (the card's name and power limit), leg1.jsonl /
# leg2.jsonl (the trainer's stdout: its config line, then one JSON line per
# update), eval_seed{0,1,2}.json (the eval CLI's row), times.txt (wall
# seconds of each command) and the checkpoints under models/.
set -eu
out=${1:?usage: torch_h100_ppo_v0.sh OUT_DIR}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
: > "$out/times.txt"

timed() {  # timed NAME COMMAND...: run COMMAND, append its wall seconds
    name=$1
    shift
    t0=$(date +%s.%N)
    "$@"
    echo "$name $(python3 -c "import sys, time; print(time.time() - float(sys.argv[1]))" "$t0")" \
        | tee -a "$out/times.txt"
}

recipe="--config train_configs/ppo-mrp-v0.json --n_envs 4096 --n_steps 64 --batch_size 8192"
recipe="$recipe --n_epochs 4 --seed 0 --disable_wandb --save_model"
# shellcheck disable=SC2086
timed leg1 sh -c "python -m gym_puzzles_tpu_torch.train.cli $recipe \
    --total_timesteps 80000000 --checkpoint_dir $out/models/leg1 > $out/leg1.jsonl"
# leg 2 resumes leg 1's whole TrainState: --total_timesteps counts the steps
# of this leg (381 updates), as in the JAX package's CLI
timed leg2 sh -c "python -m gym_puzzles_tpu_torch.train.cli $recipe --ent_coef 0.002 \
    --total_timesteps 100000000 --resume $out/models/leg1/MultiRobotPuzzle-v0 \
    --checkpoint_dir $out/models/leg2 > $out/leg2.jsonl"
for seed in 0 1 2; do
    timed "eval_seed$seed" sh -c "python -m gym_puzzles_tpu_torch.train.evaluate \
        --checkpoint $out/models/leg2/MultiRobotPuzzle-v0 --batched --n_episodes 128 \
        --seed $seed > $out/eval_seed$seed.json"
done
tail -n 2 "$out/leg2.jsonl"
cat "$out/times.txt"
