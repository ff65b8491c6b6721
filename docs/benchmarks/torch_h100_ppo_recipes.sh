#!/bin/sh
# PPO with the PyTorch package on one GPU by one of the JAX package's flat
# variant recipes (the config headers of its run records named below), then
# the eval CLI on the result at seeds 0, 1 and 2 (128 deterministic episodes
# each), then the final policy exported.  Run from the repo root:
#
#     sh docs/benchmarks/torch_h100_ppo_recipes.sh RECIPE OUT_DIR
#
# RECIPE is one of
#   v2   MultiRobotPuzzle-v2, ppo_v2_leg{1,2}_r4.jsonl: train_configs/ppo-mrp-v2.json
#        at 4096 envs, seed 3, update_goal; 30M steps, then resumed at ent_coef
#        0.002 for 65M more (94,633,984 in all)
#   hv2  MultiRobotPuzzleHeavy-v2, ppo_hv2_leg{1,2}_r4.jsonl: the v2 recipe
#   v3   MultiRobotPuzzle-v3, ppo_v3_retrain_r4.jsonl: train_configs/ppo-mrp-v3.json
#        at 4096 envs x 64 steps, batch 8192, 4 epochs, seed 17; one leg of 120M
#        steps (119,799,808)
# (v0's two legs: torch_h100_ppo_v0.sh.)  OUT_DIR gets card.txt (the card's
# name and power limit), leg1.jsonl [/ leg2.jsonl] (the trainer's stdout: its
# config line, then one JSON line per update), eval_seed{0,1,2}.json (the
# eval CLI's row), times.txt (wall seconds of each command), policy.npz (the
# final checkpoint through train/export.py) and the checkpoints under models/.
set -eu
recipe=${1:?usage: torch_h100_ppo_recipes.sh RECIPE OUT_DIR}
out=${2:?usage: torch_h100_ppo_recipes.sh RECIPE OUT_DIR}
v2="--config train_configs/ppo-mrp-v2.json --n_envs 4096 --seed 3 --update_goal"
case $recipe in
    v2) env=MultiRobotPuzzle-v2 flags=$v2 leg1=30000000 leg2=65000000 ;;
    hv2) env=MultiRobotPuzzleHeavy-v2 flags="$v2 --env $env" leg1=30000000 leg2=65000000 ;;
    v3) env=MultiRobotPuzzle-v3 leg1=120000000 leg2=
        flags="--config train_configs/ppo-mrp-v3.json --n_envs 4096 --n_steps 64"
        flags="$flags --batch_size 8192 --n_epochs 4 --seed 17" ;;
    *) echo "unknown recipe $recipe (v2, hv2 or v3)" >&2; exit 2 ;;
esac
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

train="python -m gym_puzzles_tpu_torch.train.cli $flags --disable_wandb --save_model"
timed leg1 sh -c "$train --total_timesteps $leg1 --checkpoint_dir $out/models/leg1 \
    > $out/leg1.jsonl"
final=$out/models/leg1/$env last=leg1
if [ -n "$leg2" ]; then
    # leg 2 resumes leg 1's whole TrainState at leg 2's hyperparameters, the
    # goal schedule restarting over this leg's updates; --total_timesteps
    # counts the steps of this leg, as in the JAX package's CLI
    timed leg2 sh -c "$train --ent_coef 0.002 --total_timesteps $leg2 --resume $final \
        --checkpoint_dir $out/models/leg2 > $out/leg2.jsonl"
    final=$out/models/leg2/$env last=leg2
fi
for seed in 0 1 2; do
    timed "eval_seed$seed" sh -c "python -m gym_puzzles_tpu_torch.train.evaluate \
        --checkpoint $final --env $env --batched --n_episodes 128 --seed $seed \
        > $out/eval_seed$seed.json"
done
python -m gym_puzzles_tpu_torch.train.export --checkpoint "$final" --out "$out/policy.npz"
tail -n 2 "$out/$last.jsonl"
cat "$out/times.txt"
