#!/bin/sh
# PPO with the PyTorch package on one GPU by one of the JAX package's
# recipes (the config headers of its run records named below), then the eval
# CLI on the result at seeds 0, 1 and 2 (128 deterministic episodes each, at
# the registered 180/60), then, for a flat recipe, the final policy exported.
# Run from the repo root:
#
#     sh docs/benchmarks/torch_h100_ppo_recipes.sh RECIPE OUT_DIR [SEED]
#
# RECIPE is one of
#   v2    MultiRobotPuzzle-v2, ppo_v2_leg{1,2}_r4.jsonl: train_configs/ppo-mrp-v2.json
#         at 4096 envs, seed 3, update_goal; 30M steps, then resumed at ent_coef
#         0.002 for 65M more (94,633,984 in all)
#   hv2   MultiRobotPuzzleHeavy-v2, ppo_hv2_leg{1,2}_r4.jsonl: the v2 recipe
#   v3    MultiRobotPuzzle-v3, ppo_v3_retrain_r4.jsonl: train_configs/ppo-mrp-v3.json
#         at 4096 envs x 64 steps, batch 8192, 4 epochs, seed 17; one leg of 120M
#         steps (119,799,808)
#   cnn4  MultiRobotPuzzle-v0 from rendered frames, ppo_v0_cnn_r4.jsonl: the CNN
#         policy at 256 envs x 32 steps, batch 2048, 2 epochs, lr 2.5e-4, ent_coef
#         0.005, seed 17, the registered 180/60; one leg of 10M steps (9,994,240)
#   cnn5a the first 41,992,192 steps (5,126 updates) of ppo_v0_cnn_r5_leg1.jsonl:
#         cnn4 at 60/20 solver iterations; the recipe has no schedule, so this is
#         exactly the start of that 70M-step leg
# SEED, if given, replaces the recipe's seed and nothing else.  (v0's two
# legs: torch_h100_ppo_v0.sh.)  OUT_DIR gets card.txt (the card's name and
# power limit), leg1.jsonl [/ leg2.jsonl] (the trainer's stdout: its config
# line, then one JSON line per update), eval_seed{0,1,2}.json (the eval CLI's
# row) and times.txt (wall seconds of each command); a flat recipe also
# policy.npz (the final checkpoint through train/export.py) and its
# checkpoints under models/.  A CNN recipe deletes its checkpoints after the
# evals and exports nothing: its 21.6M-param policy is ~86 MB, ~259 MB with
# Adam's moments.
set -eu
usage="usage: torch_h100_ppo_recipes.sh RECIPE OUT_DIR [SEED]"
recipe=${1:?$usage}
out=${2:?$usage}
v2="--config train_configs/ppo-mrp-v2.json --n_envs 4096 --update_goal"
cnn="--policy cnn --n_envs 256 --n_steps 32 --batch_size 2048 --n_epochs 2"
cnn="$cnn --learning_rate 0.00025 --ent_coef 0.005"
pixels=
case $recipe in
    v2) env=MultiRobotPuzzle-v2 flags=$v2 seed=3 leg1=30000000 leg2=65000000 ;;
    hv2) env=MultiRobotPuzzleHeavy-v2 flags="$v2 --env $env" seed=3
         leg1=30000000 leg2=65000000 ;;
    v3) env=MultiRobotPuzzle-v3 seed=17 leg1=120000000 leg2=
        flags="--config train_configs/ppo-mrp-v3.json --n_envs 4096 --n_steps 64"
        flags="$flags --batch_size 8192 --n_epochs 4" ;;
    cnn4) env=MultiRobotPuzzle-v0 flags=$cnn seed=17 leg1=10000000 leg2= pixels=1 ;;
    cnn5a) env=MultiRobotPuzzle-v0 seed=17 leg1=41992192 leg2= pixels=1
           flags="$cnn --velocity_iters 60 --position_iters 20" ;;
    *) echo "unknown recipe $recipe (v2, hv2, v3, cnn4 or cnn5a)" >&2; exit 2 ;;
esac
seed=${3:-$seed}
mkdir -p "$out"
if [ -n "$pixels" ]; then
    trap 'rm -rf "$out/models"' EXIT  # also when a step fails
fi
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

train="python -m gym_puzzles_tpu_torch.train.cli $flags --seed $seed --disable_wandb --save_model"
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
# the eval env runs at the registered 180/60 whatever the recipe trained at
policy=${pixels:+--policy cnn}
for k in 0 1 2; do
    timed "eval_seed$k" sh -c "python -m gym_puzzles_tpu_torch.train.evaluate \
        --checkpoint $final --env $env $policy --batched --n_episodes 128 --seed $k \
        > $out/eval_seed$k.json"
done
if [ -z "$pixels" ]; then
    python -m gym_puzzles_tpu_torch.train.export --checkpoint "$final" --out "$out/policy.npz"
fi
tail -n 2 "$out/$last.jsonl"
cat "$out/times.txt"
