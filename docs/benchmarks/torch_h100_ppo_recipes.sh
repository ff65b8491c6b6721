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
#   hv0h2 MultiRobotPuzzleHeavy-v0, ppo_hv0_H2_r5.jsonl: 16384 envs x 32 steps,
#         batch 32768, 4 epochs, lr 2.5e-4, gamma 0.997, clip 0.1, ent_coef 0.001,
#         reward weights agentDelta 5 / agentDistance 0 / blockDelta 2000 /
#         blockDistance 0, a 1100-step training horizon, seed 0; warm-started
#         from the JAX package's X4 policy (MultiRobotPuzzleHeavy-v0_best_r4.npz,
#         1,499,463,680 steps) for one leg of 300M steps (299,892,736)
#   hv0h3 hv0h2 into OUT_DIR/h2 (evaluated and exported there), then
#         ppo_hv0_H3_r5.jsonl: its whole TrainState resumed at a 1000-step
#         horizon for 600M more steps (599,785,472; 2,399,141,888 in all)
# SEED, if given, replaces the recipe's seed and nothing else.  (v0's two
# legs: torch_h100_ppo_v0.sh.)  OUT_DIR gets card.txt (the card's name and
# power limit), leg1.jsonl [/ leg2.jsonl] (the trainer's stdout: its config
# line, then one JSON line per update), eval_seed{0,1,2}.json (the eval CLI's
# row) and times.txt (wall seconds of each command); a flat recipe also
# policy.npz (the final checkpoint through train/export.py) and its
# checkpoints under models/.  A CNN recipe deletes its checkpoints after the
# evals and exports nothing: its 21.6M-param policy is ~86 MB, ~259 MB with
# Adam's moments.  A Heavy-v0 recipe deletes its checkpoints too: a TrainState
# of 16384 envs is ~4x that of 4096.
set -eu
usage="usage: torch_h100_ppo_recipes.sh RECIPE OUT_DIR [SEED]"
recipe=${1:?$usage}
out=${2:?$usage}
v2="--config train_configs/ppo-mrp-v2.json --n_envs 4096 --update_goal"
cnn="--policy cnn --n_envs 256 --n_steps 32 --batch_size 2048 --n_epochs 2"
cnn="$cnn --learning_rate 0.00025 --ent_coef 0.005"
hv0="--env MultiRobotPuzzleHeavy-v0 --n_envs 16384 --n_steps 32 --batch_size 32768"
hv0="$hv0 --n_epochs 4 --learning_rate 0.00025 --gamma 0.997 --clip_range 0.1 --ent_coef 0.001"
hv0="$hv0 --set_reward_params agentDelta=5,agentDistance=0,blockDelta=2000,blockDistance=0"
hv0="$hv0 --max_episode_steps 1100"
hv0="$hv0 --resume_policy gym_puzzles_tpu_torch/policies/MultiRobotPuzzleHeavy-v0_best_r4.npz"
pixels= drop_models= leg1_out=$out
case $recipe in
    v2) env=MultiRobotPuzzle-v2 flags=$v2 seed=3 leg1=30000000 leg2=65000000
        leg2_flags="--ent_coef 0.002" ;;
    hv2) env=MultiRobotPuzzleHeavy-v2 flags="$v2 --env $env" seed=3
         leg1=30000000 leg2=65000000 leg2_flags="--ent_coef 0.002" ;;
    v3) env=MultiRobotPuzzle-v3 seed=17 leg1=120000000 leg2=
        flags="--config train_configs/ppo-mrp-v3.json --n_envs 4096 --n_steps 64"
        flags="$flags --batch_size 8192 --n_epochs 4" ;;
    cnn4) env=MultiRobotPuzzle-v0 flags=$cnn seed=17 leg1=10000000 leg2= pixels=1 ;;
    cnn5a) env=MultiRobotPuzzle-v0 seed=17 leg1=41992192 leg2= pixels=1
           flags="$cnn --velocity_iters 60 --position_iters 20" ;;
    hv0h2) env=MultiRobotPuzzleHeavy-v0 flags=$hv0 seed=0 leg1=300000000 leg2= drop_models=1 ;;
    hv0h3) env=MultiRobotPuzzleHeavy-v0 flags=$hv0 seed=0 leg1=300000000 leg2=600000000
           leg2_flags="--max_episode_steps 1000" drop_models=1 leg1_out=$out/h2 ;;
    *) echo "unknown recipe $recipe (v2, hv2, v3, cnn4, cnn5a, hv0h2 or hv0h3)" >&2; exit 2 ;;
esac
seed=${3:-$seed}
policy=${pixels:+--policy cnn}
mkdir -p "$out" "$leg1_out"
if [ -n "$pixels$drop_models" ]; then
    trap 'rm -rf "$out/models"' EXIT  # also when a step fails
fi
card=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
for dir in "$out" "$leg1_out"; do
    echo "$card" > "$dir/card.txt"
    : > "$dir/times.txt"
done
echo "$card"

timed() {  # timed DIR NAME COMMAND...: run COMMAND, append its wall seconds to DIR/times.txt
    dir=$1 name=$2
    shift 2
    t0=$(date +%s.%N)
    "$@"
    echo "$name $(python3 -c "import sys, time; print(time.time() - float(sys.argv[1]))" "$t0")" \
        | tee -a "$dir/times.txt"
}

evaluate() {  # evaluate DIR CHECKPOINT: the eval CLI at seeds 0-2 into DIR, a flat policy exported
    # the eval env runs at the registered 180/60 and episode limit whatever
    # the recipe trained at
    for k in 0 1 2; do
        timed "$1" "eval_seed$k" sh -c "python -m gym_puzzles_tpu_torch.train.evaluate \
            --checkpoint $2 --env $env $policy --batched --n_episodes 128 --seed $k \
            > $1/eval_seed$k.json"
    done
    if [ -z "$pixels" ]; then
        python -m gym_puzzles_tpu_torch.train.export --checkpoint "$2" --out "$1/policy.npz"
    fi
}

train="python -m gym_puzzles_tpu_torch.train.cli $flags --seed $seed --disable_wandb --save_model"
timed "$leg1_out" leg1 sh -c "$train --total_timesteps $leg1 --checkpoint_dir $out/models/leg1 \
    > $leg1_out/leg1.jsonl"
final=$out/models/leg1/$env last=$leg1_out/leg1.jsonl
if [ -n "$leg2" ]; then
    if [ "$leg1_out" != "$out" ]; then
        evaluate "$leg1_out" "$final"
    fi
    # leg 2 resumes leg 1's whole TrainState at leg 2's hyperparameters, the
    # goal schedule restarting over this leg's updates; --total_timesteps
    # counts the steps of this leg, as in the JAX package's CLI
    timed "$out" leg2 sh -c "$train $leg2_flags --total_timesteps $leg2 --resume $final \
        --checkpoint_dir $out/models/leg2 > $out/leg2.jsonl"
    final=$out/models/leg2/$env last=$out/leg2.jsonl
fi
evaluate "$out" "$final"
tail -n 2 "$last"
cat "$out/times.txt"
