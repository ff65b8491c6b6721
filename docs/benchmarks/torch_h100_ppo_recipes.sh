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
#   hv0c  Heavy-v0 from a fresh init by the JAX package's whole curriculum, five
#         legs, each evaluated and exported into its own OUT_DIR/<leg>:
#         curB (ppo_hv0_curB_600M_r4.jsonl: 16384 envs x 64 steps, batch 16384,
#         4 epochs, lr 6.3e-4, gamma 0.997, lambda 0.98, clip 0.2, ent_coef
#         0.003, the hv0h2 reward weights, seed 11; 600M steps, 599,785,472),
#         then x2, x3 and x4 (ppo_hv0_X{2_sharpen,3_speed,4_default}_r4.jsonl),
#         each resuming the whole TrainState of the leg before it for 300M steps:
#         x2 at ent_coef 0.0005, seed 21; x3 as x2 with agentDistance 0.02 and
#         blockDistance 0.05, seed 31; x4 at the default reward weights, lr 1e-4,
#         gamma 0.999, lambda 0.95, clip 0.1, ent_coef 2e-4, seed 41
#         (1,499,463,680); then h2, hv0h2's leg warm-started from x4's exported
#         policy instead of the JAX one (1,799,356,416)
# SEED, if given, replaces the recipe's seed and nothing else: one seed for
# every leg, or one per leg (hv0c: "111 121 131 141 100").  (v0's two legs:
# torch_h100_ppo_v0.sh.)  OUT_DIR gets card.txt (the card's name and power
# limit), leg1.jsonl [/ leg2.jsonl ...] (the trainer's stdout: its config
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
shaped="agentDelta=5,agentDistance=0,blockDelta=2000,blockDistance=0"
hv0="--env MultiRobotPuzzleHeavy-v0 --n_envs 16384 --n_steps 32 --batch_size 32768"
hv0="$hv0 --n_epochs 4 --learning_rate 0.00025 --gamma 0.997 --clip_range 0.1 --ent_coef 0.001"
hv0="$hv0 --set_reward_params $shaped"
hv0="$hv0 --max_episode_steps 1100"
jax_x4="--resume_policy gym_puzzles_tpu_torch/policies/MultiRobotPuzzleHeavy-v0_best_r4.npz"
hv0x="--env MultiRobotPuzzleHeavy-v0 --n_envs 16384 --n_steps 64 --batch_size 16384 --n_epochs 4"
hv0x_shaped="$hv0x --learning_rate 0.00063 --gamma 0.997 --gae_lambda 0.98 --clip_range 0.2"
# A recipe is a chain of legs 1 .. $legs.  Leg K trains steps_K steps with the
# recipe's flags, then flags_K, at the K-th of $seeds (the last if there are
# fewer), into dir_K (default OUT_DIR).  It starts from a fresh init, or, with
# from_K=resume, from leg K-1's whole TrainState, or, with from_K=policy, from
# leg K-1's exported policy.  The last leg, and a leg whose directory the
# next leg does not share, is evaluated there.
pixels= drop_models= legs=2 from_2=resume
case $recipe in
    v2) env=MultiRobotPuzzle-v2 flags=$v2 seeds=3 steps_1=30000000 steps_2=65000000
        flags_2="--ent_coef 0.002" ;;
    hv2) env=MultiRobotPuzzleHeavy-v2 flags="$v2 --env $env" seeds=3
         steps_1=30000000 steps_2=65000000 flags_2="--ent_coef 0.002" ;;
    v3) env=MultiRobotPuzzle-v3 seeds=17 legs=1 steps_1=120000000
        flags="--config train_configs/ppo-mrp-v3.json --n_envs 4096 --n_steps 64"
        flags="$flags --batch_size 8192 --n_epochs 4" ;;
    cnn4) env=MultiRobotPuzzle-v0 flags=$cnn seeds=17 legs=1 steps_1=10000000 pixels=1 ;;
    cnn5a) env=MultiRobotPuzzle-v0 seeds=17 legs=1 steps_1=41992192 pixels=1
           flags="$cnn --velocity_iters 60 --position_iters 20" ;;
    hv0h2) env=MultiRobotPuzzleHeavy-v0 flags="$hv0 $jax_x4" seeds=0 legs=1 steps_1=300000000
           drop_models=1 ;;
    hv0h3) env=MultiRobotPuzzleHeavy-v0 flags="$hv0 $jax_x4" seeds=0 steps_1=300000000
           steps_2=600000000 flags_2="--max_episode_steps 1000" drop_models=1 dir_1=$out/h2 ;;
    hv0c) env=MultiRobotPuzzleHeavy-v0 flags= seeds="11 21 31 41 0" legs=5 drop_models=1
          steps_1=600000000 dir_1=$out/curB
          flags_1="$hv0x_shaped --ent_coef 0.003 --set_reward_params $shaped"
          steps_2=300000000 dir_2=$out/x2
          flags_2="$hv0x_shaped --ent_coef 0.0005 --set_reward_params $shaped"
          steps_3=300000000 dir_3=$out/x3 from_3=resume
          flags_3="$hv0x_shaped --ent_coef 0.0005"
          flags_3="$flags_3 --set_reward_params agentDelta=5,agentDistance=0.02,blockDelta=2000,blockDistance=0.05"
          steps_4=300000000 dir_4=$out/x4 from_4=resume
          flags_4="$hv0x --learning_rate 0.0001 --gamma 0.999 --gae_lambda 0.95 --clip_range 0.1"
          flags_4="$flags_4 --ent_coef 0.0002"
          steps_5=300000000 dir_5=$out/h2 from_5=policy flags_5=$hv0 ;;
    *) echo "unknown recipe $recipe (v2, hv2, v3, cnn4, cnn5a, hv0h2, hv0h3 or hv0c)" >&2
       exit 2 ;;
esac
seeds=${3:-$seeds}
policy=${pixels:+--policy cnn}

leg_var() {  # leg_var NAME K [DEFAULT]: the value of NAME_K, or DEFAULT
    eval "echo \"\${$1_$2:-${3:-}}\""
}

nth() {  # nth K WORD...: the K-th word, or the last if there are fewer
    i=$1
    shift
    while [ "$i" -gt 1 ] && [ $# -gt 1 ]; do
        shift
        i=$((i - 1))
    done
    echo "$1"
}

dirs=$(n=1; while [ $n -le $legs ]; do leg_var dir $n "$out"; n=$((n + 1)); done)
# shellcheck disable=SC2086
mkdir -p "$out" $dirs
if [ -n "$pixels$drop_models" ]; then
    trap 'rm -rf "$out/models"' EXIT  # also when a step fails
fi
card=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
for dir in "$out" $dirs; do
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

# a resumed leg takes the leg before it's whole TrainState at its own
# hyperparameters and reward weights, a curriculum (the goal schedule)
# restarting over its updates; --total_timesteps counts the steps of this leg,
# as in the JAX package's CLI
n=1 final= start=
while [ $n -le $legs ]; do
    dir=$(leg_var dir $n "$out")
    train="python -m gym_puzzles_tpu_torch.train.cli $flags --seed $(nth $n $seeds)"
    train="$train --disable_wandb --save_model"
    timed "$dir" "leg$n" sh -c "$train $(leg_var flags $n) --total_timesteps $(leg_var steps $n) \
        $start --checkpoint_dir $out/models/leg$n > $dir/leg$n.jsonl"
    final=$out/models/leg$n/$env last=$dir/leg$n.jsonl
    if [ $n -eq $legs ] || [ "$(leg_var dir $((n + 1)) "$out")" != "$dir" ]; then
        evaluate "$dir" "$final"
    fi
    case $(leg_var from $((n + 1))) in
        resume) start="--resume $final" ;;
        policy) start="--resume_policy $dir/policy.npz" ;;
    esac
    n=$((n + 1))
done
tail -n 2 "$last"
cat "$dir/times.txt"
