"""ppo_mfu: the whole update's share of the card's peak, in %: the policy's
FLOPs per update (``yardstick.update_flops``: the rollout's forward passes,
the bootstrap, forward and backward over every minibatch of every epoch),
each at the peak of the precision it runs in, over the wall time per update
that ``PhaseTimer`` measured (rollout + learner)."""

from portbench import yardstick


def read(ctx):
    return yardstick.update_mfu(ctx)
