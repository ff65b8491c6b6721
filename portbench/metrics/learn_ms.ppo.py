"""learn_ms.ppo: wall ms per update in the learner (its graph replay:
bootstrap value, GAE, minibatch epochs, Adam, the KL mask), from
``PhaseTimer``'s ``update`` seconds over the traced run's timed updates."""

from portbench import yardstick


def read(ctx):
    return yardstick.phase_ms(ctx, "update")
