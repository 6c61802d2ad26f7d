"""Process start to the first timed operation: imports, the card's context,
the kernels' build (the first run in a checkout) or load, inputs and weights
drawn on the card, and the warm-up (host clock).  The result line's
``setup`` gives its parts, and whether this run built the kernels."""
UNIT, MOVES, SOURCE, LAYER = "s", None, "host_clock", None


def read(obs):
    return obs.get("setup_s")
