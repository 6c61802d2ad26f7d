"""TAOs committed inside the measured window over the window's seconds, a DAG
still running at its close counting the TAOs it had committed (host clock;
the paper's throughput)."""
UNIT, MOVES, SOURCE, LAYER = "TAOs/s", None, "host_clock", None


def read(obs):
    return obs.get("taos_per_s")
