"""Percent of the window's PTT updates whose leader ran none of its TAO's
chunks (the other members claimed them all first), so the time it recorded
is a wait and not a run."""
UNIT, MOVES, SOURCE, LAYER = "%", "taos_per_s", "program_counter", "runtime"


def read(obs):
    recs = obs.get("ptt_records")
    if not recs:
        return None
    return 100.0 * sum(1 for r in recs if r.leader_chunks == 0) / len(recs)
