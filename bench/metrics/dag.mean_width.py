"""The mean width of the places that molding gave the window's TAOs: every
PTT update of the window (the program's ``workers.ChunkLog.watch``)."""
UNIT, MOVES, SOURCE, LAYER = "width", "taos_per_s", "program_counter", \
    "scheduler"


def read(obs):
    recs = obs.get("ptt_records")
    if not recs:
        return None
    return sum(r.width for r in recs) / len(recs)
