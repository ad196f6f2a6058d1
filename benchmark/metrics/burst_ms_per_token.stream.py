"""Wall ms of the EMMA write burst a token written: the sum over the
window's steps of the pool's ``last_timings["burst"]`` (each ended by a
synchronisation of the card) over the tokens the steps wrote."""


def read(rec):
    steps = rec["data"]["steps"]
    tokens = sum(s["tokens"] for s in steps)
    if not tokens:
        return None
    return 1e3 * sum(s["timings"].get("burst", 0.0) for s in steps) / tokens
