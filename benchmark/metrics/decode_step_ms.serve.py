"""Wall ms of one beam-search step: the sum over the window's ``predict``
calls of ``Translator.last_timings["text_decode"]`` (each ended by a
synchronisation of the card) over the sum of their decode steps
(``generator.last_result.steps``)."""


def read(rec):
    calls = rec["data"]["calls"]
    steps = sum(c["steps"] for c in calls)
    if not steps:
        return None
    return 1e3 * sum(c["timings"].get("text_decode", 0.0) for c in calls) / steps
