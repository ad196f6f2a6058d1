"""Wall ms of the speech-input stage a second of audio: the sum over the
window's ``predict`` calls of ``Translator.last_timings["encoder"]`` (the
host fbank and its normalisation, then the speech encoder and adaptor; no
span splits them yet) over the seconds of audio the calls encoded."""


def read(rec):
    calls = rec["data"]["calls"]
    audio = sum(sum(c["audio_s"]) for c in calls)
    if not audio:
        return None
    return 1e3 * sum(c["timings"].get("encoder", 0.0) for c in calls) / audio
