"""Tokens the served model emitted per second of audio over the window's finished requests: the decode's work, one
prediction step and one more joint evaluation a token. A gauge of comparability: where it moves, the decode's share of a
request moves with it, whatever the kernels' speed."""


def read(record: dict):
    if record.get("kind") != "serve":
        return None
    v = record.get("tokens_per_audio_s")
    return None if v is None else float(v)
