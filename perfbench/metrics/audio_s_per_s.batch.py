"""Audio of every directory pass of the window over the window's time on
the host's clock: the rate a batch user waits on, paced by the host."""


def read(trace, facts):
    return facts.get("audio_s_per_s")
