"""The share of the window the batcher's one dispatch thread spent inside
engine calls (batch windows and stream chunks): the change in
`BatcherStats.synth_wall_s` over the window's seconds, in %."""


def read(run):
    if "synth_wall_s" not in run.counters:
        return None
    return 100.0 * run.counters["synth_wall_s"] / run.window_s
