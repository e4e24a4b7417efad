"""Idle card time inside the Trainer loop's ``train.fetch`` and
``train.drain`` spans (taking the next batch; reading the previous step's
loss and confusion, the meters and the log line), over the traced training
steps, in %."""
from benchmark.core.program_spans import idle_inside_pct


def read(run):
    return idle_inside_pct(run, ["train.fetch", "train.drain"])
