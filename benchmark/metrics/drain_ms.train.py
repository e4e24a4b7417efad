"""Mean host milliseconds of the Trainer loop's ``train.drain`` spans in the
traced training steps: how long the host waits on the card for the previous
step's loss and confusion, with the meters and the log line."""
from benchmark.core.program_spans import span_mean_ms


def read(run):
    return span_mean_ms(run, "train.drain")
