"""Share of the traced ``pipeline.segment`` spans (``FusedFramePipeline.step``:
a frame's preprocessing and forward) that hold a ``pipeline.segment.replay``
span, the forward replayed from its CUDA graph, in %.  A program whose
``segment`` launches its forward op by op reads 0."""
from benchmark.core.program_spans import span_intervals


def read(run):
    segments = span_intervals(run, ["pipeline.segment"])
    if not segments:
        return None
    starts = [a for a, _ in span_intervals(run, ["pipeline.segment.replay"])]
    held = sum(any(a <= s <= b for s in starts) for a, b in segments)
    return 100.0 * held / len(segments)
