"""loop.process_ms: host milliseconds of loop closing per keyframe: the
synced spans `loop.process` (BoW, detection, the Sim3 chain, the
correction and the essential graph) and `loop.poll_gba` (the global BA's
iterations and its apply), summed over the traced window, over the calls
of `loop.process` (one per keyframe)."""


def read(run):
    calls = run.spans.ms.get("loop.process")
    if not calls:
        return None
    return (sum(calls) + sum(run.spans.ms.get("loop.poll_gba", []))) / len(calls)
