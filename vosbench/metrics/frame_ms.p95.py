"""frame_ms.p95: the 95th percentile of the per-frame times of every frame
in the window (host clock, ms; a frame is timed from the host frame handed
to InferenceCore.step to the host mask from output_prob_to_mask)."""
import statistics


def read(run):
    if len(run.frame_ms) < 2:
        return None
    return statistics.quantiles(run.frame_ms, n=100, method="inclusive")[94]
