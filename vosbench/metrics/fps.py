"""fps: every frame completed in the window over the window's seconds
(host clock; first-of-video, plain, memory and consolidation frames alike)."""


def read(run):
    return len(run.frame_ms) / run.window_s
