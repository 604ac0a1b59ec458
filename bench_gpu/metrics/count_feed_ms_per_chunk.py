"""Host time of one ``TransitionCounter.add_chunk`` call (staging, the
uploads and the launch), the mean over the traced window's calls, from the
benchmark's own span around each call, in ms."""


def read(run):
    spans = run.spans.get("add_chunk")
    if run.trace is None or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
