"""Share of the window the pipeline's loop waited for decoded frames
(``process_stream``'s ``decode:wait`` span), in %."""

def read(run):
    t = run.spans.total.get("decode:wait")
    return None if t is None or not run.window_s else 100.0 * t / run.window_s
