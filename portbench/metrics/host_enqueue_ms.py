"""host_enqueue_ms (engine): mean host ms from a frame's start until
``Renderer.render`` returns, before the wait, over the untraced window."""


def read(r):
    return sum(r.enqueue_ms) / len(r.enqueue_ms)
