"""Tokens whose gradients reached an update, over the window's whole
steps, per second from the first step's start to the last step's end."""


def read(w):
    return w.tokens / w.seconds if w.tokens > 0 else None
