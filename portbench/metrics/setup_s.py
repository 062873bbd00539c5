"""setup_s (s): from process start to the window's start: weights, MoPE's
training, the engine, kernel loading and the traffic ramp."""


def read(rec):
    return rec.setup_s
