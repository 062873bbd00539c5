"""service_jain (index): Jain's index (sum x)^2 / (n sum x^2) over the
cell's clients of the service each received in the window, x = prompt
tokens prefilled (each once) + 4 x output tokens (VTC's measure, Sheng et
al., OSDI'24; the weight of section 3.1 of the paper)."""
from portbench.metrics._window import window_stamps
from portbench.traffic.generator import OUT_TOKEN_WEIGHT


def read(rec):
    x = {c: 0.0 for c in rec.clients}
    for t, client, n in rec.credits:
        if rec.in_window(t):
            x[client] += n
    for lg, _ in window_stamps(rec):
        x[lg.client] += OUT_TOKEN_WEIGHT
    v = list(x.values())
    if not any(v):
        return None
    return sum(v) ** 2 / (len(v) * sum(a * a for a in v))
