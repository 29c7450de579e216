"""95th percentile of the latency of every query of the window, nearest
rank: a query's latency is its search call's wall time, from the call
until ids and scores are on the host (host clock)."""
import numpy as np

from ..stats import exact_quantile


def read(run):
    lat = np.repeat([s["latency_s"] for s in run.searches],
                    [s["queries"] for s in run.searches])
    return exact_quantile(lat, 0.95) * 1e3
