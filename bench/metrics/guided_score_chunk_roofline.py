"""K1's share of its roofline: the least time on the card for the work
of the traced window's dispatched chunks (``bench.roofline``: each live
posting of a query's own terms over the tiles its row visited read once,
the planner's values of those (tile, term) pairs read once, five output
rows per slot of a visited tile written once; counted in int64 from the
index made again from the seed and each row's schedule, pad slots left
out), over the device time of the chunk scorer's kernel in the trace
(operations whose name holds ``guided_score``; the chunked_fused path
launches no other)."""
from ..peaks import peaks
from ..roofline import k1_work, least_time_s


def read(run):
    peak = peaks(run.device_name)
    if run.trace is None or run.k1 is None or peak is None:
        return None
    k1_s = sum(v for k, v in run.trace["device_ops"].items()
               if "guided_score" in k)
    if k1_s <= 0 or run.k1["tiles"] <= 0:
        return None
    work = k1_work(postings=run.k1["postings"],
                   tile_terms=run.k1["tile_terms"], tiles=run.k1["tiles"],
                   tile_size=run.cfg["index"]["tile_size"])
    t, _ = least_time_s(work, peak)
    return 100.0 * t / k1_s
