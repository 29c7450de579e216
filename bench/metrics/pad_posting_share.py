"""Share of the postings K1 reads in the traced window that belong to pad
slots: the facade pads a batch's shorter queries with term 0 at weight 0
up to its longest, and K1 reads those slots' runs over every tile a row
visits, though they add nothing to a score. Counted beside the roofline's
live postings (``bench.roofline.k1_counts``), in int64 from the index made
again from the seed and each row's schedule."""


def read(run):
    if run.k1 is None:
        return None
    total = run.k1["postings"] + run.k1["pad_postings"]
    if total <= 0:
        return None
    return 100.0 * run.k1["pad_postings"] / total
