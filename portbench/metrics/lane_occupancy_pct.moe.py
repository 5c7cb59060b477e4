"""``lane_occupancy_pct``, read in the MoE cell (``metrics/lane_occupancy_pct.py``): its seeds
spread its work far more than the dense cell's, so its rate has a wider
bound of its own, and what moves that rate reports under this name."""

from harness.cli import reader


def read(run):
    return reader("lane_occupancy_pct")(run)
