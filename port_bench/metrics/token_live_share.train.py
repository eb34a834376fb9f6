"""100 x the spliced positions that are not padding over every spliced
position of the collated batches, over every batch the run collated."""

from port_bench.yardstick.spans import counter_share


def read(rec):
    return counter_share("collate.positions_live", "collate.positions")
