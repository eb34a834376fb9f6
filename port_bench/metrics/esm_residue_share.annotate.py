"""100 x the ESM2 rows that hold a residue (or its two end tokens) over the
rows of the padded buckets, over every batch the run prepared."""

from port_bench.yardstick.spans import counter_share


def read(rec):
    return counter_share("esm.rows_residue", "esm.rows")
