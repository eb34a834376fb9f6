"""100 x the tokens the rows generated over decode steps x rows (a row
past its EOS still runs every step), over every batch the run
generated."""

from port_bench.yardstick.spans import counter_share


def read(rec):
    return counter_share("decode.row_steps_live", "decode.row_steps")
