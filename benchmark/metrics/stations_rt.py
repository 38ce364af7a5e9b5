"""stations_rt: channel-blocks completed in the window times the 0.064 s
of air in a block, over the window's seconds: stations decoded in real
time, all the work over all the time.  Host clock."""

from benchmark.harness.core import AIR_SECONDS_PER_BLOCK


def read(run, ctx):
    return run.blocks_done * run.channels * AIR_SECONDS_PER_BLOCK / run.window_s
