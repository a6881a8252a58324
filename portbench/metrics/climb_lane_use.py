"""climb_lane_use: the share of the climb's lane steps that real lanes
needed, %: the window's `climb.lane_steps_used` (each real bubble's own
iterations) over its `climb.lane_steps` (every batch's lanes, pad lanes
included, times the steps the batch ran).  None without a climb."""

import jobrecords


def read(run):
    steps = jobrecords.counter_sum(run, "climb.lane_steps")
    if not steps:
        return None
    return 100.0 * jobrecords.counter_sum(
        run, "climb.lane_steps_used") / steps
