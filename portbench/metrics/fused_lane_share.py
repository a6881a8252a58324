"""fused_lane_share: the share of the climb's lane steps that K4
scored, %: the window's `climb.fused_lane_steps` (the lanes times the
steps of the device-resident climb batches on K4's route) over its
`climb.lane_steps`.  None where the job records keep no such counter
(a program without it, or no device-resident climb) or no lane step."""

import jobrecords


def read(run):
    recs = jobrecords.records(run)
    if recs is None or not any("climb.fused_lane_steps" in r["counters"]
                               for r in recs):
        return None
    steps = jobrecords.counter_sum(run, "climb.lane_steps")
    if not steps:
        return None
    return 100.0 * jobrecords.counter_sum(
        run, "climb.fused_lane_steps") / steps
