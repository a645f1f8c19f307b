"""``ssd_roofline.prefill``: the SSD chunk kernels' share of their
roofline in the traced stretch's prefills: a call is three kernels
(``ssd_chunk_state``, ``_pass``, ``_scan``), its least time
``portbench.work.ssd_work`` at one Mamba-2 layer's shapes (f32 operands;
the FLOPs at the 495 TFLOP/s of TF32, the highest rate any f32-input
product reaches, the bytes at 3.35 TB/s); summed over the calls, over
the three kernels' device time.  Unit %."""
from portbench import work


def read(run):
    t = run.trace
    calls, _ = t.matching("ssd_chunk_state") if t else (0, 0.0)
    if not calls:
        return None
    _, seconds = t.matching("ssd_chunk")
    s = run.sizes
    heads = int(s["expand"]) * int(s["d_model"]) // int(s["ssm_head_dim"])
    flops, nbytes = work.ssd_work(run.p["sessions"], heads, run.p["prompt"],
                                  int(s["ssm_head_dim"]), int(s["state"]),
                                  int(s["ssd_chunk"]), 4)
    return 100.0 * calls * work.bound_s(flops, nbytes,
                                        work.TF32_FLOPS_PER_S) / seconds
