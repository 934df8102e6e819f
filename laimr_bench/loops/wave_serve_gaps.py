"""``wave_serve`` with the served tokens' logit gaps checked per request
and at their 90th percentile, in place of the widest gap, for a model
whose widest gap cannot tell bf16 from fp8.

In a deep stack of sparse experts with random weights, the float32
reference routes on its own scores: a near tie that bf16 rounding
breaks the other way sends a token to another expert, and the change
spreads through the later layers and, by the recurrent state and
attention, to the later tokens, so a few served tokens of every run
land far below the reference's best in bf16 as in fp8
(NVIDIA-Nemotron-3-Nano: the widest gap 3.66–5.40 over 22 seeds in
bf16, 4.90–6.37 under the fp8 control; a token drawn at random reads
about 4.8). The gaps are (requests, tokens), the cell's sample:

* ``logit_gap_request_median``: the largest of the requests' median
  gaps, against ``check.logit_gap_request_median_limit``. A request
  served wrongly in more than half its tokens (a slot, a wave, a
  partial wave's merge) reads about 4.8;
* ``logit_gap_p90``: the 90th percentile of all the sample's gaps,
  against ``check.logit_gap_p90_limit``. A fault in a tenth or more of
  the tokens (the late positions of every ring, one layer kind) lifts it
  to about 4.8.

The cell's ``check.readings`` gives the readings the limits lie between.
Everything else is ``wave_serve``'s: the loop, the end-to-end metrics
and the routing check.
"""
from __future__ import annotations

import numpy as np
import torch

from laimr_bench.loops import wave_serve


def gap_checks(gaps: np.ndarray, check: dict) -> dict:
    """The two checks of the gaps (requests, tokens)."""
    return {
        "logit_gap_request_median": {
            "value": float(np.median(gaps, axis=1).max()),
            "limit": check["logit_gap_request_median_limit"]},
        "logit_gap_p90": {"value": float(np.quantile(gaps, 0.9)),
                          "limit": check["logit_gap_p90_limit"]}}


def run_cell(run) -> None:
    st = wave_serve.Served(run)
    run.state = st
    st.window()
    if run.device.type == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated(run.device))
    st.release()
    wave_serve.summarize(run, st)
    run.checks.update(wave_serve.check_routing(run, st))
    gaps, _ = wave_serve.logit_gaps(run, st)
    run.checks.update(gap_checks(gaps, run.cell["check"]))
